"""The host data layer: dataset catalogs and registration, mappers,
transforms, the tokenizer and the loader.

The port's own copy of ``locov_tpu/data``: framework-free host code
(numpy, PIL or cv2, C++ through ctypes); the loader emits batches of
numpy arrays in the port's containers, which
``structures.batches.to_torch`` moves to the device."""
from .catalog import DatasetCatalog, MetadataCatalog
from . import tokenization, transforms

__all__ = ["DatasetCatalog", "MetadataCatalog", "tokenization",
           "transforms"]


def get_register_dataset(dataset_name: str):
    """Dispatch by dataset-name prefix (reference
    ``register_datasets.py:10``)."""
    if dataset_name.startswith("lvis"):
        from .datasets import lvis
        return lvis.register_dataset
    from .datasets import coco
    return coco.register_dataset


def get_mapper(dataset_name: str, cfg, is_train: bool, tokenizer=None,
               mlm: bool = False, seed: int = 0):
    """Mapper selection by dataset name (reference
    ``mappers/__init__.py:11-35``). All reference mapper variants
    (Coco / Basic / Noise) collapse into one DetectionMapper here — its
    behavior toggles (captions, proposals-as-gt, noise injection) key
    off metadata and the INPUT.NOISE_* config, which is exactly how the
    reference differentiates them. The VAW variant is intentionally
    absent: its dataset file is missing in the reference too
    (dangling import, register_datasets.py:16)."""
    from .mappers import DetectionMapper
    metadata = MetadataCatalog.get(dataset_name)
    return DetectionMapper(cfg, metadata, is_train, tokenizer=tokenizer,
                           mlm=mlm, seed=seed)
