"""The evaluation side of the trainer, as module functions.

Counterpart of the eval half of ``locov_tpu/engine/trainer.py``:
``proposal_slots`` (:53), ``build_tokenizer`` (:68), the test loader
(``OVRTrainer.build_test_loader``, :180-210), the class-embedding
matrix of a dataset (``OVRTrainer.load_embeddings``, :212-228) and the
detection branch of ``OVRTrainer.test`` (:510-545). The trainer loop
that calls them comes later (ROADMAP queue 1, item 5). One device: the
eval batch is not rounded to a device count; the sampler shards by the
process's rank where ``torch.distributed`` runs.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data import DatasetCatalog, MetadataCatalog, get_register_dataset
from ..data.loader import DataLoader, InferenceSampler, derive_buckets
from ..data.mappers import DetectionMapper
from ..data.tokenization import WordPieceTokenizer, build_tiny_vocab
from ..evaluation.evaluator import (inference_on_detection_dataset,
                                    select_evaluator_type)
from ..parallel.mesh import make_eval_step, process_rank_world
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

LSM_ARCHS = {"DistillProposalMMSSRCNN", "DistillOnlyProposalMMSSRCNN",
             "MMSSGridModel", "DistillMMSSGridModel"}


def proposal_slots(cfg) -> int:
    """Static proposal-slot count for the RPN-less PrecomputedProposals
    path (reference ovr_rcnn.py:59-61); 0 keeps DetectionBatch.proposals
    empty on the RPN path."""
    if cfg.MODEL.PROPOSAL_GENERATOR.NAME != "PrecomputedProposals":
        return 0
    if not cfg.MODEL.LOAD_OBJ_PROPOSALS:
        raise ValueError(
            "MODEL.PROPOSAL_GENERATOR.NAME='PrecomputedProposals' "
            "requires MODEL.LOAD_OBJ_PROPOSALS=True so the data "
            "pipeline can attach the OLN proposals as model inputs.")
    return cfg.TPU.MAX_PRECOMPUTED_PROPOSALS


def build_tokenizer(cfg) -> Optional[WordPieceTokenizer]:
    path = cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_PATH
    if path and os.path.exists(path):
        return WordPieceTokenizer.from_vocab_file(path)
    default = os.path.join(cfg.DATASETS.ROOT,
                           "datasets_data/bert/vocab.txt")
    if os.path.exists(default):
        return WordPieceTokenizer.from_vocab_file(default)
    logger.warning("No BERT vocab file found; using a tiny synthetic "
                   "vocab (set MODEL.LANGUAGE_BACKBONE.VOCAB_PATH).")
    return WordPieceTokenizer(build_tiny_vocab(["a", "photo", "of"]))


def build_test_loader(cfg, dataset_name: str,
                      tokenizer: Optional[WordPieceTokenizer],
                      needs_text: bool, val: bool = False) -> DataLoader:
    """Test loader (TEST.IMS_PER_BATCH) or validation-loss loader
    (SOLVER.IMS_PER_BATCH // world, the reference's
    build_detection_val_loader, dataloader.py:66-121), over the
    process's shard of the registered dataset."""
    get_register_dataset(dataset_name)(dataset_name, cfg.DATASETS.ROOT)
    records = DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    mapper = DetectionMapper(cfg, meta, is_train=False,
                             tokenizer=tokenizer, mlm=False, seed=0)
    rank, world = process_rank_world()
    sampler = InferenceSampler(len(records), rank=rank, world_size=world)
    if val:
        bs = max(cfg.SOLVER.IMS_PER_BATCH // world, 1)
    else:
        bs = max(cfg.TEST.IMS_PER_BATCH, 1)
    return DataLoader(records, mapper, sampler, bs,
                      derive_buckets(cfg, False), cfg.TPU.MAX_GT_BOXES,
                      has_text=needs_text, is_train=False,
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      worker_backend=cfg.DATALOADER.WORKER_BACKEND,
                      seed=0, rank=rank,
                      proposal_slots=proposal_slots(cfg))


def load_embeddings(cfg, dataset_name: str, device=None) -> torch.Tensor:
    """The class-embedding matrix registered for a dataset, [K + 1, D]
    with a zero background row, on ``device`` (the card unless the
    caller asks for the CPU). Falls back to seeded random embeddings
    when the embedding JSON is not on disk (smoke/test runs)."""
    get_register_dataset(dataset_name)(dataset_name, cfg.DATASETS.ROOT)
    meta = MetadataCatalog.get(dataset_name)
    mtx = meta.get("class_emb_mtx")
    if mtx is None:
        k = len(meta.get("thing_classes", [])) + 1
        logger.warning("No class embeddings for %s; using random",
                       dataset_name)
        mtx = np.random.RandomState(0).randn(
            k, cfg.MODEL.ROI_BOX_HEAD.EMB_DIM).astype(np.float32)
        mtx[-1] = 0.0
    return torch.from_numpy(np.asarray(mtx)).to(resolve_device(device))


def test(cfg, model: torch.nn.Module, device=None) -> Dict[str, Dict]:
    """Detection evaluation of ``model`` on each of ``cfg.DATASETS.TEST``
    (the detection branch of ``OVRTrainer.test``): its test loader, its
    class embeddings on ``device`` (the card unless the caller asks for
    the CPU: where the model is), the eval step, the COCO or LVIS
    summary and the seen/unseen AP50. Returns {dataset: results}.
    Raises where JAX would run what the port does not have yet: TTA,
    the loss half of a ``loss_and_*`` evaluation, int8 serving."""
    if cfg.TEST.AUG.ENABLED:
        raise NotImplementedError(
            "TEST.AUG.ENABLED: test-time augmentation is not ported yet "
            "(ROADMAP queue 1, item 8)")
    if cfg.TPU.INT8_EVAL:
        raise NotImplementedError(
            "TPU.INT8_EVAL: the int8 serving mode is not ported yet "
            "(ROADMAP queue 1, item 9)")
    needs_text = cfg.MODEL.META_ARCHITECTURE in LSM_ARCHS
    tokenizer = build_tokenizer(cfg) if needs_text else None
    eval_step = make_eval_step(model)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        etype = select_evaluator_type(cfg, dataset_name)
        if etype == "ovr" or (etype.startswith("loss_and_") and
                              cfg.TEST.DO_EVAL):
            raise NotImplementedError(
                f"evaluation type {etype!r}: the loss-only evaluation is "
                f"not ported yet (ROADMAP queue 1, item 7)")
        loader = build_test_loader(cfg, dataset_name, tokenizer,
                                   needs_text)
        try:
            class_emb = load_embeddings(cfg, dataset_name, device)
            res = inference_on_detection_dataset(
                eval_step, None, loader, class_emb, dataset_name,
                etype=etype)
        finally:
            loader.close()
        results[dataset_name] = res
        logger.info("Results for %s: %s", dataset_name,
                    {k: round(v, 3) for k, v in res.items()
                     if isinstance(v, float) and "-" not in k})
    return results
