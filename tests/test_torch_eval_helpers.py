"""Helpers shared by the evaluation parity tests
(tests/test_torch_{data,evaluator}.py); no tests of their own.

``fresh_catalogs`` empties both packages' dataset registries,
``assert_same_tree`` compares nested batches and records exactly, and
the synthetic eval step (detections made from the gt) drives the
port's evaluation loop without a model, in this process or in the
ranks of a ``torch.distributed`` run (``gloo_eval_worker``, which a
spawned process imports from here).
"""
import numpy as np


def fresh_catalogs():
    """Empty the dataset and metadata catalogs of both packages (each a
    process-wide registry), so a test registers on its own tree."""
    import locov_torch.data as tdata
    import locov_tpu.data as jdata
    for pkg in (jdata, tdata):
        for name in list(pkg.DatasetCatalog._registry):
            pkg.DatasetCatalog.remove(name)
        for name in list(pkg.MetadataCatalog._store):
            pkg.MetadataCatalog.remove(name)


def assert_same_tree(a, b, path="batch"):
    """Equal nested NamedTuples / dicts / arrays / scalars / strings:
    arrays equal in shape, dtype and value, ``None`` where ``None``."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, path
        assert a._fields == b._fields, path
        for f in a._fields:
            assert_same_tree(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (str, bytes)):
        assert a == b, path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


EVAL_SLOTS = 8  # detection slots an image of the synthetic eval step


def synth_detections(rec, n_classes):
    """Deterministic detections for one record: its gt boxes jittered,
    with seeded scores, plus one noise box (padded to EVAL_SLOTS)."""
    rng = np.random.RandomState(rec["image_id"] % 100000)
    boxes, scores, classes = [], [], []
    for a in rec["annotations"]:
        boxes.append(np.asarray(a["bbox"], np.float32)
                     + rng.uniform(-2, 2, 4).astype(np.float32))
        scores.append(rng.uniform(0.5, 1.0))
        classes.append(a["category_id"])
    boxes.append(np.asarray([1, 1, 9, 9], np.float32))
    scores.append(rng.uniform(0.1, 0.4))
    classes.append(rng.randint(0, n_classes))
    n_ = min(len(boxes), EVAL_SLOTS)
    out = (np.zeros((EVAL_SLOTS, 4), np.float32),
           np.zeros(EVAL_SLOTS, np.float32), np.zeros(EVAL_SLOTS, np.int32))
    out[0][:n_] = np.stack(boxes)[:n_]
    out[1][:n_] = np.asarray(scores)[:n_]
    out[2][:n_] = np.asarray(classes)[:n_]
    return out + (np.arange(EVAL_SLOTS) < n_,)


def synth_eval_step(records, n_classes):
    """An eval step(batch, class_emb) -> Detections of numpy arrays
    (``synth_detections`` of each image in the batch, nothing for the
    loader's padding rows), in the port's container."""
    from locov_torch.structures.batches import Detections
    by_id = {r["image_id"]: r for r in records}
    empty = (np.zeros((EVAL_SLOTS, 4), np.float32),
             np.zeros(EVAL_SLOTS, np.float32),
             np.zeros(EVAL_SLOTS, np.int32), np.zeros(EVAL_SLOTS, bool))

    def step(batch, class_emb):
        outs = [synth_detections(by_id[int(i)], n_classes) if i >= 0
                else empty for i in np.asarray(batch.images.image_id)]
        return Detections(*(np.stack(x) for x in zip(*outs)))
    return step


def synthetic_eval(root, name, batch):
    """The port's ``inference_on_detection_dataset`` of the synthetic
    eval step over ``engine/trainer.py:build_test_loader``'s loader of
    ``name`` (this process's shard where torch.distributed runs)."""
    from locov_torch.data import DatasetCatalog, MetadataCatalog
    from locov_torch.data.synthetic import micro_cfg
    from locov_torch.engine.trainer import build_test_loader
    from locov_torch.evaluation.evaluator import \
        inference_on_detection_dataset
    cfg = micro_cfg(root)
    cfg.TEST.IMS_PER_BATCH = batch
    with build_test_loader(cfg, name, None, False) as loader:
        step = synth_eval_step(
            DatasetCatalog.get(name),
            len(MetadataCatalog.get(name).thing_classes))
        return inference_on_detection_dataset(step, None, loader, None,
                                              name)


def gloo_eval_worker(rank, world, port, root, name, batch, out_path):
    """One rank of a ``torch.distributed`` (gloo) evaluation: its shard
    through ``synthetic_eval``; the detections merge across ranks in
    ``gather_host_detections``; the results go to ``out_path`` as
    JSON."""
    import json
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = synthetic_eval(root, name, batch)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def synth_loss_step(batch, class_emb, generator):
    """A loss-evaluation step without a model: metrics that are
    functions of the batch (its image ids, pixels and caption tokens),
    as 0-d tensors."""
    import torch
    images = batch.images
    ids = torch.as_tensor(np.asarray(images.image_id), dtype=torch.float64)
    pixels = torch.as_tensor(np.asarray(images.image), dtype=torch.float64)
    tokens = torch.as_tensor(np.asarray(batch.text.attention_mask),
                             dtype=torch.float64)
    return {"id_loss": ids.mean(), "Pixel Mean": pixels.mean(),
            "token loss": tokens.sum() / 7.0}


def synthetic_caption_eval(root, name):
    """The port's ``inference_on_caption_dataset`` of ``synth_loss_step``
    over the captions test loader of ``name`` at batch 1 (this process's
    shard where torch.distributed runs)."""
    from locov_torch.data.synthetic import micro_cfg
    from locov_torch.engine.trainer import (build_test_loader,
                                            build_tokenizer)
    from locov_torch.evaluation.evaluator import \
        inference_on_caption_dataset
    cfg = micro_cfg(root, "DistillProposalMMSSRCNN")
    cfg.TEST.IMS_PER_BATCH = 1
    with build_test_loader(cfg, name, build_tokenizer(cfg), True) as loader:
        return inference_on_caption_dataset(synth_loss_step, None, loader,
                                            None, None)


def gloo_caption_worker(rank, world, port, root, name, out_path):
    """One rank of a gloo loss-only evaluation: its shard through
    ``synthetic_caption_eval`` (the sums merge across ranks in
    ``inference_on_caption_dataset``); (metrics, losses) to ``out_path``
    as JSON."""
    import json
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = synthetic_caption_eval(root, name)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)
