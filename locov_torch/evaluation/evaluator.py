"""Evaluation orchestration.

Counterpart of ``locov_tpu/evaluation/evaluator.py`` (a port of the
reference's ``ovr/evaluation/evaluator.py``): evaluator selection by
meta-arch/dataset (``select_and_build_evaluator``, :25-67), COCO or
LVIS evaluators built from a registered dataset, and detection
evaluation: the eval step (``parallel/mesh.py:make_eval_step``) over a
static loader, per-image detections fed with dataset ids into the
from-scratch evaluator; padded images (image_id == -1) are dropped.
Detections of several processes merge through ``torch.distributed``.
Also the reference's seen/unseen mean-AP50 summary
(custom_coco_eval.py:96-137), and the loss-only evaluation of the
image-caption models (``inference_on_caption_dataset``, one process).

Per batch, the loop moves the numpy batch to the model's device
(``to_torch``), runs the step, waits for the device and brings the
detections back with one ``.cpu()``. It adds up the seconds each part
takes (the ``seconds_*`` keys of the results) and runs the copies in
``torch.profiler.record_function`` ranges ``eval.h2d`` and
``eval.d2h``, beside the model's ``<model>.<stage>`` ranges.
"""
from __future__ import annotations

import datetime
import logging
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..data.catalog import MetadataCatalog
from ..structures.batches import Detections, to_torch
from .coco_eval import COCOEvaluator

logger = logging.getLogger(__name__)

GRID_ARCHS = {"MMSSGridModel", "DistillMMSSGridModel",
              "DistillMMSSMixTokensGridModel",
              "HierarchicalDistillMMSSGridModel"}
LOSS_AND_DET_ARCHS = {"DistillProposalMMSSRCNN",
                      "DistillProposalMMSSMixTokensRCNN",
                      "DistillOnlyProposalMMSSRCNN",
                      "HierarchicalDistillProposalMMSSRCNN"}


def build_coco_evaluator(dataset_name: str) -> COCOEvaluator:
    """Build the COCO evaluator from a registered dataset's gt."""
    from ..data.catalog import DatasetCatalog
    records = DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    id_map = meta.thing_dataset_id_to_contiguous_id
    inv = {v: k for k, v in id_map.items()}
    gts = []
    for r in records:
        for a in r["annotations"]:
            gts.append({
                "image_id": r["image_id"],
                "category_id": inv[a["category_id"]],
                "bbox": a["bbox"], "area": a["area"],
                "iscrowd": a.get("iscrowd", 0),
            })
    cat_ids = [inv[i] for i in range(len(meta.thing_classes))]
    return COCOEvaluator(gts, [r["image_id"] for r in records],
                         cat_ids, list(meta.thing_classes))


def select_evaluator_type(cfg, dataset_name: str) -> str:
    """Reference selection logic (evaluator.py:25-67)."""
    if cfg.MODEL.META_ARCHITECTURE in GRID_ARCHS:
        return "ovr"
    etype = "lvis" if "lvis" in dataset_name else "coco"
    if cfg.MODEL.META_ARCHITECTURE in LOSS_AND_DET_ARCHS:
        etype = "loss_and_" + etype
    return etype


def _all_gather(arr: np.ndarray, world: int) -> np.ndarray:
    """[world, *arr.shape]: every process's ``arr`` (equal shapes)."""
    import torch.distributed as dist
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    local = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    return torch.stack(parts).cpu().numpy()


def gather_host_detections(arrays: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """Concatenate per-process detection arrays across the processes of
    ``torch.distributed``.

    The reference merges predictions with ``comm.gather`` inside d2's
    ``inference_on_dataset`` (SURVEY §3.3); here every process
    all-gathers the others' rows (pad-to-max then trim, since
    ``all_gather`` needs equal shapes) so each computes identical global
    metrics. Identity when ``torch.distributed`` is not initialised or
    its world is 1."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return arrays
    world = dist.get_world_size()
    n_local = len(next(iter(arrays.values())))
    counts = _all_gather(np.asarray([n_local], np.int64), world).reshape(-1)
    n_max = int(counts.max())
    out = {}
    for k, v in arrays.items():
        pad_shape = (n_max - n_local,) + v.shape[1:]
        padded = np.concatenate(
            [v, np.zeros(pad_shape, v.dtype)]) if n_max > n_local else v
        gathered = _all_gather(padded, world)
        out[k] = np.concatenate(
            [gathered[h, :counts[h]] for h in range(world)])
    return out


def _wait(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(dets: Detections) -> Detections:
    """The step's detections as numpy arrays, in one device-to-host copy:
    the four fields packed into one float32 tensor (float32 boxes and
    scores as they are; class ids below 2**24 are exact)."""
    if not isinstance(dets.boxes, torch.Tensor):
        return Detections(*(np.asarray(x) for x in dets))
    packed = torch.cat([dets.boxes.float(), dets.scores.float()[..., None],
                        dets.classes.float()[..., None],
                        dets.mask.float()[..., None]], -1).cpu().numpy()
    return Detections(boxes=packed[..., :4], scores=packed[..., 4],
                      classes=packed[..., 5].astype(np.int64),
                      mask=packed[..., 6] > 0)


def collect_detections(eval_step, params, loader, class_emb,
                       inv: np.ndarray, mirror_x: bool = False,
                       timings: Dict[str, float] = None):
    """Run the eval step over a loader and return flat per-detection
    arrays {img, box, score, cls} (dataset-id classes) plus (n_timed,
    timing_start). ``mirror_x`` flips boxes back to the unflipped frame
    of the original image (test-time augmentation, ``evaluation/
    tta.py``).

    ``eval_step(batch, class_emb)`` is the port's step
    (``make_eval_step``): the module holds its weights, so ``params`` is
    accepted and ignored; the argument keeps JAX's order, so the two
    read side by side. Where the step has a ``device``, each numpy batch
    goes there with ``to_torch`` first. ``timings``, where given, adds
    up the seconds of each part of the loop: ``loader_wait``, ``h2d``,
    ``inference`` (the step, until the device is done) and ``d2h``."""
    device = getattr(eval_step, "device", None)
    spent = timings if timings is not None else {}
    for part in ("loader_wait", "h2d", "inference", "d2h"):
        spent.setdefault(part, 0.0)
    total = len(loader)
    num_warmup = min(5, total - 1)
    start = time.perf_counter()
    n_timed = 0
    d_imgs, d_boxes, d_scores, d_classes = [], [], [], []
    mark = time.perf_counter()
    for idx, batch in enumerate(loader):
        t0 = time.perf_counter()
        spent["loader_wait"] += t0 - mark
        with record_function("eval.h2d"):
            dev_batch = batch if device is None else to_torch(batch, device)
        t1 = time.perf_counter()
        dets = eval_step(dev_batch, class_emb)  # the model's own ranges
        _wait(device)
        t2 = time.perf_counter()
        with record_function("eval.d2h"):
            dets = _to_host(dets)
        t3 = time.perf_counter()
        spent["h2d"] += t1 - t0
        spent["inference"] += t2 - t1
        spent["d2h"] += t3 - t2
        ids = np.asarray(batch.images.image_id)
        orig_hw = np.asarray(batch.images.orig_hw) if mirror_x else None
        for i, img_id in enumerate(ids):
            if img_id < 0:
                continue  # loader padding
            if idx > num_warmup:
                n_timed += 1
            m = dets.mask[i]
            if not m.any():
                continue
            boxes = dets.boxes[i][m].astype(np.float64)
            if mirror_x:
                w = float(orig_hw[i][1])
                boxes = np.stack([w - boxes[:, 2], boxes[:, 1],
                                  w - boxes[:, 0], boxes[:, 3]], axis=1)
            d_imgs.append(np.full(int(m.sum()), int(img_id), np.int64))
            d_boxes.append(boxes)
            d_scores.append(dets.scores[i][m].astype(np.float64))
            d_classes.append(inv[dets.classes[i][m]])
        if idx == num_warmup:
            start = time.perf_counter()
        mark = time.perf_counter()

    flat = {
        "img": (np.concatenate(d_imgs) if d_imgs
                else np.zeros(0, np.int64)),
        "box": (np.concatenate(d_boxes) if d_boxes
                else np.zeros((0, 4), np.float64)),
        "score": (np.concatenate(d_scores) if d_scores
                  else np.zeros(0, np.float64)),
        "cls": (np.concatenate(d_classes) if d_classes
                else np.zeros(0, np.int64)),
    }
    return flat, (n_timed, start)


def dataset_id_lut(meta) -> np.ndarray:
    """Contiguous-id -> dataset-id lookup array."""
    id_map = meta.thing_dataset_id_to_contiguous_id
    inv = np.zeros(max(id_map.values()) + 1, np.int64)
    for did, cid in id_map.items():
        inv[cid] = did
    return inv


def build_evaluator_for(dataset_name: str, etype: str = None):
    """COCO- or LVIS-protocol evaluator by type (reference dispatch,
    evaluator.py:44-50)."""
    meta = MetadataCatalog.get(dataset_name)
    if etype is None:
        etype = getattr(meta, "evaluator_type",
                        "lvis" if "lvis" in dataset_name else "coco")
    if etype.endswith("lvis"):
        from .lvis_eval import build_lvis_evaluator
        return build_lvis_evaluator(dataset_name)
    return build_coco_evaluator(dataset_name)


def score_detections(evaluator, flat: Dict[str, np.ndarray]) -> None:
    """Feed flat detection arrays into an evaluator, whole images at a
    time (the LVIS per-image maxDets cap needs complete groups)."""
    order = np.argsort(flat["img"], kind="mergesort")
    imgs_sorted = flat["img"][order]
    bounds = np.flatnonzero(np.diff(imgs_sorted)) + 1
    for grp in np.split(order, bounds):
        if len(grp):
            evaluator.process(int(flat["img"][grp[0]]),
                              flat["box"][grp], flat["score"][grp],
                              flat["cls"][grp])


def inference_on_detection_dataset(eval_step, params, loader, class_emb,
                                   dataset_name: str,
                                   per_category: bool = True,
                                   etype: str = None,
                                   gather_fn=gather_host_detections
                                   ) -> Dict[str, float]:
    """Run the eval step over the loader, merge detections across
    processes, accumulate COCO or LVIS metrics (protocol chosen like the
    reference's evaluator dispatch, evaluator.py:44-50). ``params`` is
    ignored (see ``collect_detections``). Besides the metrics and
    ``images_per_second`` (images after the warm-up batches over their
    time, as JAX reckons it), the results hold the seconds of the loop's
    parts (``seconds_loader_wait``, ``_h2d``, ``_inference``, ``_d2h``),
    of the evaluator (``seconds_evaluator``: scoring and summary) and of
    the whole call (``seconds_total``)."""
    t_call = time.perf_counter()
    meta = MetadataCatalog.get(dataset_name)
    evaluator = build_evaluator_for(dataset_name, etype)
    spent: Dict[str, float] = {}
    flat, (n_timed, start) = collect_detections(
        eval_step, params, loader, class_emb, dataset_id_lut(meta),
        timings=spent)
    flat = gather_fn(flat)
    t_eval = time.perf_counter()
    score_detections(evaluator, flat)

    elapsed = time.perf_counter() - start
    denom = max(n_timed, 1)
    logger.info(
        "Total inference time: %s (%.6f s / img)",
        datetime.timedelta(seconds=int(elapsed)), elapsed / denom)
    results = evaluator.summarize(per_category=per_category)
    spent["evaluator"] = time.perf_counter() - t_eval
    results["images_per_second"] = denom / max(elapsed, 1e-9)
    results.update({f"seconds_{k}": v for k, v in spent.items()})
    results["seconds_total"] = time.perf_counter() - t_call
    return add_seen_unseen_summary(results, meta)


def add_seen_unseen_summary(results: Dict[str, float],
                            meta) -> Dict[str, float]:
    """Seen/unseen mean AP50 (CustomCOCOEvaluator,
    custom_coco_eval.py:96-137)."""
    from ..data.datasets.coco import categories_seen, categories_unseen
    seen = {c["name"] for c in categories_seen}
    unseen = {c["name"] for c in categories_unseen}
    names = list(getattr(meta, "thing_classes", []))
    for tag, group in (("seen", seen), ("unseen", unseen)):
        vals = [results.get(f"AP50-{n}") for n in names if n in group]
        vals = [v for v in vals if v is not None and not np.isnan(v)]
        if vals:
            results[f"AP50-{tag}"] = float(np.mean(vals))
        avals = [results.get(f"AP-{n}") for n in names if n in group]
        avals = [v for v in avals if v is not None and not np.isnan(v)]
        if avals:
            results[f"AP-{tag}"] = float(np.mean(avals))
    return results


def inference_on_caption_dataset(loss_step, params, loader, class_emb,
                                 generator) -> Tuple[Dict, Dict]:
    """Loss-only eval pass (inference_on_caption_ovr_dataset,
    evaluator.py:99-196): average loss/metric dicts over the loader.

    ``loss_step`` is ``parallel/mesh.py:make_loss_eval_step``'s step,
    called as ``loss_step(batch, class_emb, generator)``; its random
    draws come from ``generator``. ``params`` is unused (the module
    holds its weights; JAX's signature). Per batch, every metric is
    read to the host with one copy, ``"Total Loss"`` is the sum of the
    keys that name a loss, and the sums are averaged over the batches;
    returns (metrics, losses), split by whether a key names a loss.
    Where ``torch.distributed`` runs several ranks, each over its shard,
    the per-rank sums and batch counts are merged by one all_gather
    before the average, which is so weighted by each rank's batches
    (JAX's ``process_allgather``): the mean over every batch of every
    rank. The step itself does not reduce over the ranks, so ranks with
    different batch counts do not wait on each other."""
    totals: Dict[str, float] = {}
    n = 0
    total = len(loader)
    num_warmup = min(5, total - 1)
    start = time.perf_counter()
    compute = 0.0
    for idx, batch in enumerate(loader):
        t0 = time.perf_counter()
        metrics = loss_step(batch, class_emb, generator)
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(())
                              for k in keys]).cpu().tolist()
        metrics = dict(zip(keys, values))
        compute += time.perf_counter() - t0
        loss_total = sum(v for key, v in metrics.items()
                         if "loss" in key.lower())
        metrics["Total Loss"] = loss_total
        for key, v in metrics.items():
            totals[key] = totals.get(key, 0.0) + v
        n += 1
    elapsed = time.perf_counter() - start
    logger.info("Loss-eval time: %s (%.4f s/batch compute)",
                datetime.timedelta(seconds=int(elapsed)),
                compute / max(n - num_warmup, 1))
    totals, n = _merge_over_ranks(totals, n)
    avg = {k: v / max(n, 1) for k, v in totals.items()}
    losses = {k: v for k, v in avg.items() if "loss" in k.lower()}
    metrics = {k: v for k, v in avg.items() if "loss" not in k.lower()}
    return metrics, losses


def _merge_over_ranks(totals: Dict[str, float], n: int
                      ) -> Tuple[Dict[str, float], int]:
    """The sums and the batch count of every rank of
    ``torch.distributed`` added up (one ``all_gather_object``; a rank
    without batches adds nothing); as they are where it does not run."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return totals, n
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (totals, n))
    merged: Dict[str, float] = {}
    for part_totals, _ in parts:
        for k, v in part_totals.items():
            merged[k] = merged.get(k, 0.0) + v
    return merged, sum(part_n for _, part_n in parts)
