"""Test-time augmentation (TEST.AUG): multi-scale + horizontal flip.

Counterpart of ``locov_tpu/evaluation/tta.py`` (the d2
``GeneralizedRCNNWithTTA`` surface the reference inherits; off in every
shipped config): for each (min_size, flip) augmentation run the normal
inference pass, map detections back to original-image coordinates (the
inference already rescales to the original size, so only the flip needs
inverting: ``collect_detections(mirror_x=True)``), union all candidates
per image, then per-class NMS at MODEL.ROI_HEADS.NMS_THRESH_TEST keeping
TEST.DETECTIONS_PER_IMAGE. The merge is host numpy in float64, as in
JAX.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from ..data.catalog import MetadataCatalog
from .evaluator import (add_seen_unseen_summary, build_evaluator_for,
                        collect_detections, dataset_id_lut,
                        gather_host_detections, score_detections)

logger = logging.getLogger(__name__)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray,
               thresh: float, classes: np.ndarray = None) -> np.ndarray:
    """Host-side exact greedy NMS; returns kept indices (score-desc).

    With ``classes`` given, suppression only applies between boxes of
    the same class (per-class NMS via class-equality masking, as
    ``ops/nms.py`` does on the device; no coordinate offsets)."""
    order = np.argsort(-scores, kind="mergesort")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        lt = np.maximum(boxes[i, :2], boxes[:, :2])
        rb = np.minimum(boxes[i, 2:], boxes[:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-12)
        hit = iou > thresh
        if classes is not None:
            hit &= classes == classes[i]
        suppressed |= hit
    return np.asarray(keep, np.int64)


def merge_tta_detections(flat: Dict[str, np.ndarray], nms_thresh: float,
                         topk: int) -> Dict[str, np.ndarray]:
    """Union of all augmentations' detections -> per-image per-class
    NMS -> top-k per image (d2 TTA merge)."""
    out = {k: [] for k in ("img", "box", "score", "cls")}
    for img in np.unique(flat["img"]):
        sel = flat["img"] == img
        boxes = flat["box"][sel]
        scores = flat["score"][sel]
        cls = flat["cls"][sel]
        keep = greedy_nms(boxes, scores, nms_thresh, classes=cls)
        keep = keep[:topk]  # greedy_nms returns score-desc order
        out["img"].append(np.full(len(keep), img, np.int64))
        out["box"].append(boxes[keep])
        out["score"].append(scores[keep])
        out["cls"].append(cls[keep])
    return {k: (np.concatenate(v) if v else flat[k][:0])
            for k, v in out.items()}


def build_tta_loaders(cfg, dataset_name: str, tokenizer=None,
                      needs_text: bool = False) -> List[Tuple[object, bool]]:
    """One test loader (``engine/trainer.py:build_test_loader``) per
    (min_size, flip) augmentation, sizes in ``TEST.AUG.MIN_SIZES`` order,
    unflipped before flipped. Returns [(loader, flipped)]; the caller
    closes the loaders."""
    from ..engine.trainer import build_test_loader
    augs = []
    flips = [False, True] if cfg.TEST.AUG.FLIP else [False]
    for s in cfg.TEST.AUG.MIN_SIZES:
        c = cfg.clone()  # unfrozen
        c.INPUT.MIN_SIZE_TEST = s
        c.INPUT.MAX_SIZE_TEST = cfg.TEST.AUG.MAX_SIZE
        for flip in flips:
            loader = build_test_loader(c, dataset_name, tokenizer,
                                       needs_text)
            loader.mapper.flip_mode = "horizontal_always" if flip \
                else "none"
            augs.append((loader, flip))
    return augs


def inference_with_tta(eval_step, params, loaders, class_emb,
                       dataset_name: str, nms_thresh: float, topk: int,
                       per_category: bool = True, etype: str = None,
                       gather_fn=gather_host_detections
                       ) -> Dict[str, float]:
    """TTA evaluation: collect over every augmented loader, merge via
    per-image class-wise NMS, score with the dataset's protocol.
    ``params`` is ignored (``collect_detections``). Besides the metrics,
    the results hold ``tta_passes`` (the loaders run) and
    ``tta_detections`` / ``tta_merged`` (the detections before and
    after the merge, over every process)."""
    meta = MetadataCatalog.get(dataset_name)
    inv = dataset_id_lut(meta)
    parts = []
    for loader, flipped in loaders:
        flat, _ = collect_detections(eval_step, params, loader,
                                     class_emb, inv, mirror_x=flipped)
        parts.append(flat)
    merged = {k: np.concatenate([p[k] for p in parts])
              for k in parts[0]}
    merged = gather_fn(merged)
    n_before = len(merged["img"])
    merged = merge_tta_detections(merged, nms_thresh, topk)
    logger.info("TTA: %d passes, %d detections merged to %d",
                len(loaders), n_before, len(merged["img"]))
    evaluator = build_evaluator_for(dataset_name, etype)
    score_detections(evaluator, merged)
    results = evaluator.summarize(per_category=per_category)
    results.update(tta_passes=len(loaders), tta_detections=n_before,
                   tta_merged=len(merged["img"]))
    return add_seen_unseen_summary(results, meta)
