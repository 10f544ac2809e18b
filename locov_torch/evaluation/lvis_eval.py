"""From-scratch LVIS v1 bbox evaluation (federated-dataset protocol).

The port's own copy of ``locov_tpu/evaluation/lvis_eval.py``, with
``LVISEvaluatorTPU`` named ``LVISEvaluator``. Replaces the lvis-api
``LVISEval`` the reference consumes through d2's ``LVISEvaluator``
(``ovr/evaluation/evaluator.py:17,48-50``). The LVIS protocol differs
from COCO in exactly four ways (lvis-api eval.py):

1. **Federated filtering**: a detection for category c on image i is
   evaluated only if c is *positive* on i (has gt) or *verified
   negative* (``neg_category_ids``); otherwise the dataset says nothing
   about c on i and the detection is dropped entirely.
2. **Not-exhaustive ignore**: if c is in i's
   ``not_exhaustive_category_ids``, unmatched detections are ignored
   (not false positives) because gt for c on i is incomplete.
3. **maxDets = 300** per image across all categories (a single
   operating point; AR is AR@300).
4. **Frequency buckets**: APr / APc / APf over rare ('r'), common
   ('c'), frequent ('f') categories.

Everything else (IoU grid, 101-point interpolation, area ranges,
greedy matching) is the COCO machinery, so this subclasses
``COCOEvaluator`` and reuses the native C++ matcher: the
not-exhaustive rule maps onto the matcher's existing
area-out-of-range-if-unmatched predicate by assigning those cells a
detection area of -1.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval import AREA_RNGS, IOU_THRS, COCOEvaluator

LVIS_MAX_DETS = (300,)


class LVISEvaluator(COCOEvaluator):
    """LVIS bbox evaluator over per-image category-knowledge sets.

    gts: COCO-style list (xyxy bbox, image_id, category_id, area).
    neg_category_ids / not_exhaustive_category_ids: per-image dicts
    (image_id -> iterable of category ids, in the SAME id space as
    category_ids — raw LVIS ids when built from a registered dataset).
    freq_groups: {'r'|'c'|'f' -> iterable of category ids}.
    """

    def __init__(self, gts: List[dict], image_ids: Sequence,
                 category_ids: Sequence,
                 class_names: Optional[List[str]] = None,
                 neg_category_ids: Optional[Dict] = None,
                 not_exhaustive_category_ids: Optional[Dict] = None,
                 freq_groups: Optional[Dict[str, Sequence]] = None,
                 max_dets: Sequence[int] = LVIS_MAX_DETS):
        super().__init__(gts, image_ids, category_ids, class_names,
                         max_dets=max_dets)
        self._pos = {img: set() for img in self.image_ids}
        for (img, cat), anns in self._gts.items():
            if anns:
                self._pos.setdefault(img, set()).add(cat)
        self._neg = {img: set(cats) for img, cats in
                     (neg_category_ids or {}).items()}
        self._nel = {img: set(cats) for img, cats in
                     (not_exhaustive_category_ids or {}).items()}
        self.freq_groups = {k: set(v) for k, v in
                            (freq_groups or {}).items()}

    # -------------------------------------------------- protocol hooks
    def _ignore_unmatched_dts(self, img_id, cat_id) -> bool:
        return cat_id in self._nel.get(img_id, ())

    def process(self, image_id, boxes: np.ndarray, scores: np.ndarray,
                category_ids: np.ndarray):
        """Cap to max_dets per image (LVISResults), then drop
        detections for categories with no knowledge on this image
        (lvis-api _prepare)."""
        scores = np.asarray(scores, np.float64)
        if len(scores) > max(self.max_dets):
            keep = np.argsort(-scores, kind="mergesort")
            keep = keep[:max(self.max_dets)]
            boxes = np.asarray(boxes)[keep]
            category_ids = np.asarray(category_ids)[keep]
            scores = scores[keep]
        known = self._pos.get(image_id, set()) | \
            self._neg.get(image_id, set())
        for b, s, c in zip(boxes, scores, category_ids):
            if int(c) in known:
                self._dts[(image_id, int(c))].append(
                    {"bbox": np.asarray(b, np.float64),
                     "score": float(s)})

    # --------------------------------------------------------- summary
    def summarize(self, per_category: bool = False) -> Dict[str, float]:
        acc = self.accumulate()
        p = acc["precision"]
        r = acc["recall"]
        mi = self.max_dets.index(max(self.max_dets))
        ai_all = list(AREA_RNGS).index("all")

        def ap(iou=None, area="all", cat_subset=None):
            ai = list(AREA_RNGS).index(area)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
                s = s[ti:ti + 1]
            if cat_subset is not None:
                ks = [ki for ki, c in enumerate(self.cat_ids)
                      if c in cat_subset]
                s = s[:, :, ks] if ks else s[:, :, :0]
            s = s[s > -1]
            return float(s.mean()) if s.size else float("nan")

        out = {
            "AP": ap() * 100, "AP50": ap(iou=0.5) * 100,
            "AP75": ap(iou=0.75) * 100,
            "APs": ap(area="small") * 100,
            "APm": ap(area="medium") * 100,
            "APl": ap(area="large") * 100,
        }
        for tag in ("r", "c", "f"):
            if tag in self.freq_groups:
                out[f"AP{tag}"] = ap(
                    cat_subset=self.freq_groups[tag]) * 100
        s = r[:, :, ai_all, mi]
        s = s[s > -1]
        out[f"AR@{max(self.max_dets)}"] = \
            (float(s.mean()) if s.size else float("nan")) * 100
        if per_category and self.class_names:
            for ki, name in enumerate(self.class_names):
                s = p[:, :, ki, ai_all, mi]
                s = s[s > -1]
                out[f"AP-{name}"] = float(s.mean()) * 100 if s.size \
                    else float("nan")
                s50 = p[0, :, ki, ai_all, mi]
                s50 = s50[s50 > -1]
                out[f"AP50-{name}"] = float(s50.mean()) * 100 \
                    if s50.size else float("nan")
        return out


def build_lvis_evaluator(dataset_name: str) -> LVISEvaluator:
    """Build from a registered LVIS dataset: gts + per-image
    neg/not-exhaustive sets in raw dataset-id space, frequency buckets
    from the registration metadata."""
    from ..data.catalog import DatasetCatalog, MetadataCatalog
    records = DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    id_map = meta.thing_dataset_id_to_contiguous_id
    inv = {v: k for k, v in id_map.items()}
    gts, neg, nel = [], {}, {}
    for rec in records:
        img = rec["image_id"]
        neg[img] = [c for c in rec.get("neg_category_ids", [])]
        nel[img] = [c for c in
                    rec.get("not_exhaustive_category_ids", [])]
        for a in rec["annotations"]:
            gts.append({
                "image_id": img,
                "category_id": inv[a["category_id"]],
                "bbox": a["bbox"], "area": a["area"],
                "iscrowd": a.get("iscrowd", 0),
            })
    names = list(meta.thing_classes)
    name_to_dataset_id = {n: inv[i] for i, n in enumerate(names)}
    freq_groups = {}
    for tag, group_names in getattr(meta, "freq_classes", {}).items():
        ids = [name_to_dataset_id[n] for n in group_names
               if n in name_to_dataset_id]
        if ids:
            freq_groups[tag] = ids
    return LVISEvaluator(
        gts, [r["image_id"] for r in records],
        [inv[i] for i in range(len(names))], names,
        neg_category_ids=neg, not_exhaustive_category_ids=nel,
        freq_groups=freq_groups)
