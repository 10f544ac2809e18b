"""From-scratch COCO bbox evaluation (mAP): numpy + native C++ core.

The port's own copy of ``locov_tpu/evaluation/coco_eval.py``, with
``COCOEvaluatorTPU`` named ``COCOEvaluator``. Replaces pycocotools'
``COCOeval`` C/Cython path for the bbox task (the reference consumes
it through d2's COCOEvaluator, ``ovr/evaluation/evaluator.py:16-17``).
Semantics follow the COCO protocol exactly: IoU thresholds
.50:.05:.95, 101-point interpolated precision, area ranges, maxDets
(1, 10, 100), crowd gts matched by intersection-over-detection-area,
stable score-desc sorting.

Matching is computed ONCE per (image, category) cell for all IoU
thresholds and area ranges at the largest maxDet — greedy matching in
score order is prefix-stable, so smaller maxDets are prefixes — and
runs in the native library (``locov_torch/native/cocoeval.cpp``, built
into ``build/native/`` by ``locov_torch/utils/native.py``) when ``g++``
can build it, with a semantically-identical numpy fallback.
"""
from __future__ import annotations

import ctypes
import subprocess
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

_NATIVE = None


def _load_native():
    """The native matcher, or None where it cannot be built (the numpy
    matcher runs then)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    from ..utils import native
    try:
        lib = native.load("cocoeval")
        lib.coco_match_cell.restype = None
        lib.coco_match_cell.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8)]
        _NATIVE = lib
    except (OSError, subprocess.CalledProcessError):
        _NATIVE = False
    return _NATIVE or None


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU; crowd gt uses intersection / det-area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_cell_numpy(ious, g_ignore_per_area, g_crowd, d_area,
                      area_lo, area_hi):
    """Greedy matching for one (image, category): returns
    (dtm [A, T, D] bool, dtig [A, T, D] bool)."""
    D, G = ious.shape
    A = g_ignore_per_area.shape[0]
    T = len(IOU_THRS)
    dtm = np.zeros((A, T, D), bool)
    dtig = np.zeros((A, T, D), bool)
    for a in range(A):
        gig = g_ignore_per_area[a]
        order = np.argsort(gig, kind="mergesort")
        out_of_rng = (d_area < area_lo[a]) | (d_area > area_hi[a])
        for t, thr in enumerate(IOU_THRS):
            gtm = np.full(G, -1)
            for d in range(D):
                best = min(thr, 1 - 1e-10)
                m = -1
                for g in order:
                    if gtm[g] >= 0 and not g_crowd[g]:
                        continue
                    if m > -1 and not gig[m] and gig[g]:
                        break
                    if ious[d, g] < best:
                        continue
                    best = ious[d, g]
                    m = g
                if m == -1:
                    dtig[a, t, d] = out_of_rng[d]
                    continue
                dtm[a, t, d] = True
                dtig[a, t, d] = gig[m]
                gtm[m] = d
    return dtm, dtig


def _match_cell(ious, g_ignore_per_area, g_crowd, d_area,
                area_lo, area_hi):
    lib = _load_native()
    if lib is None:
        return _match_cell_numpy(ious, g_ignore_per_area, g_crowd,
                                 d_area, area_lo, area_hi)
    D, G = ious.shape
    A = g_ignore_per_area.shape[0]
    T = len(IOU_THRS)
    ious_c = np.ascontiguousarray(ious, np.float64)
    gig_c = np.ascontiguousarray(g_ignore_per_area, np.uint8)
    gcr_c = np.ascontiguousarray(g_crowd, np.uint8)
    da_c = np.ascontiguousarray(d_area, np.float64)
    lo_c = np.ascontiguousarray(area_lo, np.float64)
    hi_c = np.ascontiguousarray(area_hi, np.float64)
    thr_c = np.ascontiguousarray(IOU_THRS, np.float64)
    dtm = np.zeros((A, T, D), np.uint8)
    dtig = np.zeros((A, T, D), np.uint8)
    p = lambda arr, ty: arr.ctypes.data_as(ctypes.POINTER(ty))
    lib.coco_match_cell(
        p(ious_c, ctypes.c_double), D, G,
        p(gig_c, ctypes.c_uint8), p(gcr_c, ctypes.c_uint8),
        p(da_c, ctypes.c_double), p(lo_c, ctypes.c_double),
        p(hi_c, ctypes.c_double), A, p(thr_c, ctypes.c_double), T,
        p(dtm, ctypes.c_uint8), p(dtig, ctypes.c_uint8))
    return dtm.astype(bool), dtig.astype(bool)


class COCOEvaluator:
    """Accumulates detections and computes COCO bbox metrics."""

    def __init__(self, gts: List[dict], image_ids: Sequence,
                 category_ids: Sequence,
                 class_names: Optional[List[str]] = None,
                 max_dets: Sequence[int] = MAX_DETS):
        self.image_ids = list(image_ids)
        self.cat_ids = list(category_ids)
        self.class_names = class_names
        self.max_dets = tuple(max_dets)
        self._gts = defaultdict(list)
        for g in gts:
            self._gts[(g["image_id"], g["category_id"])].append(g)
        self._dts = defaultdict(list)

    def _ignore_unmatched_dts(self, img_id, cat_id) -> bool:
        """Hook: when True, unmatched detections in this (image,
        category) cell are ignored rather than counted as FP (the LVIS
        not-exhaustive rule). COCO never ignores."""
        return False

    def reset(self):
        self._dts = defaultdict(list)

    def process(self, image_id, boxes: np.ndarray, scores: np.ndarray,
                category_ids: np.ndarray):
        for b, s, c in zip(boxes, scores, category_ids):
            self._dts[(image_id, int(c))].append(
                {"bbox": np.asarray(b, np.float64), "score": float(s)})

    # ------------------------------------------------------------ evaluate
    def _eval_cell(self, img_id, cat_id, max_det: int):
        """Returns None or dict(dtm [A,T,D], dtig [A,T,D], scores [D],
        npig [A])."""
        gts = self._gts.get((img_id, cat_id), [])
        dts = self._dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        g_boxes = np.array([g["bbox"] for g in gts],
                           np.float64).reshape(-1, 4)
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts],
                           bool)
        g_ig0 = np.array(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
             for g in gts], bool)
        g_area = np.array([g.get(
            "area", (g["bbox"][2] - g["bbox"][0])
            * (g["bbox"][3] - g["bbox"][1])) for g in gts], np.float64)

        order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        order = order[:max_det]
        d_boxes = np.array([dts[i]["bbox"] for i in order],
                           np.float64).reshape(-1, 4)
        d_scores = np.array([dts[i]["score"] for i in order], np.float64)
        d_area = (d_boxes[:, 2] - d_boxes[:, 0]) * \
            (d_boxes[:, 3] - d_boxes[:, 1])
        if self._ignore_unmatched_dts(img_id, cat_id):
            # area -1 falls outside every range, which is exactly the
            # "ignore if unmatched" predicate of the matcher (matched
            # dts never consult d_area)
            d_area = np.full_like(d_area, -1.0)

        rngs = np.array(list(AREA_RNGS.values()))
        lo, hi = rngs[:, 0], rngs[:, 1]
        gig_a = g_ig0[None, :] | (g_area[None, :] < lo[:, None]) | \
            (g_area[None, :] > hi[:, None])

        ious = _iou_xyxy(d_boxes, g_boxes, g_crowd)
        dtm, dtig = _match_cell(ious, gig_a, g_crowd, d_area, lo, hi)
        npig = (~gig_a).sum(axis=1)
        return dict(dtm=dtm, dtig=dtig, scores=d_scores, npig=npig)

    def accumulate(self) -> Dict[str, np.ndarray]:
        K = len(self.cat_ids)
        A = len(AREA_RNGS)
        M = len(self.max_dets)
        T = len(IOU_THRS)
        R = len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        max_det = max(self.max_dets)

        for ki, cat in enumerate(self.cat_ids):
            cells = [self._eval_cell(img, cat, max_det)
                     for img in self.image_ids]
            cells = [c for c in cells if c is not None]
            if not cells:
                continue
            for mi, md in enumerate(self.max_dets):
                scores = np.concatenate(
                    [c["scores"][:md] for c in cells])
                order = np.argsort(-scores, kind="mergesort")
                scores_s = scores[order]
                for ai in range(A):
                    dtm = np.concatenate(
                        [c["dtm"][ai, :, :md] for c in cells],
                        axis=1)[:, order]
                    dtig = np.concatenate(
                        [c["dtig"][ai, :, :md] for c in cells],
                        axis=1)[:, order]
                    npig = int(sum(c["npig"][ai] for c in cells))
                    if npig == 0:
                        continue
                    tps = dtm & ~dtig
                    fps = ~dtm & ~dtig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # right-max interpolation (vectorized)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[ti, :, ki, ai, mi] = q
        return {"precision": precision, "recall": recall}

    # ------------------------------------------------------------ metrics
    def summarize(self, per_category: bool = False) -> Dict[str, float]:
        acc = self.accumulate()
        p = acc["precision"]
        r = acc["recall"]

        def ap(iou=None, area="all", max_det=None):
            ai = list(AREA_RNGS).index(area)
            mi = self.max_dets.index(max_det or max(self.max_dets))
            s = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
                s = s[ti:ti + 1]
            s = s[s > -1]
            return float(s.mean()) if s.size else float("nan")

        def ar(area="all", max_det=None):
            ai = list(AREA_RNGS).index(area)
            mi = self.max_dets.index(max_det or max(self.max_dets))
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else float("nan")

        out = {
            "AP": ap() * 100, "AP50": ap(iou=0.5) * 100,
            "AP75": ap(iou=0.75) * 100,
            "APs": ap(area="small") * 100, "APm": ap(area="medium") * 100,
            "APl": ap(area="large") * 100,
            "AR@1": ar(max_det=1) * 100, "AR@10": ar(max_det=10) * 100,
            "AR@100": ar(max_det=100) * 100,
        }
        if per_category and self.class_names:
            ai = list(AREA_RNGS).index("all")
            mi = self.max_dets.index(max(self.max_dets))
            for ki, name in enumerate(self.class_names):
                s = p[:, :, ki, ai, mi]
                s = s[s > -1]
                out[f"AP-{name}"] = float(s.mean()) * 100 if s.size \
                    else float("nan")
                s50 = p[0, :, ki, ai, mi]
                s50 = s50[s50 > -1]
                out[f"AP50-{name}"] = float(s50.mean()) * 100 if s50.size \
                    else float("nan")
        return out


def from_coco_json(json_file: str, class_names=None):
    """Build an evaluator directly from a COCO annotation file."""
    import json as _json
    with open(json_file) as f:
        data = _json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    gts = []
    for ann in data.get("annotations", []):
        x, y, w, h = ann["bbox"]
        gts.append({
            "image_id": ann["image_id"],
            "category_id": ann["category_id"],
            "bbox": [x, y, x + w, y + h],
            "area": ann.get("area", w * h),
            "iscrowd": ann.get("iscrowd", 0),
            "ignore": ann.get("ignore", 0),
        })
    return COCOEvaluator(
        gts, [im["id"] for im in data["images"]],
        [c["id"] for c in cats],
        class_names or [c["name"] for c in cats])
