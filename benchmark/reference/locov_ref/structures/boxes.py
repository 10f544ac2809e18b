"""Box algebra on ``[..., 4]`` XYXY tensors, in float32.

Counterpart of ``locov_tpu/structures/boxes.py`` (the detector's
subset): plain tensors with explicit validity masks, batched and
static-shape. Geometry stays in full float32: nothing here runs a
matrix product, so TF32 never applies.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

# detectron2's _DEFAULT_SCALE_CLAMP: clamp dw/dh before exp
SCALE_CLAMP = math.log(1000.0 / 16)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; negative extents clamp to zero area."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def clip(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """Clip XYXY boxes to [0, W] x [0, H]. ``image_hw`` is (h, w): two
    scalars, or two tensors that broadcast against ``boxes[..., 0]``."""
    h, w = image_hw[0], image_hw[1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h)], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Boolean mask of boxes with both sides > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def centers(boxes: torch.Tensor) -> torch.Tensor:
    """(x, y) centers, as d2's ``Boxes.get_centers``."""
    return (boxes[..., :2] + boxes[..., 2:]) / 2.0


def scale(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    sx = torch.as_tensor(scale_x, dtype=boxes.dtype, device=boxes.device)
    sy = torch.as_tensor(scale_y, dtype=boxes.dtype, device=boxes.device)
    return boxes * torch.stack(torch.broadcast_tensors(sx, sy, sx, sy),
                               dim=-1)


def pairwise_intersection(boxes1: torch.Tensor,
                          boxes2: torch.Tensor) -> torch.Tensor:
    """[..., M, 4] x [..., N, 4] -> [..., M, N] intersection areas."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between all pairs; empty boxes give IoU 0 (as in d2)."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(inter > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def get_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weights: Tuple[float, float, float, float]) -> torch.Tensor:
    """Encode target boxes relative to source boxes as (dx, dy, dw, dh)
    (d2 Box2BoxTransform.get_deltas), the inverse of ``apply_deltas``.
    Zero-sized (padding) boxes are guarded by a 1e-6 floor on the
    sizes, as in the JAX package."""
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    safe_w = src_w.clamp(min=1e-6)
    safe_h = src_h.clamp(min=1e-6)
    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(tgt_w.clamp(min=1e-6) / safe_w)
    dh = wh * torch.log(tgt_h.clamp(min=1e-6) / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, float, float, float],
                 scale_clamp: float = SCALE_CLAMP) -> torch.Tensor:
    """Decode deltas on top of boxes (d2 Box2BoxTransform). ``deltas``
    may be [..., N, k*4] for k classes; boxes broadcast per class.
    Returns the shape of ``deltas``."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=scale_clamp)
    dh = (d[..., 3] / wh).clamp(max=scale_clamp)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
         pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)
    return out.reshape(deltas.shape)
