"""Static padded batch containers as NamedTuples of torch tensors.

Counterpart of ``locov_tpu/structures/batches.py``: every field is a
fixed-shape tensor plus a validity mask. ``to_torch`` moves a batch of
numpy arrays (what the host loader emits) onto a device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class ImageBatch(NamedTuple):
    """image: [B, H, W, 3] float (NHWC); hw: [B, 2] int32 valid (h, w)
    inside the padded canvas; orig_hw: [B, 2] int32 pre-resize size;
    image_id: [B] int64 (host bookkeeping)."""
    image: torch.Tensor
    hw: torch.Tensor
    orig_hw: torch.Tensor
    image_id: Optional[torch.Tensor] = None


class ProposalBatch(NamedTuple):
    """boxes: [B, N, 4] XYXY; objectness: [B, N] f32 logits; mask: [B, N]."""
    boxes: torch.Tensor
    objectness: torch.Tensor
    mask: torch.Tensor


class DetectionBatch(NamedTuple):
    """One batch for the detection paths. Inference reads ``images``
    and, with precomputed proposals, ``proposals``; the training fields
    come with the training slice."""
    images: ImageBatch
    gt: Any = None
    proposals: Optional[ProposalBatch] = None
    text: Any = None
    gt_obj: Any = None


class Detections(NamedTuple):
    """Fixed-size inference output (top-K per image): boxes [B, K, 4] in
    original-image coordinates; scores [B, K]; classes [B, K] int32;
    mask [B, K] valid flag."""
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    mask: torch.Tensor


def to_torch(batch, device):
    """Convert a (nested) NamedTuple of numpy arrays to torch tensors
    on ``device``; ``None`` fields stay ``None``."""
    if batch is None:
        return None
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(to_torch(v, device) for v in batch))
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
