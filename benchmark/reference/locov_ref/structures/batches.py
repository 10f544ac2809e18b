"""Static padded batch containers as NamedTuples of torch tensors.

Counterpart of ``locov_tpu/structures/batches.py``: every field is a
fixed-shape tensor plus a validity mask. ``to_torch`` moves a batch of
numpy arrays (what the host loader emits) onto a device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class BoxBatch(NamedTuple):
    """Fixed-size padded boxes: boxes [B, N, 4] float32 XYXY in the
    resized image's frame; mask [B, N] bool, True for real boxes."""
    boxes: torch.Tensor
    mask: torch.Tensor


class GtBatch(NamedTuple):
    """Padded ground-truth instances: boxes [B, M, 4] XYXY float32;
    classes [B, M] int32 (contiguous ids); mask [B, M] bool."""
    boxes: torch.Tensor
    classes: torch.Tensor
    mask: torch.Tensor


class ProposalBatch(NamedTuple):
    """boxes: [B, N, 4] XYXY; objectness: [B, N] f32 logits; mask: [B, N]."""
    boxes: torch.Tensor
    objectness: torch.Tensor
    mask: torch.Tensor


class TextBatch(NamedTuple):
    """Tokenized captions (the host tokenizer's output, with its masked
    language modelling draws): input_ids / target_ids [B, L] int32;
    attention_mask / special_tokens_mask / mlm_mask [B, L] int32."""
    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    special_tokens_mask: torch.Tensor
    target_ids: torch.Tensor
    mlm_mask: torch.Tensor


class CaptionFeatures(NamedTuple):
    """The language backbone's output, which the MMSS heads read: the
    ``TextBatch`` fields plus encoded_tokens and input_embeddings, each
    [B, L, D]."""
    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    special_tokens_mask: torch.Tensor
    target_ids: torch.Tensor
    mlm_mask: torch.Tensor
    encoded_tokens: torch.Tensor
    input_embeddings: torch.Tensor

    def asdict(self):
        return self._asdict()


class RegionFeatures(NamedTuple):
    """Visual regions fed to the MMSS heads: features [B, R, C]; mask
    [B, R] bool; loc [B, R, 2] normalized (x, y)."""
    features: torch.Tensor
    mask: torch.Tensor
    loc: torch.Tensor


class DetectionBatch(NamedTuple):
    """One batch for the detection and image-caption paths. Inference
    reads ``images`` and, with precomputed proposals, ``proposals``;
    training also reads ``gt``, and the image-caption stage ``text``.
    ``gt_obj`` holds the original gt where object proposals were turned
    into binary gt."""
    images: ImageBatch
    gt: Optional[GtBatch] = None
    proposals: Optional[ProposalBatch] = None
    text: Optional[TextBatch] = None
    gt_obj: Optional[GtBatch] = None


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


def take_rows(batch, start: int, stop: int):
    """Rows ``start:stop`` (images of the batch) of every array of a
    (nested) NamedTuple; ``None`` fields stay ``None``: one rank's share
    of a global batch."""
    if batch is None:
        return None
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(take_rows(v, start, stop) for v in batch))
    return batch[start:stop]
