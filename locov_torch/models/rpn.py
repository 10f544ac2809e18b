"""Region Proposal Network (single-level C4), static-shape, inference.

Counterpart of ``locov_tpu/models/rpn.py`` (anchors, head, proposal
selection). Per-image proposal lists are fixed [POST_NMS_TOPK, 4]
tensors with validity masks; NMS is ``ops/nms.py``. The losses come
with the training slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nms as nms_ops
from ..structures import boxes as box_ops
from ..structures.batches import ProposalBatch
from .resnet import conv_nhwc


def generate_cell_anchors(sizes, aspect_ratios,
                          device=None) -> torch.Tensor:
    """[A, 4] anchors centred at (0, 0) (d2 DefaultAnchorGenerator)."""
    anchors = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = w * ar
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def grid_anchors(cell_anchors: torch.Tensor, grid_h: int, grid_w: int,
                 stride: int, offset: float = 0.0) -> torch.Tensor:
    """[grid_h * grid_w * A, 4] anchors over the feature grid."""
    dev = cell_anchors.device
    shift_x = (torch.arange(grid_w, dtype=torch.float32, device=dev)
               + offset) * stride
    shift_y = (torch.arange(grid_h, dtype=torch.float32, device=dev)
               + offset) * stride
    sx, sy = torch.meshgrid(shift_x, shift_y, indexing="xy")  # [gh, gw]
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + cell_anchors[None, :, :]).reshape(-1, 4)


class RPNHead(nn.Module):
    """3x3 conv + sibling 1x1 objectness / anchor-delta convs (d2
    StandardRPNHead). Parameters stay f32; the convs run in the trunk's
    compute dtype, as Flax does with ``dtype=``."""

    def __init__(self, in_channels: int, num_anchors: int, conv_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(in_channels, conv_dim, 3, padding=1)
        self.objectness_logits = nn.Conv2d(conv_dim, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(conv_dim, num_anchors * 4, 1)

    def _run(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = conv_nhwc(x.to(dt), conv.weight.to(dt), 1, conv.padding[0])
        return out + conv.bias.to(dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = F.relu(self._run(self.conv, x))
        logits = self._run(self.objectness_logits, t)
        deltas = self._run(self.anchor_deltas, t)
        b = x.shape[0]
        return logits.reshape(b, -1), deltas.reshape(b, -1, 4)


class RPNConfig(NamedTuple):
    """The inference fields of the JAX package's ``RPNConfig``; the
    training ones (matcher, sampler, loss, train-time top-k) come with
    the training slice."""
    sizes: tuple
    aspect_ratios: tuple
    stride: int
    offset: float
    bbox_reg_weights: tuple
    pre_nms_topk_test: int
    post_nms_topk_test: int
    nms_thresh: float
    min_size: float

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
            aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            stride=16,
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
            bbox_reg_weights=tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS),
            pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk_test=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
            min_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE)


def select_proposals(anchors: torch.Tensor, logits: torch.Tensor,
                     deltas: torch.Tensor, image_hw: torch.Tensor,
                     rpn_cfg: RPNConfig) -> ProposalBatch:
    """Top-k -> decode -> clip -> NMS -> fixed-K proposals per image, at
    the test-time K. anchors [N_a, 4]; logits [B, N_a]; deltas
    [B, N_a, 4] (f32)."""
    pre_topk = min(rpn_cfg.pre_nms_topk_test, anchors.shape[0])

    top_scores, idx = nms_ops.top_k(logits, pre_topk)  # [B, K]
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.apply_deltas(sel_deltas, anchors[idx],
                                 rpn_cfg.bbox_reg_weights)
    # clip to each image's valid size
    boxes = box_ops.clip(boxes, (image_hw[:, 0:1], image_hw[:, 1:2]))
    valid = box_ops.nonempty(boxes, rpn_cfg.min_size)
    valid &= torch.isfinite(top_scores)
    keep_idx, keep_valid = nms_ops.nms_topk_batched(
        boxes, top_scores, valid, rpn_cfg.nms_thresh,
        rpn_cfg.post_nms_topk_test)
    keep_idx = keep_idx.long()
    return ProposalBatch(
        boxes=torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        objectness=torch.gather(top_scores, 1, keep_idx),
        mask=keep_valid)
