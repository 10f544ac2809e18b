"""Region Proposal Network (single-level C4), static-shape.

Counterpart of ``locov_tpu/models/rpn.py`` (anchors, head, losses,
proposal selection at the training and the test top-k, gt appended to
the proposals). Per-image proposal lists are fixed [POST_NMS_TOPK, 4]
tensors with validity masks; NMS is ``ops/nms.py``; label assignment and
sampling are the masked batched ops of ``ops/matcher.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import matcher as matcher_ops
from ..ops import nms as nms_ops
from ..ops import losses
from ..structures import boxes as box_ops
from ..structures.batches import GtBatch, ProposalBatch
from ..utils.trace import wait
from .resnet import conv_nhwc

# d2 add_ground_truth_to_proposals uses the logit of (1 - 1e-10)
GT_PROPOSAL_LOGIT = math.log((1.0 - 1e-10) / (1e-10))


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
    with wait("cell_anchors"):  # a host list to the card: a blocking copy
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
    """The JAX package's ``RPNConfig``: anchors, matcher, sampler, loss
    and the training and test top-k."""
    sizes: tuple
    aspect_ratios: tuple
    stride: int
    offset: float
    iou_thresholds: tuple
    iou_labels: tuple
    batch_size_per_image: int
    positive_fraction: float
    bbox_reg_weights: tuple
    smooth_l1_beta: float
    loss_weight: float
    pre_nms_topk_train: int
    pre_nms_topk_test: int
    post_nms_topk_train: int
    post_nms_topk_test: int
    nms_thresh: float
    min_size: float

    @classmethod
    def from_cfg(cls, cfg):
        rpn = cfg.MODEL.RPN
        return cls(
            sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
            aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            stride=16,
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
            iou_thresholds=tuple(rpn.IOU_THRESHOLDS),
            iou_labels=tuple(rpn.IOU_LABELS),
            batch_size_per_image=rpn.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rpn.POSITIVE_FRACTION,
            bbox_reg_weights=tuple(rpn.BBOX_REG_WEIGHTS),
            smooth_l1_beta=rpn.SMOOTH_L1_BETA,
            loss_weight=rpn.LOSS_WEIGHT,
            pre_nms_topk_train=rpn.PRE_NMS_TOPK_TRAIN,
            pre_nms_topk_test=rpn.PRE_NMS_TOPK_TEST,
            post_nms_topk_train=rpn.POST_NMS_TOPK_TRAIN,
            post_nms_topk_test=rpn.POST_NMS_TOPK_TEST,
            nms_thresh=rpn.NMS_THRESH,
            min_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE)


def rpn_losses(anchors: torch.Tensor, logits: torch.Tensor,
               deltas: torch.Tensor, gt: GtBatch, rpn_cfg: RPNConfig,
               u_pos: torch.Tensor, u_neg: torch.Tensor):
    """RPN objectness (BCE) and box-regression (smooth-L1) losses over a
    batch, each summed over the sampled anchors and divided by
    ``batch_size_per_image * B`` (d2). anchors [N_a, 4]; logits
    [B, N_a]; deltas [B, N_a, 4] (f32); u_pos, u_neg [B, N_a] the
    sampler's uniform draws. Anchors are matched to the gt with
    low-quality matches on."""
    b = logits.shape[0]
    quality = box_ops.pairwise_iou(gt.boxes, anchors[None])  # [B, M, N_a]
    midx, label = matcher_ops.match(
        quality, gt.mask, rpn_cfg.iou_thresholds, rpn_cfg.iou_labels,
        allow_low_quality_matches=True)
    sampled, is_pos, valid = matcher_ops.subsample_labels(
        label, rpn_cfg.batch_size_per_image, rpn_cfg.positive_fraction,
        u_pos, u_neg)

    obj_logit = torch.gather(logits, 1, sampled)
    target = is_pos.to(obj_logit.dtype)
    bce = (losses.max0(obj_logit) - obj_logit * target
           + torch.log1p(torch.exp(-losses.l1(obj_logit))))
    loss_cls = torch.where(valid, bce, torch.zeros_like(bce)).sum()

    gt_idx = torch.gather(midx, 1, sampled)
    matched_gt = torch.gather(gt.boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    gt_deltas = box_ops.get_deltas(anchors[sampled], matched_gt,
                                   rpn_cfg.bbox_reg_weights)
    pred = torch.gather(deltas, 1, sampled[..., None].expand(-1, -1, 4))
    l1 = losses.smooth_l1(pred, gt_deltas, rpn_cfg.smooth_l1_beta).sum(-1)
    loss_box = torch.where(is_pos, l1, torch.zeros_like(l1)).sum()
    norm = rpn_cfg.batch_size_per_image * b
    return {"loss_rpn_cls": loss_cls / norm * rpn_cfg.loss_weight,
            "loss_rpn_loc": loss_box / norm * rpn_cfg.loss_weight}


def select_proposals(anchors: torch.Tensor, logits: torch.Tensor,
                     deltas: torch.Tensor, image_hw: torch.Tensor,
                     rpn_cfg: RPNConfig,
                     training: bool = False) -> ProposalBatch:
    """Top-k -> decode -> clip -> NMS -> fixed-K proposals per image, at
    the training (12000 -> 2000 in d2) or the test (6000 -> 1000) K.
    anchors [N_a, 4]; logits [B, N_a]; deltas [B, N_a, 4] (f32)."""
    pre_topk = (rpn_cfg.pre_nms_topk_train if training
                else rpn_cfg.pre_nms_topk_test)
    post_topk = (rpn_cfg.post_nms_topk_train if training
                 else rpn_cfg.post_nms_topk_test)
    pre_topk = min(pre_topk, anchors.shape[0])

    top_scores, idx = nms_ops.top_k(logits, pre_topk)  # [B, K]
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.apply_deltas(sel_deltas, anchors[idx],
                                 rpn_cfg.bbox_reg_weights)
    # clip to each image's valid size
    boxes = box_ops.clip(boxes, (image_hw[:, 0:1], image_hw[:, 1:2]))
    valid = box_ops.nonempty(boxes, rpn_cfg.min_size)
    valid &= torch.isfinite(top_scores)
    keep_idx, keep_valid = nms_ops.nms_topk_batched(
        boxes, top_scores, valid, rpn_cfg.nms_thresh, post_topk)
    keep_idx = keep_idx.long()
    return ProposalBatch(
        boxes=torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        objectness=torch.gather(top_scores, 1, keep_idx),
        mask=keep_valid)


def add_gt_to_proposals(proposals: ProposalBatch,
                        gt: GtBatch) -> ProposalBatch:
    """The padded gt boxes appended to the proposals with a huge
    objectness logit (d2 add_ground_truth_to_proposals)."""
    gt_logits = torch.where(gt.mask, GT_PROPOSAL_LOGIT, -1e10)
    return ProposalBatch(
        boxes=torch.cat([proposals.boxes, gt.boxes], dim=1),
        objectness=torch.cat([proposals.objectness, gt_logits], dim=1),
        mask=torch.cat([proposals.mask, gt.mask], dim=1))
