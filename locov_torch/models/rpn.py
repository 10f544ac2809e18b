"""Region Proposal Network, static-shape: single-level C4, and over the
levels of a feature pyramid.

Counterpart of ``locov_tpu/models/rpn.py`` (anchors, head, losses,
proposal selection at the training and the test top-k, gt appended to
the proposals). Per-image proposal lists are fixed [POST_NMS_TOPK, 4]
tensors with validity masks; NMS is ``ops/nms.py``; label assignment and
sampling are the masked batched ops of ``ops/matcher.py``.

The pyramid's RPN (``PyramidRPNConfig``, ``PyramidRPNHead``,
``select_level_proposals``; no JAX counterpart) follows Detectron2's
``find_top_rpn_proposals`` at test time: the top-k of each level, NMS
within each level (the level as the class), the top-k over all levels.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, NamedTuple, Tuple

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


# ---------------------------------------------------------------- pyramid
class PyramidRPNConfig(NamedTuple):
    """The RPN over the levels of a pyramid: ``rpn`` (the single-level
    fields; its ``sizes`` the first level's, its ``stride`` 0), and per
    level its anchor sizes, stride and anchors (``level_sizes``, H_l x
    W_l x A on the canvas the model pads every image to), finest first,
    in the order the levels are flattened."""
    rpn: RPNConfig
    level_anchor_sizes: Tuple[tuple, ...]
    strides: Tuple[int, ...]
    level_sizes: Tuple[int, ...]

    @classmethod
    def from_cfg(cls, cfg, strides, sides):
        """``strides`` and ``sides`` (each level's square side on the
        canvas) of the levels of ``MODEL.RPN.IN_FEATURES``; one
        ``ANCHOR_GENERATOR.SIZES`` entry a level."""
        sizes = tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES)
        if len(sizes) != len(strides):
            raise ValueError(f"ANCHOR_GENERATOR.SIZES: {len(sizes)} "
                             f"entries for {len(strides)} levels")
        a = len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0])
        return cls(rpn=RPNConfig.from_cfg(cfg)._replace(stride=0),
                   level_anchor_sizes=sizes, strides=tuple(strides),
                   level_sizes=tuple(s * s * len(z) * a
                                     for s, z in zip(sides, sizes)))


class PyramidRPNHead(nn.Module):
    """Detectron2's ``StandardRPNHead`` with ``conv_dims`` of
    ``num_convs`` convs (``conv.conv0``, ...), each 3 x 3 with ReLU,
    then the sibling 1 x 1 objectness and delta convs; one head shared
    by every level. Parameters stay f32; the convs run in the compute
    dtype."""

    def __init__(self, in_channels: int, num_anchors: int, num_convs: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Sequential(OrderedDict(
            (f"conv{i}", nn.Conv2d(in_channels, in_channels, 3, padding=1))
            for i in range(num_convs)))
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def _run(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = conv_nhwc(x.to(dt), conv.weight.to(dt), 1, conv.padding[0])
        return out + conv.bias.to(dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One level [B, H, W, C] -> logits [B, H W A], deltas [B, H W A,
        4]."""
        t = x
        for conv in self.conv:
            t = F.relu(self._run(conv, t))
        b = x.shape[0]
        return (self._run(self.objectness_logits, t).reshape(b, -1),
                self._run(self.anchor_deltas, t).reshape(b, -1, 4))


def level_cell_anchors(level_anchor_sizes, aspect_ratios) -> torch.Tensor:
    """[L, A, 4] cell anchors of every level on the host, for a model to
    keep on its device."""
    return torch.stack([generate_cell_anchors(sizes, aspect_ratios)
                        for sizes in level_anchor_sizes])


def select_level_proposals(anchors: torch.Tensor, logits: torch.Tensor,
                           deltas: torch.Tensor, image_hw: torch.Tensor,
                           rpn_cfg: PyramidRPNConfig,
                           training: bool = False) -> ProposalBatch:
    """The top-k of each level (at the training or the test top-k) ->
    decode -> clip -> NMS within each level (the level as the class, in
    one batched pass) -> the top post-NMS k over the levels by score.
    anchors [N_a, 4]; logits [B, N_a]; deltas [B, N_a, 4] (f32), levels
    flattened finest first, ``rpn_cfg.level_sizes`` anchors each."""
    cfg = rpn_cfg.rpn
    pre_topk = cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test
    post_topk = (cfg.post_nms_topk_train if training
                 else cfg.post_nms_topk_test)
    if sum(rpn_cfg.level_sizes) != anchors.shape[0]:
        raise ValueError(f"select_level_proposals: {anchors.shape[0]} "
                         f"anchors, levels of {rpn_cfg.level_sizes}")
    scores: List[torch.Tensor] = []
    idx: List[torch.Tensor] = []
    lvl: List[torch.Tensor] = []
    off = 0
    for i, n in enumerate(rpn_cfg.level_sizes):
        s, j = nms_ops.top_k(logits[:, off:off + n], min(pre_topk, n))
        scores.append(s)
        idx.append(j + off)
        lvl.append(torch.full_like(j, i, dtype=torch.int32))
        off += n
    top_scores, idx, level = (torch.cat(x, dim=1) for x in (scores, idx, lvl))
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.apply_deltas(sel_deltas, anchors[idx],
                                 cfg.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (image_hw[:, 0:1], image_hw[:, 1:2]))
    valid = box_ops.nonempty(boxes, cfg.min_size)
    valid &= torch.isfinite(top_scores) & torch.isfinite(boxes).all(dim=-1)
    post_topk = min(post_topk, top_scores.shape[1])
    keep = nms_ops.batched_nms_mask_batched(
        boxes, top_scores, level, valid, cfg.nms_thresh,
        stop_after=post_topk)
    neg_inf = torch.finfo(top_scores.dtype).min
    kept = torch.where(keep, top_scores, torch.full_like(top_scores,
                                                         neg_inf))
    top, keep_idx = nms_ops.top_k(kept, post_topk)
    return ProposalBatch(
        boxes=torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4)),
        objectness=torch.gather(top_scores, 1, keep_idx),
        mask=top > neg_inf)
