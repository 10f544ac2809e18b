"""C4 ROI heads (Res5), static-shape.

Counterpart of ``locov_tpu/models/roi_heads.py``: proposal labelling and
fixed-size sampling (masked and batched, with the sampler's uniform
draws as inputs), ROIAlign -> shared res5 -> mean-pool -> the box
predictor ``ROI_BOX_HEAD.NAME`` selects (the embedding predictor, or the
multi-token grounding predictor under
"EmbeddingGroundingFastRCNNOutputLayers"), and the FastRCNN losses over
the sampled batch. ``roi_features`` takes the int8 serving mode's
``int8`` argument (``models/resnet.py``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from ..ops import matcher as matcher_ops
from ..ops.int8_conv import QuantizedTensor
from ..ops.roi_align import (roi_align_batched_int8, roi_align_batched_quant,
                             roi_align_fused)
from ..structures import boxes as box_ops
from ..structures.batches import GtBatch, ProposalBatch
from .box_emb_grounding import (ClassTokenEmbeddings,
                                EmbeddingGroundingBoxPredictor)
from .box_predictor import (BoxPredictorConfig, EmbeddingBoxPredictor,
                            fast_rcnn_losses)
from .resnet import ResNetStage, record_amax_
from .rpn import add_gt_to_proposals


class ROIHeadsConfig(NamedTuple):
    """The JAX package's ``ROIHeadsConfig``."""
    num_classes: int
    batch_size_per_image: int
    positive_fraction: float
    iou_thresholds: tuple
    iou_labels: tuple
    proposal_append_gt: bool
    pooler_resolution: int
    # d2 semantics: 0 = adaptive, ceil(roi_size / pooled) samples per bin
    pooler_sampling_ratio: int
    feature_stride: int
    # TPU.USE_PALLAS_ROIALIGN: the JAX package's fixed-grid Pallas
    # ROIAlign, which samples at ratio 2 where adaptive is asked; the
    # port computes the same function under either setting
    use_pallas_roi_align: bool = False
    # TPU.INT8_ROIALIGN: under the static int8 scheme, ROIAlign itself
    # runs int8 x int8 (``roi_align_batched_int8``); off, the float op
    # and a static quantize of its output (``roi_align_batched_quant``)
    int8_roialign: bool = True

    @classmethod
    def from_cfg(cls, cfg):
        rh = cfg.MODEL.ROI_HEADS
        return cls(
            num_classes=rh.NUM_CLASSES,
            batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rh.POSITIVE_FRACTION,
            iou_thresholds=tuple(rh.IOU_THRESHOLDS),
            iou_labels=tuple(rh.IOU_LABELS),
            proposal_append_gt=rh.PROPOSAL_APPEND_GT,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD
            .POOLER_SAMPLING_RATIO,
            feature_stride=16,
            use_pallas_roi_align=cfg.TPU.USE_PALLAS_ROIALIGN,
            int8_roialign=cfg.TPU.INT8_ROIALIGN)

    @property
    def sampling_ratio(self) -> int:
        """The sampling ratio ROIAlign runs at."""
        if self.use_pallas_roi_align and self.pooler_sampling_ratio <= 0:
            return 2
        return self.pooler_sampling_ratio


class SampledProposals(NamedTuple):
    boxes: torch.Tensor       # [B, S, 4]
    gt_classes: torch.Tensor  # [B, S] int64, num_classes = background
    gt_boxes: torch.Tensor    # [B, S, 4] matched gt for box regression
    is_fg: torch.Tensor       # [B, S] bool
    valid: torch.Tensor       # [B, S] bool


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at idx [B, S] along dim 1."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def label_and_sample_proposals(proposals: ProposalBatch, gt: GtBatch,
                               rcfg: ROIHeadsConfig, u_pos: torch.Tensor,
                               u_neg: torch.Tensor) -> SampledProposals:
    """Masked, batched SampleAllROIHeads.label_and_sample_proposals:
    append the gt (``proposal_append_gt``), IoU-match, label fg/bg, and
    sample a fixed ``batch_size_per_image`` with at most
    ``positive_fraction`` positives. u_pos, u_neg: the sampler's
    uniform draws, [B, N] for the N proposals after the gt is
    appended."""
    if rcfg.proposal_append_gt:
        proposals = add_gt_to_proposals(proposals, gt)
    quality = box_ops.pairwise_iou(gt.boxes, proposals.boxes)  # [B, M, N]
    midx, mlabel = matcher_ops.match(quality, gt.mask, rcfg.iou_thresholds,
                                     rcfg.iou_labels)
    bg = torch.full_like(midx, rcfg.num_classes)
    cls = torch.where(mlabel == 1, torch.gather(gt.classes.long(), 1, midx),
                      bg)
    cls = torch.where(mlabel == -1, torch.full_like(cls, -1), cls)

    is_pos = (cls >= 0) & (cls < rcfg.num_classes)
    is_neg = cls == rcfg.num_classes
    # padding proposals are never sampled
    sample_label = torch.where(is_pos, 1, torch.where(is_neg, 0, -1))
    sample_label = torch.where(proposals.mask, sample_label, -1)
    sampled, _, valid = matcher_ops.subsample_labels(
        sample_label, rcfg.batch_size_per_image, rcfg.positive_fraction,
        u_pos, u_neg)

    s_cls = torch.where(valid, torch.gather(cls, 1, sampled),
                        torch.full_like(sampled, rcfg.num_classes))
    return SampledProposals(
        boxes=_take(proposals.boxes, sampled),
        gt_classes=s_cls,
        gt_boxes=_take(gt.boxes, torch.gather(midx, 1, sampled)),
        is_fg=valid & (s_cls < rcfg.num_classes),
        valid=valid)


GROUNDING_PREDICTOR = "EmbeddingGroundingFastRCNNOutputLayers"


class Res5ROIHeads(nn.Module):
    """Shared res5 box head + the box predictor. ``emb_pred=False``
    builds the embedding predictor without ``emb_pred`` (the
    image-caption stage's shared projection takes its place).
    ``int8_static`` (``TPU.INT8_SCHEME`` static) adds the calibrated
    max-abs buffers of the pooled tensor (``pooled_amax``) and of the
    features entering ROIAlign (``roialign_amax``), and res5's
    ``<conv>_amax``."""

    def __init__(self, rcfg: ROIHeadsConfig, pcfg: BoxPredictorConfig,
                 stride_in_1x1: bool = True, res2_out_channels: int = 256,
                 num_groups: int = 1, width_per_group: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 emb_pred: bool = True, int8_static: bool = False):
        super().__init__()
        self.rcfg = rcfg
        self.grounding = pcfg.name == GROUNDING_PREDICTOR
        if int8_static:
            self.register_buffer("pooled_amax", torch.zeros(()))
            self.register_buffer("roialign_amax", torch.zeros(()))
        self.res5 = ResNetStage(
            num_blocks=3, in_channels=res2_out_channels * 4,
            bottleneck_channels=num_groups * width_per_group * 8,
            out_channels=res2_out_channels * 8, first_stride=2,
            stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype,
            int8_amax=int8_static)
        if self.grounding:
            self.box_predictor = EmbeddingGroundingBoxPredictor(
                res2_out_channels * 8, pcfg.emb_dim,
                local_metric=pcfg.grounding_local_metric,
                alignment=pcfg.grounding_alignment,
                temperature=pcfg.grounding_temperature,
                normalize_emb=pcfg.normalize_emb,
                detach_cls_predictor=pcfg.detach_cls_predictor)
        else:
            self.box_predictor = EmbeddingBoxPredictor(
                res2_out_channels * 8, pcfg, emb_pred=emb_pred)

    def roi_features(self, features: torch.Tensor, boxes: torch.Tensor,
                     int8=False) -> torch.Tensor:
        """ROIAlign + res5 + global mean pool.
        features [B, H, W, C] (NHWC); boxes [B, S, 4] -> [B, S, C5].
        ROIAlign is differentiable in the features: the CUDA kernels on
        the card (in f32, cast once to the features' dtype), the plain
        versions on the CPU.

        ``int8`` (serving): "static" quantizes the pooled tensor by
        ``pooled_amax``, in a full-int8 ROIAlign (``int8_roialign``, the
        features quantized by ``roialign_amax``) or after the float one,
        and res5's first block takes the int8 tensor as it is;
        "calibrate" runs the float ROIAlign and records both max-abs
        values; every int8 mode runs res5 in int8."""
        b, s = boxes.shape[:2]
        rc = self.rcfg
        features, boxes = features.contiguous(), boxes.float().contiguous()
        if int8 == "static":
            if rc.int8_roialign:
                q, scale = roi_align_batched_int8(
                    features, boxes, 1.0 / rc.feature_stride,
                    self.roialign_amax, self.pooled_amax,
                    pooled=rc.pooler_resolution,
                    sampling_ratio=rc.pooler_sampling_ratio)
            else:
                q, scale = roi_align_batched_quant(
                    features, boxes, 1.0 / rc.feature_stride,
                    self.pooled_amax, pooled=rc.pooler_resolution,
                    sampling_ratio=rc.pooler_sampling_ratio)
            pooled = QuantizedTensor(q.reshape((b * s,) + q.shape[2:]),
                                     scale)
        else:
            pooled = roi_align_fused(features, boxes, 1.0 / rc.feature_stride,
                                     pooled=rc.pooler_resolution,
                                     sampling_ratio=rc.sampling_ratio)
            pooled = pooled.reshape((b * s,) + pooled.shape[2:])
            if int8 == "calibrate":
                record_amax_(self.pooled_amax, pooled)
                record_amax_(self.roialign_amax, features)
        out = self.res5(pooled, int8=int8)
        return out.mean(dim=(1, 2)).reshape(b, s, -1)

    def grid_features(self, features: torch.Tensor) -> torch.Tensor:
        """res5 over the whole feature map [B, H, W, C] (NHWC), with the
        ROI path's parameters."""
        return self.res5(features)

    def predict(self, box_features: torch.Tensor, class_emb,
                emb_override=None):
        """(scores, deltas) of the box features. ``class_emb``: the
        [K+1, D] matrix, or for the grounding predictor also
        ``ClassTokenEmbeddings`` (a matrix is one token a class).
        ``emb_override``: embeddings in place of the embedding
        predictor's ``emb_pred`` (the grounding predictor takes none,
        as in the JAX package)."""
        if not self.grounding:
            return self.box_predictor(box_features, class_emb,
                                      emb_override)
        if emb_override is not None:
            raise TypeError("the grounding box predictor takes no "
                            "embeddings from a shared projection")
        if not isinstance(class_emb, ClassTokenEmbeddings):
            class_emb = ClassTokenEmbeddings.single_token(class_emb)
        return self.box_predictor(box_features, class_emb)


def roi_heads_losses(scores: torch.Tensor, deltas: torch.Tensor,
                     sampled: SampledProposals,
                     pcfg: BoxPredictorConfig, global_batch=None
                     ) -> Dict[str, torch.Tensor]:
    """The FastRCNN losses over the flattened per-image samples (with
    ``global_batch``, normalised over every rank's samples)."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return fast_rcnn_losses(flat(scores), flat(deltas), flat(sampled.boxes),
                            flat(sampled.gt_classes), flat(sampled.gt_boxes),
                            flat(sampled.valid), pcfg, global_batch)
