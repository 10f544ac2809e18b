"""C4 ROI heads (Res5), static-shape, inference.

Counterpart of ``locov_tpu/models/roi_heads.py`` (inference part):
ROIAlign -> shared res5 -> mean-pool -> embedding box predictor.
Proposal labelling and sampling come with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.roi_align import roi_align_fused
from .box_predictor import BoxPredictorConfig, EmbeddingBoxPredictor
from .resnet import ResNetStage


class ROIHeadsConfig(NamedTuple):
    """The inference fields of the JAX package's ``ROIHeadsConfig``;
    proposal labelling and sampling come with the training slice."""
    pooler_resolution: int
    # d2 semantics: 0 = adaptive, ceil(roi_size / pooled) samples per bin
    pooler_sampling_ratio: int
    feature_stride: int

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD
            .POOLER_SAMPLING_RATIO,
            feature_stride=16)


class Res5ROIHeads(nn.Module):
    """Shared res5 box head + embedding predictor."""

    def __init__(self, rcfg: ROIHeadsConfig, pcfg: BoxPredictorConfig,
                 stride_in_1x1: bool = True, res2_out_channels: int = 256,
                 num_groups: int = 1, width_per_group: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pcfg.name == "EmbeddingGroundingFastRCNNOutputLayers":
            raise NotImplementedError(
                "the grounding box predictor is not ported yet")
        self.rcfg = rcfg
        self.res5 = ResNetStage(
            num_blocks=3, in_channels=res2_out_channels * 4,
            bottleneck_channels=num_groups * width_per_group * 8,
            out_channels=res2_out_channels * 8, first_stride=2,
            stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype)
        self.box_predictor = EmbeddingBoxPredictor(res2_out_channels * 8,
                                                   pcfg)

    def roi_features(self, features: torch.Tensor,
                     boxes: torch.Tensor) -> torch.Tensor:
        """ROIAlign + res5 + global mean pool.
        features [B, H, W, C] (NHWC); boxes [B, S, 4] -> [B, S, C5].
        ROIAlign is the CUDA kernel on the card (in f32, cast once to
        the features' dtype) and the plain version on the CPU."""
        b, s = boxes.shape[:2]
        pooled = roi_align_fused(
            features.contiguous(), boxes.float().contiguous(),
            1.0 / self.rcfg.feature_stride,
            pooled=self.rcfg.pooler_resolution,
            sampling_ratio=self.rcfg.pooler_sampling_ratio)
        out = self.res5(pooled.reshape((b * s,) + pooled.shape[2:]))
        return out.mean(dim=(1, 2)).reshape(b, s, -1)

    def predict(self, box_features: torch.Tensor,
                class_emb: torch.Tensor):
        return self.box_predictor(box_features, class_emb)
