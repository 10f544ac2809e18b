"""ToyPyramidRCNN, the plain reference's copy: a detector whose trunk and
box head are not C4, as a later configuration's would be. A trunk of
four stride-2 convolutions, a two-level pyramid (strides 8 and 16: the
lateral 1x1 convolutions, the top-down sum and a level embedding, whose
law only ``seed_laws`` gives), one RPN head shared by both levels with
its logits flattened over them, ROIAlign on each level summed, a one-layer
box head and the embedding classifier. Each stage runs in a
``ToyPyramidRCNN.<stage>`` range."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.roi_align import roi_align_fused
from ...structures import boxes as box_ops
from ...structures.batches import DetectionBatch, Detections, ImageBatch
from ...utils.device import resolve_device
from .. import register_meta_arch
from ..box_predictor import (BoxPredictorConfig, EmbeddingBoxPredictor,
                             fast_rcnn_inference_batched)
from ..resnet import conv_nhwc
from ..rpn import (RPNConfig, RPNHead, generate_cell_anchors, grid_anchors,
                   select_proposals)
from .ovr_rcnn import detections_from_scores, normalize_and_zero_pad

NAME = "ToyPyramidRCNN"
STRIDES = (8, 16)


def _stage(name: str):
    return record_function(f"{NAME}.{name}")


def _conv(x, conv: nn.Conv2d, stride: int, dtype) -> torch.Tensor:
    return conv_nhwc(x, conv.weight.to(dtype), stride, conv.padding[0]) + \
        conv.bias.to(dtype)


class Trunk(nn.Module):
    """Four 3x3 stride-2 convolutions; the last two maps are the
    levels."""

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.convs = nn.ModuleList(
            nn.Conv2d(3 if i == 0 else channels, channels, 3, padding=1)
            for i in range(4))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for i, conv in enumerate(self.convs):
            x = F.relu(_conv(x, conv, 2, self.compute_dtype))
            if i >= 2:
                out.append(x)
        return out


class Pyramid(nn.Module):
    """The lateral 1x1 convolutions, the top level summed into the one
    below at twice its size, and a learned embedding a level."""
    seed_laws = {"level_embed": ("normal", 0.02)}

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.lateral = nn.ModuleList(nn.Conv2d(channels, channels, 1)
                                     for _ in STRIDES)
        self.level_embed = nn.Parameter(torch.zeros(len(STRIDES), channels))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        dt = self.compute_dtype
        low, top = (_conv(f, c, 1, dt) for f, c in zip(feats, self.lateral))
        up = top.repeat_interleave(2, 1).repeat_interleave(2, 2)
        low = low + up[:, :low.shape[1], :low.shape[2]]
        return [low + self.level_embed[0].to(dt),
                top + self.level_embed[1].to(dt)]


@register_meta_arch(NAME)
class ToyPyramidRCNN(nn.Module):
    def __init__(self, channels: int, pixel_mean: tuple, pixel_std: tuple,
                 rpn_cfg: RPNConfig, pcfg: BoxPredictorConfig, pooled: int,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.rpn_cfg, self.pcfg, self.pooled = rpn_cfg, pcfg, pooled
        self.compute_dtype = compute_dtype
        self.backbone = Trunk(channels, compute_dtype)
        self.pyramid = Pyramid(channels, compute_dtype)
        self.rpn_head = RPNHead(channels, len(rpn_cfg.aspect_ratios),
                                channels, compute_dtype)
        self.box_head = nn.Linear(channels * pooled * pooled, 2 * channels)
        self.box_predictor = EmbeddingBoxPredictor(2 * channels, pcfg)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
            else torch.float32
        return cls(channels=cfg.MODEL.TOY_PYRAMID.CHANNELS,
                   pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                   pixel_std=tuple(cfg.MODEL.PIXEL_STD),
                   rpn_cfg=RPNConfig.from_cfg(cfg),
                   pcfg=BoxPredictorConfig.from_cfg(cfg),
                   pooled=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
                   compute_dtype=dtype, device=device)

    def levels(self, images: ImageBatch) -> List[torch.Tensor]:
        with _stage("preprocess"):
            x = normalize_and_zero_pad(images, self.pixel_mean,
                                       self.pixel_std, self.compute_dtype)
        with _stage("backbone"):
            feats = self.backbone(x)
        with _stage("pyramid"):
            return self.pyramid(feats)

    def run_rpn(self, levels: List[torch.Tensor]):
        """Anchors [N_a, 4], logits [B, N_a] and deltas [B, N_a, 4] over
        both levels, the level of stride 8 first; level l takes the l-th
        anchor size."""
        anchors, logits, deltas = [], [], []
        for i, (f, stride) in enumerate(zip(levels, STRIDES)):
            lg, dl = self.rpn_head(f)
            cell = generate_cell_anchors((self.rpn_cfg.sizes[i],),
                                         self.rpn_cfg.aspect_ratios,
                                         device=f.device)
            anchors.append(grid_anchors(cell, f.shape[1], f.shape[2],
                                        stride, self.rpn_cfg.offset))
            logits.append(lg.float())
            deltas.append(dl.float())
        return torch.cat(anchors), torch.cat(logits, 1), torch.cat(deltas, 1)

    def box_features(self, levels: List[torch.Tensor],
                     boxes: torch.Tensor) -> torch.Tensor:
        b, n = boxes.shape[:2]
        boxes = boxes.float().contiguous()
        pooled = sum(roi_align_fused(f.contiguous(), boxes, 1.0 / s,
                                     pooled=self.pooled, sampling_ratio=0)
                     .float() for f, s in zip(levels, STRIDES))
        return F.relu(self.box_head(pooled.reshape(b, n, -1)))

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        images = batch.images
        levels = self.levels(images)
        with _stage("rpn_head"):
            anchors, logits, deltas = self.run_rpn(levels)
        with _stage("select_proposals"):
            proposals = select_proposals(anchors, logits, deltas, images.hw,
                                         self.rpn_cfg)
        with _stage("box_head"):
            x = self.box_features(levels, proposals.boxes)
        with _stage("predict"):
            scores, deltas2 = self.box_predictor(x, class_emb.float())
        with _stage("fast_rcnn_inference"):
            dets = fast_rcnn_inference_batched(
                scores, deltas2, proposals.boxes, proposals.mask, images.hw,
                self.pcfg)
            scale = images.orig_hw.float() / images.hw.float()
            boxes = box_ops.scale(dets.boxes, scale[:, None, 1],
                                  scale[:, None, 0])
            boxes = box_ops.clip(boxes, (images.orig_hw[:, 0:1],
                                         images.orig_hw[:, 1:2]))
        return dets._replace(boxes=boxes)

    @torch.inference_mode()
    def detect_from_proposals(self, batch: DetectionBatch,
                              class_emb: torch.Tensor,
                              proposals) -> Dict[str, torch.Tensor]:
        """The check's contract (``benchmark/reference/steps.py:detect``):
        this model's own levels and heads from the given proposals."""
        levels = self.levels(batch.images)
        _, logits, _ = self.run_rpn(levels)
        scores, deltas = self.box_predictor(
            self.box_features(levels, proposals.boxes), class_emb.float())
        return {"logits": logits, **detections_from_scores(
            scores, deltas, proposals, batch.images, self.pcfg)}
