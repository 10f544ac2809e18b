"""ToyPyramidRCNN, the program's side, for the test that a new
architecture enters the benchmark through added files alone
(``benchmark/tests/test_bench_extend.py``). A real configuration adds
its model to ``locov_torch`` itself; this one is registered by
``install``, which also gives the port's ``get_cfg`` the key that the
architecture reads (``MODEL.TOY_PYRAMID.CHANNELS``), as the reference's
config extension gives the reference's. The same arithmetic as the
reference's copy, on the port's modules: a trunk of four stride-2
convolutions, a two-level pyramid with a level embedding, one RPN head
over both levels (its logits flattened over them, the proposals chosen
by this module's ``select_proposals``), ROIAlign on each level summed, a
one-layer box head and the embedding classifier."""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from locov_torch.models import register_meta_arch
from locov_torch.models.box_predictor import (BoxPredictorConfig,
                                              EmbeddingBoxPredictor,
                                              fast_rcnn_inference_batched)
from locov_torch.models.meta_arch.ovr_rcnn import normalize_and_zero_pad
from locov_torch.models.resnet import conv_nhwc
from locov_torch.models.rpn import (RPNConfig, RPNHead,
                                    generate_cell_anchors, grid_anchors,
                                    select_proposals)
from locov_torch.ops.roi_align import roi_align_fused
from locov_torch.structures import boxes as box_ops
from locov_torch.structures.batches import (DetectionBatch, Detections,
                                            ImageBatch)
from locov_torch.utils.device import resolve_device
from locov_torch.utils.trace import stage

NAME = "ToyPyramidRCNN"
STRIDES = (8, 16)


def _stage(name: str):
    return stage(NAME, name)


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


def install() -> None:
    """The port's ``get_cfg`` with ``MODEL.TOY_PYRAMID.CHANNELS`` (16 by
    default); the model registered above on import."""
    import locov_torch.config as config
    from locov_torch.config.node import CfgNode
    plain = config.get_cfg

    def get_cfg():
        cfg = plain()
        cfg.MODEL.TOY_PYRAMID = CfgNode()
        cfg.MODEL.TOY_PYRAMID.CHANNELS = 16
        return cfg
    config.get_cfg = get_cfg
