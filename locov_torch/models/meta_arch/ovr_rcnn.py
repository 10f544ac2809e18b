"""OvrRCNN: the STT-stage detector (Faster R-CNN C4 with an
embedding-based zero-shot classifier), inference.

Counterpart of ``locov_tpu/models/meta_arch/ovr_rcnn.py``: backbone ->
RPN (PRE_NMS 6000 -> NMS -> 1000) -> ROIAlign + res5 -> embedding
classifier -> fast_rcnn_inference -> rescale to the original image
size. Static padded batches throughout. Each stage of ``inference``
runs in a ``torch.profiler.record_function`` range named
``OvrRCNN.<stage>``, so a profile of a batch splits it by stage.
Training comes with the next slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...structures import boxes as box_ops
from ...structures.batches import DetectionBatch, Detections, ImageBatch
from ...utils.device import resolve_device
from .. import register_meta_arch
from ..box_predictor import BoxPredictorConfig, fast_rcnn_inference_batched
from ..resnet import ResNetC4
from ..roi_heads import Res5ROIHeads, ROIHeadsConfig
from ..rpn import RPNConfig, RPNHead, generate_cell_anchors, grid_anchors, \
    select_proposals


def normalize_and_zero_pad(images: ImageBatch, pixel_mean, pixel_std,
                           dtype: torch.dtype) -> torch.Tensor:
    """(x - mean) / std, with the padding region forced to ZERO after
    normalization (d2's ImageList pads after normalizing, so every conv
    sees 0 there, not -mean/std)."""
    img = images.image
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=img.device)
    x = (img - mean) / std
    h = torch.arange(x.shape[1], dtype=torch.int32, device=img.device)
    w = torch.arange(x.shape[2], dtype=torch.int32, device=img.device)
    valid = ((h[None, :, None] < images.hw[:, 0, None, None]) &
             (w[None, None, :] < images.hw[:, 1, None, None]))
    x = torch.where(valid[..., None], x, torch.zeros((), device=img.device))
    return x.to(dtype)


def _require_proposals(batch: DetectionBatch):
    """PrecomputedProposals path: the batch must carry proposals."""
    if batch.proposals is None:
        raise ValueError(
            "MODEL.PROPOSAL_GENERATOR.NAME='PrecomputedProposals' needs "
            "precomputed proposals in the batch, or switch back to "
            "MODEL.PROPOSAL_GENERATOR.NAME='RPN'.")
    return batch.proposals


@register_meta_arch("OvrRCNN")
class OvrRCNN(nn.Module):
    """Submodules carry the Flax scope names: ``backbone``,
    ``rpn_head``, ``roi_heads``."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, pixel_mean: tuple, pixel_std: tuple,
                 rpn_cfg: RPNConfig, rcfg: ROIHeadsConfig,
                 pcfg: BoxPredictorConfig,
                 compute_dtype: torch.dtype = torch.float32,
                 use_rpn: bool = True, device=None):
        super().__init__()
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.rpn_cfg, self.rcfg, self.pcfg = rpn_cfg, rcfg, pcfg
        self.compute_dtype = compute_dtype
        self.use_rpn = use_rpn
        self.backbone = ResNetC4(
            depth=depth, out_features=("res4",), num_groups=num_groups,
            width_per_group=width_per_group,
            stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype)
        if use_rpn:
            self.rpn_head = RPNHead(
                in_channels=res2_out_channels * 4,
                num_anchors=len(rpn_cfg.sizes) * len(rpn_cfg.aspect_ratios),
                conv_dim=res2_out_channels * 4, compute_dtype=compute_dtype)
        self.roi_heads = Res5ROIHeads(
            rcfg, pcfg, stride_in_1x1=stride_in_1x1,
            res2_out_channels=res2_out_channels, num_groups=num_groups,
            width_per_group=width_per_group, compute_dtype=compute_dtype)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
            else torch.float32
        return cls(
            depth=cfg.MODEL.RESNETS.DEPTH,
            num_groups=cfg.MODEL.RESNETS.NUM_GROUPS,
            width_per_group=cfg.MODEL.RESNETS.WIDTH_PER_GROUP,
            stem_out_channels=cfg.MODEL.RESNETS.STEM_OUT_CHANNELS,
            res2_out_channels=cfg.MODEL.RESNETS.RES2_OUT_CHANNELS,
            stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            rpn_cfg=RPNConfig.from_cfg(cfg),
            rcfg=ROIHeadsConfig.from_cfg(cfg),
            pcfg=BoxPredictorConfig.from_cfg(cfg),
            compute_dtype=dtype,
            use_rpn=(cfg.MODEL.PROPOSAL_GENERATOR.NAME
                     != "PrecomputedProposals"),
            device=device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def preprocess(self, images: ImageBatch) -> torch.Tensor:
        return normalize_and_zero_pad(images, self.pixel_mean,
                                      self.pixel_std, self.compute_dtype)

    def run_rpn(self, features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        logits, deltas = self.rpn_head(features)
        cell = generate_cell_anchors(self.rpn_cfg.sizes,
                                     self.rpn_cfg.aspect_ratios,
                                     device=features.device)
        anchors = grid_anchors(cell, features.shape[1], features.shape[2],
                               self.rpn_cfg.stride, self.rpn_cfg.offset)
        return anchors, logits.float(), deltas.float()

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        """Detections for one padded batch; ``class_emb`` is the
        [K+1, D] class-embedding matrix (last row background)."""
        images = batch.images
        with record_function("OvrRCNN.preprocess"):
            x = self.preprocess(images)
        with record_function("OvrRCNN.backbone"):
            features = self.backbone(x)["res4"]
        if self.use_rpn:
            with record_function("OvrRCNN.rpn_head"):
                anchors, logits, deltas = self.run_rpn(features)
            with record_function("OvrRCNN.select_proposals"):
                proposals = select_proposals(anchors, logits, deltas,
                                             images.hw, self.rpn_cfg)
        else:
            proposals = _require_proposals(batch)
        with record_function("OvrRCNN.roi_features"):
            box_feats = self.roi_heads.roi_features(features,
                                                    proposals.boxes)
        with record_function("OvrRCNN.predict"):
            scores, deltas2 = self.roi_heads.predict(box_feats.float(),
                                                     class_emb.float())
        with record_function("OvrRCNN.fast_rcnn_inference"):
            dets = fast_rcnn_inference_batched(
                scores, deltas2, proposals.boxes, proposals.mask,
                images.hw, self.pcfg)
            # detector_postprocess: rescale to the original image size
            scale = images.orig_hw.float() / images.hw.float()  # [B, 2]
            boxes = box_ops.scale(dets.boxes, scale[:, None, 1],
                                  scale[:, None, 0])
            boxes = box_ops.clip(boxes, (images.orig_hw[:, 0:1],
                                         images.orig_hw[:, 1:2]))
        return dets._replace(boxes=boxes)
