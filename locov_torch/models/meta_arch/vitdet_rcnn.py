"""ViTDetRCNN: ViTDet-B (Li, Mao, Girshick, He, arXiv 2203.16527;
Detectron2 ``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py``)
with LocOV's embedding classifier, at test time.

A plain ViT trunk (``models/vit.py``: windowed and global attention
under the decomposed relative-position bias) -> the simple feature
pyramid P2-P6 (``models/pyramid.py``) -> one RPN head over the five
levels, the top-k of each level, NMS within each level and the top-k over
the levels (``models/rpn.py:select_level_proposals``) -> each proposal
pooled once from its level of P2-P5 (ROIAlignV2, ``ops/roi_align.py:
roi_align_levels``) -> the 4conv1fc box head (``models/box_head.py``) ->
``EmbeddingBoxPredictor`` against the frozen class embeddings ->
``fast_rcnn_inference_batched`` -> the boxes rescaled to the original
image. Each image is normalized, zero-padded outside its valid size and
then to the ``SIMPLE_FPN.SQUARE_PAD`` square canvas. Each stage runs in
a stage range ``ViTDetRCNN.<stage>``; inside ``backbone`` the bias terms
and the attention of each block run in ``window_attention`` or
``global_attention``.

Departures from Detectron2: the mask head is left out (LocOV detects
boxes); the classifier is LocOV's ``EmbeddingBoxPredictor`` (``emb_pred``
to the embedding width, scored against the class embeddings, a
class-agnostic ``bbox_pred``) in place of ``FastRCNNOutputLayers``; the
adaptive ROIAlign takes at most 8 samples a bin a side, as every
ROIAlign of the port does. The RPN head sits at ``rpn_head`` as in the
C4 models. Inference only: ``losses`` raises.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_align import roi_align_levels
from ...structures import boxes as box_ops
from ...structures.batches import DetectionBatch, Detections, ImageBatch
from ...utils.device import resolve_device
from ...utils.trace import stage
from .. import register_meta_arch
from ..box_head import FastRCNNConvFCHead, assign_boxes_to_levels
from ..box_predictor import (BoxPredictorConfig, EmbeddingBoxPredictor,
                             fast_rcnn_inference_batched)
from ..pyramid import SimpleFeaturePyramid, level_names, level_sides
from ..rpn import (PyramidRPNConfig, PyramidRPNHead, grid_anchors,
                   level_cell_anchors)
from ..rpn import select_level_proposals as select_proposals
from ..vit import ViT
from .ovr_rcnn import normalize_and_zero_pad

NAME = "ViTDetRCNN"


def _stage(name: str):
    return stage(NAME, name)


class BoxHeads(nn.Module):
    """``box_head`` and ``box_predictor``, under Detectron2's
    ``roi_heads`` name."""

    def __init__(self, box_head: FastRCNNConvFCHead,
                 box_predictor: EmbeddingBoxPredictor):
        super().__init__()
        self.box_head, self.box_predictor = box_head, box_predictor


@register_meta_arch(NAME)
class ViTDetRCNN(nn.Module):
    def __init__(self, vit: dict, fpn: dict, rpn_cfg: PyramidRPNConfig,
                 rpn_features: List[str], roi_features: List[str],
                 head: dict, pcfg: BoxPredictorConfig, pooled: int,
                 sampling_ratio: int, aspect_ratios: tuple,
                 anchor_offset: float, rpn_convs: int, pixel_mean: tuple,
                 pixel_std: tuple, square_pad: int,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.square_pad, self.compute_dtype = square_pad, compute_dtype
        self.rpn_cfg, self.pcfg = rpn_cfg, pcfg
        self.pooled, self.sampling_ratio = pooled, sampling_ratio
        self.anchor_offset = anchor_offset
        self.rpn_features, self.pool_levels = rpn_features, roi_features
        self.backbone = SimpleFeaturePyramid(
            ViT(img_size=square_pad, compute_dtype=compute_dtype,
                prefix=NAME, **vit),
            in_dim=vit["embed_dim"], patch_size=vit["patch_size"],
            compute_dtype=compute_dtype, **fpn)
        a = len(aspect_ratios) * len(rpn_cfg.level_anchor_sizes[0])
        self.rpn_head = PyramidRPNHead(fpn["out_channels"], a, rpn_convs,
                                       compute_dtype)
        box_head = FastRCNNConvFCHead(fpn["out_channels"], pooled,
                                      compute_dtype=compute_dtype, **head)
        self.roi_heads = BoxHeads(
            box_head, EmbeddingBoxPredictor(box_head.out_dim, pcfg))
        # every level's cell anchors, kept on the device (no host copy a
        # call); not in the state dict
        self.register_buffer(
            "cell_anchors",
            level_cell_anchors(rpn_cfg.level_anchor_sizes, aspect_ratios),
            persistent=False)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
            else torch.float32
        v, f = cfg.MODEL.VIT, cfg.MODEL.SIMPLE_FPN
        h = cfg.MODEL.ROI_BOX_HEAD
        names = level_names(v.PATCH_SIZE, f.SCALE_FACTORS)
        sides = level_sides(f.SQUARE_PAD // v.PATCH_SIZE, f.SCALE_FACTORS)
        side_of = dict(zip(names, sides))
        rpn_features = list(cfg.MODEL.RPN.IN_FEATURES)
        roi_features = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        for feat in rpn_features + roi_features:
            if feat not in side_of:
                raise ValueError(f"ViTDetRCNN: no level {feat!r}; the "
                                 f"pyramid gives {names}")
        strides = [2 ** int(x[1:]) for x in rpn_features]
        rpn_cfg = PyramidRPNConfig.from_cfg(
            cfg, strides, [side_of[x] for x in rpn_features])
        conv_dims = list(cfg.MODEL.RPN.CONV_DIMS)
        if any(d != -1 for d in conv_dims):
            raise ValueError("ViTDetRCNN: RPN.CONV_DIMS takes -1 entries")
        return cls(
            vit=dict(patch_size=v.PATCH_SIZE, embed_dim=v.EMBED_DIM,
                     depth=v.DEPTH, num_heads=v.NUM_HEADS,
                     mlp_ratio=v.MLP_RATIO, window_size=v.WINDOW_SIZE,
                     window_block_indexes=list(v.WINDOW_BLOCK_INDEXES),
                     pretrain_img_size=v.PRETRAIN_IMG_SIZE),
            fpn=dict(out_channels=f.OUT_CHANNELS,
                     scale_factors=list(f.SCALE_FACTORS)),
            rpn_cfg=rpn_cfg, rpn_features=rpn_features,
            roi_features=roi_features,
            head=dict(num_conv=h.NUM_CONV, conv_dim=h.CONV_DIM,
                      num_fc=h.NUM_FC, fc_dim=h.FC_DIM),
            pcfg=BoxPredictorConfig.from_cfg(cfg),
            pooled=h.POOLER_RESOLUTION,
            sampling_ratio=h.POOLER_SAMPLING_RATIO,
            aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            anchor_offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
            rpn_convs=len(conv_dims),
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            square_pad=f.SQUARE_PAD, compute_dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def preprocess(self, images: ImageBatch) -> torch.Tensor:
        """Normalized, zero outside each image's valid size, zero-padded
        to the square canvas: [B, S, S, 3] NHWC in the compute dtype."""
        x = normalize_and_zero_pad(images, self.pixel_mean, self.pixel_std,
                                   self.compute_dtype)
        ph, pw = self.square_pad - x.shape[1], self.square_pad - x.shape[2]
        if ph < 0 or pw < 0:
            raise ValueError(f"ViTDetRCNN: a canvas of {tuple(x.shape[1:3])}"
                             f" is larger than SQUARE_PAD {self.square_pad}")
        return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x

    def levels(self, images: ImageBatch) -> Dict[str, torch.Tensor]:
        with _stage("preprocess"):
            x = self.preprocess(images)
        with _stage("backbone"):
            feat = self.backbone.net(x)
        with _stage("pyramid"):
            return self.backbone.levels(feat)

    def run_rpn(self, levels: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Anchors [N_a, 4], logits [B, N_a] and deltas [B, N_a, 4] over
        the RPN's levels, finest first."""
        anchors, logits, deltas = [], [], []
        for i, (name, stride) in enumerate(zip(self.rpn_features,
                                               self.rpn_cfg.strides)):
            f = levels[name]
            lg, dl = self.rpn_head(f)
            anchors.append(grid_anchors(self.cell_anchors[i], f.shape[1],
                                        f.shape[2], stride,
                                        self.anchor_offset))
            logits.append(lg.float())
            deltas.append(dl.float())
        return torch.cat(anchors), torch.cat(logits, 1), torch.cat(deltas, 1)

    def roi_features(self, levels: Dict[str, torch.Tensor],
                     boxes: torch.Tensor) -> torch.Tensor:
        """Each box pooled from its level of the ROI heads' levels:
        [B, N, P, P, C]."""
        ks = [int(x[1:]) for x in self.pool_levels]
        lvl = assign_boxes_to_levels(boxes, ks[0], ks[-1])
        return roi_align_levels([levels[x] for x in self.pool_levels],
                                boxes, lvl, [2.0 ** -k for k in ks],
                                self.pooled, self.sampling_ratio)

    def losses(self, *args, **kwargs):
        raise NotImplementedError(
            "ViTDetRCNN runs inference only: no training path (RPN and "
            "box losses over the pyramid) is written yet")

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        """Detections for one padded batch; ``class_emb`` is the
        [K+1, D] class-embedding matrix (last row background)."""
        images = batch.images
        levels = self.levels(images)
        with _stage("rpn_head"):
            anchors, logits, deltas = self.run_rpn(levels)
        with _stage("select_proposals"):
            proposals = select_proposals(anchors, logits, deltas, images.hw,
                                         self.rpn_cfg)
        with _stage("roi_features"):
            pooled = self.roi_features(levels, proposals.boxes)
        with _stage("box_head"):
            x = self.roi_heads.box_head(pooled)
        with _stage("predict"):
            scores, deltas2 = self.roi_heads.box_predictor(
                x.float(), class_emb.float())
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


__all__ = ["ViTDetRCNN", "select_proposals"]
