"""ViTDetRCNN, the plain reference's copy: ViTDet-B (arXiv 2203.16527;
Detectron2 ``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py``)
with LocOV's embedding classifier, at test time, in float32 (or the
configuration's dtype for the check's plain low-precision run).

The ViT trunk (``models/vit.py``: windowed blocks inside zero-padded
windows, global blocks over the whole grid, the decomposed
relative-position bias in every block, the scores materialized one
image's map or windows at a time), the simple feature pyramid P2-P6 and
the 4conv1fc head (``models/pyramid.py``), an RPN head of two 3 x 3
convs shared by the levels, the top-k of each level, NMS within each
level and the top-k over the levels (``select_proposals``), each
proposal pooled from its level by ``roi_align_batched`` on that level's
boxes alone, the embedding classifier and ``fast_rcnn_inference_
batched``. Every product is ``F.conv2d``, ``F.linear`` or
``torch.matmul`` with TF32 off (``ops/matmul.py:cublas_f32``,
``ops/conv.py:cudnn_f32``). Imports nothing of the program.

Departures from Detectron2, as in the program: no mask head; LocOV's
``EmbeddingBoxPredictor`` in place of ``FastRCNNOutputLayers``; the
adaptive ROIAlign takes at most 8 samples a bin a side; the RPN head at
``rpn_head``; the transposed convolutions written as per-pixel products
and a pixel shuffle (the same arithmetic); inference only.
"""
from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops import nms as nms_ops
from ...ops.conv import cudnn_f32
from ...ops.matmul import cublas_f32
from ...ops.roi_align import roi_align_batched
from ...structures import boxes as box_ops
from ...structures.batches import (DetectionBatch, Detections, ImageBatch,
                                   ProposalBatch)
from ...utils.device import resolve_device
from .. import register_meta_arch
from ..box_predictor import BoxPredictorConfig, EmbeddingBoxPredictor
from ..pyramid import FastRCNNConvFCHead, SimpleFeaturePyramid
from ..rpn import RPNConfig, generate_cell_anchors, grid_anchors
from ..vit import ViT, level_names
from .ovr_rcnn import detections_from_scores, normalize_and_zero_pad

NAME = "ViTDetRCNN"


def _stage(name: str):
    return record_function(f"{NAME}.{name}")


class LevelRPNConfig(NamedTuple):
    """The RPN over the pyramid's levels: the single-level fields, and
    per level its anchor sizes, stride and anchors on the canvas."""
    rpn: RPNConfig
    sizes: Tuple[tuple, ...]
    strides: Tuple[int, ...]
    level_sizes: Tuple[int, ...]


def select_proposals(anchors: torch.Tensor, logits: torch.Tensor,
                     deltas: torch.Tensor, image_hw: torch.Tensor,
                     rpn_cfg: LevelRPNConfig,
                     training: bool = False) -> ProposalBatch:
    """Detectron2's ``find_top_rpn_proposals``: per level the top
    ``PRE_NMS_TOPK`` by logit; the boxes decoded, clipped, empty or
    non-finite ones dropped; NMS at ``NMS_THRESH`` within each level
    (the level as the class); the top ``POST_NMS_TOPK`` over the levels
    by logit. Levels flattened finest first."""
    r = rpn_cfg.rpn
    pre = r.pre_nms_topk_train if training else r.pre_nms_topk_test
    post = r.post_nms_topk_train if training else r.post_nms_topk_test
    scores, idx, lvl, off = [], [], [], 0
    for i, n in enumerate(rpn_cfg.level_sizes):
        s, j = nms_ops.top_k(logits[:, off:off + n], min(pre, n))
        scores.append(s)
        idx.append(j + off)
        lvl.append(torch.full_like(j, i, dtype=torch.int32))
        off += n
    top_scores = torch.cat(scores, 1)
    idx, level = torch.cat(idx, 1), torch.cat(lvl, 1)
    sel = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.apply_deltas(sel, anchors[idx], r.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (image_hw[:, 0:1], image_hw[:, 1:2]))
    valid = box_ops.nonempty(boxes, r.min_size)
    valid &= torch.isfinite(top_scores) & torch.isfinite(boxes).all(dim=-1)
    post = min(post, top_scores.shape[1])
    keep = nms_ops.batched_nms_mask_batched(boxes, top_scores, level, valid,
                                            r.nms_thresh, stop_after=post)
    low = torch.finfo(top_scores.dtype).min
    kept = torch.where(keep, top_scores, torch.full_like(top_scores, low))
    top, k = nms_ops.top_k(kept, post)
    return ProposalBatch(
        boxes=torch.gather(boxes, 1, k[..., None].expand(-1, -1, 4)),
        objectness=torch.gather(top_scores, 1, k), mask=top > low)


def box_levels(boxes: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Detectron2's ``assign_boxes_to_levels``: floor(4 + log2(sqrt(area)
    / 224 + 1e-8)) clamped to [lo, hi], less lo."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    return (k.clamp(lo, hi) - lo).long()


class RPNHead(nn.Module):
    """``conv.conv<i>`` (3 x 3, ReLU) then the objectness and delta
    1 x 1 convs, one head for every level."""

    def __init__(self, c: int, anchors: int, convs: int):
        super().__init__()
        self.conv = nn.Sequential(OrderedDict(
            (f"conv{i}", nn.Conv2d(c, c, 3, padding=1))
            for i in range(convs)))
        self.objectness_logits = nn.Conv2d(c, anchors, 1)
        self.anchor_deltas = nn.Conv2d(c, anchors * 4, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        def run(conv, t):
            y = F.conv2d(t.permute(0, 3, 1, 2).to(dtype),
                         conv.weight.to(dtype), conv.bias.to(dtype),
                         padding=conv.padding)
            return y.permute(0, 2, 3, 1)
        t = x
        for conv in self.conv:
            t = F.relu(run(conv, t))
        b = x.shape[0]
        return (run(self.objectness_logits, t).reshape(b, -1),
                run(self.anchor_deltas, t).reshape(b, -1, 4))


class BoxHeads(nn.Module):
    def __init__(self, box_head, box_predictor):
        super().__init__()
        self.box_head, self.box_predictor = box_head, box_predictor


@register_meta_arch(NAME)
class ViTDetRCNN(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        v, f = cfg.MODEL.VIT, cfg.MODEL.SIMPLE_FPN
        h, a = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ANCHOR_GENERATOR
        self.dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
            else torch.float32
        self.pixel_mean = tuple(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.MODEL.PIXEL_STD)
        self.square_pad = f.SQUARE_PAD
        self.pooled, self.ratio = h.POOLER_RESOLUTION, h.POOLER_SAMPLING_RATIO
        self.offset = a.OFFSET
        self.rpn_features = list(cfg.MODEL.RPN.IN_FEATURES)
        self.roi_levels = [int(x[1:]) for x in cfg.MODEL.ROI_HEADS.IN_FEATURES]
        self.pcfg = BoxPredictorConfig.from_cfg(cfg)
        self.backbone = SimpleFeaturePyramid(
            ViT(f.SQUARE_PAD, v.PATCH_SIZE, v.EMBED_DIM, v.DEPTH,
                v.NUM_HEADS, v.MLP_RATIO, v.WINDOW_SIZE,
                list(v.WINDOW_BLOCK_INDEXES), v.PRETRAIN_IMG_SIZE,
                self.dtype),
            v.EMBED_DIM, f.OUT_CHANNELS, list(f.SCALE_FACTORS), v.PATCH_SIZE,
            self.dtype)
        names = level_names(v.PATCH_SIZE, list(f.SCALE_FACTORS))
        grid = f.SQUARE_PAD // v.PATCH_SIZE
        side = {}
        for name in names:
            k = int(name[1:]) - int(round(math.log2(v.PATCH_SIZE)))
            side[name] = grid * 2 ** -k if k <= 0 else -(-grid // 2 ** k)
        sizes = tuple(tuple(s) for s in a.SIZES)
        ratios = tuple(a.ASPECT_RATIOS[0])
        self.rpn_cfg = LevelRPNConfig(
            rpn=RPNConfig.from_cfg(cfg), sizes=sizes,
            strides=tuple(2 ** int(x[1:]) for x in self.rpn_features),
            level_sizes=tuple(int(side[x]) ** 2 * len(s) * len(ratios)
                              for x, s in zip(self.rpn_features, sizes)))
        self.rpn_head = RPNHead(f.OUT_CHANNELS, len(ratios) * len(sizes[0]),
                                len(cfg.MODEL.RPN.CONV_DIMS))
        head = FastRCNNConvFCHead(f.OUT_CHANNELS, self.pooled, h.NUM_CONV,
                                  h.CONV_DIM, h.NUM_FC, h.FC_DIM, self.dtype)
        self.roi_heads = BoxHeads(head,
                                  EmbeddingBoxPredictor(head.out_dim,
                                                        self.pcfg))
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        return cls(cfg, device=device)

    @contextlib.contextmanager
    def _f32(self):
        with cublas_f32(), cudnn_f32(torch.float32):
            yield

    def levels(self, images: ImageBatch) -> Dict[str, torch.Tensor]:
        with _stage("preprocess"):
            x = normalize_and_zero_pad(images, self.pixel_mean,
                                       self.pixel_std, self.dtype)
            s = self.square_pad
            x = F.pad(x, (0, 0, 0, s - x.shape[2], 0, s - x.shape[1]))
        with _stage("backbone"):
            feat = self.backbone.net(x)
        with _stage("pyramid"):
            return self.backbone.levels(feat)

    def run_rpn(self, levels):
        anchors, logits, deltas = [], [], []
        for i, (name, stride) in enumerate(zip(self.rpn_features,
                                               self.rpn_cfg.strides)):
            f = levels[name]
            lg, dl = self.rpn_head(f, self.dtype)
            cell = generate_cell_anchors(self.rpn_cfg.sizes[i],
                                         self.rpn_cfg.rpn.aspect_ratios,
                                         device=f.device)
            anchors.append(grid_anchors(cell, f.shape[1], f.shape[2],
                                        stride, self.offset))
            logits.append(lg.float())
            deltas.append(dl.float())
        return torch.cat(anchors), torch.cat(logits, 1), torch.cat(deltas, 1)

    def box_features(self, levels, boxes: torch.Tensor) -> torch.Tensor:
        """Each box pooled on its level alone: per image and level,
        ``roi_align_batched`` of that level's boxes; then the head."""
        b, n = boxes.shape[:2]
        lo, hi = self.roi_levels[0], self.roi_levels[-1]
        lvl = box_levels(boxes, lo, hi)
        c = levels[f"p{lo}"].shape[-1]
        out = levels[f"p{lo}"].new_zeros((b, n, self.pooled, self.pooled, c))
        for i in range(b):
            for k in range(lo, hi + 1):
                sel = torch.nonzero(lvl[i] == k - lo).flatten()
                if sel.numel():
                    out[i, sel] = roi_align_batched(
                        levels[f"p{k}"][i:i + 1], boxes[i:i + 1, sel].float(),
                        2.0 ** -k, self.pooled, self.ratio)[0]
        return self.roi_heads.box_head(out)

    def losses(self, *args, **kwargs):
        raise NotImplementedError("ViTDetRCNN: inference only")

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        with self._f32():
            images = batch.images
            levels = self.levels(images)
            with _stage("rpn_head"):
                anchors, logits, deltas = self.run_rpn(levels)
            with _stage("select_proposals"):
                proposals = select_proposals(anchors, logits, deltas,
                                             images.hw, self.rpn_cfg)
            scores, deltas2 = self.roi_heads.box_predictor(
                self.box_features(levels, proposals.boxes).float(),
                class_emb.float())
            d = detections_from_scores(scores, deltas2, proposals, images,
                                       self.pcfg)
        return Detections(boxes=d["det_boxes"], scores=d["det_scores"],
                          classes=d["det_classes"], mask=d["det_mask"])

    @torch.inference_mode()
    def detect_from_proposals(self, batch: DetectionBatch,
                              class_emb: torch.Tensor,
                              proposals) -> Dict[str, torch.Tensor]:
        """The check's contract (``benchmark/reference/steps.py:detect``):
        this model's levels, RPN logits (levels flattened finest first)
        and heads from the given proposals."""
        with self._f32():
            levels = self.levels(batch.images)
            _, logits, _ = self.run_rpn(levels)
            scores, deltas = self.roi_heads.box_predictor(
                self.box_features(levels, proposals.boxes).float(),
                class_emb.float())
            return {"logits": logits, **detections_from_scores(
                scores, deltas, proposals, batch.images, self.pcfg)}


__all__ = ["ViTDetRCNN", "select_proposals", "LevelRPNConfig"]
