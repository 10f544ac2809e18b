"""Embedding-based FastRCNN output layers + batched inference.

Counterpart of ``locov_tpu/models/box_predictor.py`` (inference part):
region features project to the class-embedding space through
``emb_pred`` and are scored by a dot product against a frozen
class-name embedding matrix, which is a forward input. Also the
static-shape ``fast_rcnn_inference``: softmax, drop background, score
threshold, at most 4096 candidates, class-masked NMS, top-k.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..ops import nms as nms_ops
from ..ops.losses import normalize_vec, standardize_vec
from ..structures import boxes as box_ops
from ..structures.batches import Detections


class BoxPredictorConfig(NamedTuple):
    """The inference fields of the JAX package's ``BoxPredictorConfig``;
    the loss fields come with the training slice. The number of classes
    is that of the ``class_emb`` rows."""
    emb_dim: int
    embedding_based: bool
    normalize_emb: bool
    standardize_emb: bool
    bbox_reg_weights: tuple
    test_score_thresh: float
    test_nms_thresh: float
    test_topk_per_image: int
    # static cap on (box, class) candidates entering NMS at inference
    test_nms_candidates: int = 4096
    name: str = ""

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            name=cfg.MODEL.ROI_BOX_HEAD.NAME,
            emb_dim=cfg.MODEL.ROI_BOX_HEAD.EMB_DIM,
            embedding_based=cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED,
            normalize_emb=cfg.MODEL.ROI_BOX_HEAD.NORMALIZE_EMB_PRED,
            standardize_emb=cfg.MODEL.ROI_BOX_HEAD.STANDARDIZE_EMB_PRED,
            bbox_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE)


class EmbeddingBoxPredictor(nn.Module):
    """emb_pred + class-agnostic bbox_pred. Classification runs against
    the runtime ``class_emb`` matrix ([K+1, emb_dim], last row the
    background)."""

    def __init__(self, in_features: int, pcfg: BoxPredictorConfig):
        super().__init__()
        self.pcfg = pcfg
        self.bbox_pred = nn.Linear(in_features, 4)
        self.emb_pred = nn.Linear(in_features, pcfg.emb_dim) \
            if pcfg.embedding_based else None

    def forward(self, x: torch.Tensor, class_emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., C_in] -> (scores [..., K+1], deltas [..., 4])."""
        deltas = self.bbox_pred(x)
        emb = x  # without emb_pred the features are scored as they are
        if self.emb_pred is not None:
            emb = self.emb_pred(x)
            if self.pcfg.normalize_emb:
                emb = normalize_vec(emb)
            if self.pcfg.standardize_emb:
                emb = standardize_vec(emb)
        cemb = class_emb
        if self.pcfg.normalize_emb:
            cemb = normalize_vec(cemb)
        if self.pcfg.standardize_emb:
            cemb = standardize_vec(cemb)
        return emb @ cemb.T, deltas  # frozen linear classifier, bias 0


def fast_rcnn_inference_batched(scores: torch.Tensor, deltas: torch.Tensor,
                                proposal_boxes: torch.Tensor,
                                proposal_mask: torch.Tensor,
                                image_hw: torch.Tensor,
                                pcfg: BoxPredictorConfig) -> Detections:
    """Static-shape fast_rcnn_inference, batched.

    scores [B, N, K+1] raw logits; deltas [B, N, 4] (class-agnostic);
    proposal_boxes [B, N, 4]. softmax -> drop bg -> score thresh ->
    top 4096 candidates -> per-class NMS (class masking) with
    ``stop_after`` = top-k -> top-k."""
    probs = torch.softmax(scores, dim=-1)[..., :-1]  # [B, N, K]
    b, n, k = probs.shape
    boxes = box_ops.apply_deltas(deltas, proposal_boxes,
                                 pcfg.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (image_hw[:, 0:1], image_hw[:, 1:2]))

    flat_scores = probs.reshape(b, n * k)
    flat_classes = torch.arange(k, dtype=torch.int32,
                                device=scores.device).repeat(b, n)
    flat_boxes = boxes[:, :, None, :].expand(b, n, k, 4).reshape(b, n * k, 4)
    base_valid = proposal_mask & box_ops.nonempty(boxes)
    flat_valid = (flat_scores > pcfg.test_score_thresh) & \
        base_valid.repeat_interleave(k, dim=1)

    n_cand = min(pcfg.test_nms_candidates, n * k)
    cand_scores, cand_idx = nms_ops.top_k(
        torch.where(flat_valid, flat_scores,
                    torch.full_like(flat_scores, -1.0)), n_cand)
    cand_boxes = torch.gather(flat_boxes, 1,
                              cand_idx[..., None].expand(-1, -1, 4))
    cand_classes = torch.gather(flat_classes, 1, cand_idx)
    cand_valid = cand_scores > max(pcfg.test_score_thresh, 0.0)

    keep = nms_ops.batched_nms_mask_batched(
        cand_boxes, cand_scores, cand_classes, cand_valid,
        pcfg.test_nms_thresh, stop_after=pcfg.test_topk_per_image)
    kept = torch.where(keep, cand_scores, torch.full_like(cand_scores, -1.0))
    top_scores, top_idx = nms_ops.top_k(kept, pcfg.test_topk_per_image)
    return Detections(
        boxes=torch.gather(cand_boxes, 1,
                           top_idx[..., None].expand(-1, -1, 4)),
        scores=top_scores,
        classes=torch.gather(cand_classes, 1, top_idx),
        mask=top_scores > 0.0)
