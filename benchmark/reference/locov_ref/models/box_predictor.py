"""Embedding-based FastRCNN output layers + batched inference.

Counterpart of ``locov_tpu/models/box_predictor.py``: region features
project to the class-embedding space through ``emb_pred`` and are
scored by a dot product against a frozen class-name embedding matrix,
which is a forward input. Also d2's FastRCNN losses over a sampled
batch, and the static-shape ``fast_rcnn_inference``: softmax, drop
background, score threshold, at most 4096 candidates, class-masked
NMS, top-k.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..ops import nms as nms_ops
from ..ops.losses import (giou, normalize_vec, smooth_l1,
                          softmax_cross_entropy, standardize_vec)
from ..structures import boxes as box_ops
from ..structures.batches import Detections


class BoxPredictorConfig(NamedTuple):
    """The JAX package's ``BoxPredictorConfig``: the embedding
    predictor's fields, the predictor's ``name`` (``ROI_BOX_HEAD.NAME``)
    and the grounding predictor's options (``MMSS_HEAD.GROUNDING``'s
    metric, alignment and temperature). The number of classes is that
    of the ``class_emb`` rows."""
    emb_dim: int
    embedding_based: bool
    normalize_emb: bool
    standardize_emb: bool
    detach_cls_predictor: bool
    bbox_reg_weights: tuple
    smooth_l1_beta: float
    box_reg_loss_type: str
    box_reg_loss_weight: float
    test_score_thresh: float
    test_nms_thresh: float
    test_topk_per_image: int
    # static cap on (box, class) candidates entering NMS at inference
    test_nms_candidates: int = 4096
    name: str = ""
    grounding_local_metric: str = "dot"
    grounding_alignment: str = "softmax"
    grounding_temperature: float = 10.0

    @classmethod
    def from_cfg(cls, cfg):
        g = cfg.MODEL.MMSS_HEAD.GROUNDING
        return cls(
            name=cfg.MODEL.ROI_BOX_HEAD.NAME,
            grounding_local_metric=g.LOCAL_METRIC,
            grounding_alignment=g.ALIGNMENT,
            grounding_temperature=g.ALIGNMENT_TEMPERATURE,
            emb_dim=cfg.MODEL.ROI_BOX_HEAD.EMB_DIM,
            embedding_based=cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED,
            normalize_emb=cfg.MODEL.ROI_BOX_HEAD.NORMALIZE_EMB_PRED,
            standardize_emb=cfg.MODEL.ROI_BOX_HEAD.STANDARDIZE_EMB_PRED,
            detach_cls_predictor=cfg.MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR,
            bbox_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            smooth_l1_beta=cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA,
            box_reg_loss_type=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
            box_reg_loss_weight=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT,
            test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE)


class EmbeddingBoxPredictor(nn.Module):
    """emb_pred + class-agnostic bbox_pred. Classification runs against
    the runtime ``class_emb`` matrix ([K+1, emb_dim], last row the
    background). With ``detach_cls_predictor`` no gradient flows
    through the classification scores. ``emb_pred=False`` builds no
    ``emb_pred``: the caller passes the embeddings as ``emb_override``
    (the image-caption stage's shared ``v2l_projection``)."""

    def __init__(self, in_features: int, pcfg: BoxPredictorConfig,
                 emb_pred: bool = True):
        super().__init__()
        self.pcfg = pcfg
        self.bbox_pred = nn.Linear(in_features, 4)
        self.emb_pred = nn.Linear(in_features, pcfg.emb_dim) \
            if pcfg.embedding_based and emb_pred else None

    def forward(self, x: torch.Tensor, class_emb: torch.Tensor,
                emb_override: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., C_in] -> (scores [..., K+1], deltas [..., 4]).
        ``emb_override``: embeddings projected elsewhere, used in place
        of ``emb_pred``'s (detached under ``detach_cls_predictor``)."""
        deltas = self.bbox_pred(x)
        detach = self.pcfg.detach_cls_predictor
        if emb_override is None and self.emb_pred is None:
            # without emb_pred the features are scored as they are
            emb = x.detach() if detach else x
        else:
            emb = emb_override if emb_override is not None else \
                self.emb_pred(x.detach() if detach else x)
            emb = emb.detach() if detach else emb
            if self.pcfg.normalize_emb:
                emb = normalize_vec(emb)
            if self.pcfg.standardize_emb:
                emb = standardize_vec(emb)
        cemb = class_emb
        if self.pcfg.normalize_emb:
            cemb = normalize_vec(cemb)
        if self.pcfg.standardize_emb:
            cemb = standardize_vec(cemb)
        scores = emb @ cemb.T  # frozen linear classifier, bias 0
        return (scores.detach() if detach else scores), deltas


def fast_rcnn_losses(scores: torch.Tensor, deltas: torch.Tensor,
                     proposal_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_boxes: torch.Tensor, valid: torch.Tensor,
                     pcfg: BoxPredictorConfig, global_batch=None
                     ) -> Dict[str, torch.Tensor]:
    """d2 FastRCNNOutputLayers.losses over a flattened sampled batch.

    scores [R, K+1]; deltas [R, 4] (class-agnostic); proposal_boxes,
    gt_boxes [R, 4]; gt_classes [R] (K = background); valid [R]. loss_cls
    is the mean cross entropy over the valid samples; loss_box_reg the
    sum over foreground samples divided by the number of valid ones
    (d2 divides by gt_classes.numel()). With ``global_batch``
    (``parallel/mesh.py:GlobalBatch``) both count the valid samples of
    every rank: this rank's share of the global batch's means."""
    labels = torch.where(valid, gt_classes, torch.full_like(gt_classes, -1))

    def per_valid(total):
        if global_batch is None:
            return total / valid.sum().clamp(min=1)
        return global_batch.share(total, valid.sum())
    loss_cls = per_valid(softmax_cross_entropy(scores, labels, -1)[0].sum())
    num_classes = scores.shape[-1] - 1
    is_fg = valid & (gt_classes >= 0) & (gt_classes < num_classes)
    if pcfg.box_reg_loss_type == "smooth_l1":
        gt_deltas = box_ops.get_deltas(proposal_boxes, gt_boxes,
                                       pcfg.bbox_reg_weights)
        per = smooth_l1(deltas, gt_deltas, pcfg.smooth_l1_beta).sum(-1)
    elif pcfg.box_reg_loss_type == "giou":
        pred = box_ops.apply_deltas(deltas, proposal_boxes,
                                    pcfg.bbox_reg_weights)
        per = giou(pred, gt_boxes)
    else:
        raise NotImplementedError(pcfg.box_reg_loss_type)
    loss_box = per_valid(torch.where(is_fg, per,
                                     torch.zeros_like(per)).sum())
    if pcfg.detach_cls_predictor:
        loss_cls = 0.0 * loss_cls
    return {"loss_cls": loss_cls,
            "loss_box_reg": loss_box * pcfg.box_reg_loss_weight}


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
