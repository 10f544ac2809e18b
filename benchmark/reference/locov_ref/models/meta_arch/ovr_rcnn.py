"""OvrRCNN: the STT-stage detector (Faster R-CNN C4 with an
embedding-based zero-shot classifier), training losses and inference.

Counterpart of ``locov_tpu/models/meta_arch/ovr_rcnn.py``. Training
(``losses``): backbone -> RPN head -> RPN losses; proposals (PRE_NMS
12000 -> NMS -> 2000, no gradient) -> gt appended, matched and sampled
-> ROIAlign + res5 -> embedding classifier -> FastRCNN losses.
Inference: backbone -> RPN (6000 -> NMS -> 1000) -> ROIAlign + res5 ->
embedding classifier -> fast_rcnn_inference -> rescale to the original
image size. Static padded batches throughout. Each stage runs in a
``torch.profiler.record_function`` range named ``OvrRCNN.<stage>``, so
a profile splits a step or a batch by stage.

``TPU.INT8_EVAL`` (inference only) runs the trunk's res2 .. res4 and the
ROI head's res5 in int8 under ``TPU.INT8_SCHEME``: "dynamic" scales, or
"static" ones that ``calibrate_int8`` records over a few batches first
(``models/resnet.py``, ``models/roi_heads.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...structures import boxes as box_ops
from ...structures.batches import DetectionBatch, Detections, ImageBatch
from ...utils.device import is_amax_key
from ...utils.device import resolve_device
from .. import register_meta_arch
from ..box_predictor import BoxPredictorConfig, fast_rcnn_inference_batched
from ..resnet import ResNetC4
from ..roi_heads import (Res5ROIHeads, ROIHeadsConfig,
                         label_and_sample_proposals, roi_heads_losses)
from ..rpn import (RPNConfig, RPNHead, generate_cell_anchors, grid_anchors,
                   rpn_losses, select_proposals)


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


def detections_from_scores(scores: torch.Tensor, deltas: torch.Tensor,
                           proposals, images: ImageBatch,
                           pcfg: BoxPredictorConfig
                           ) -> Dict[str, torch.Tensor]:
    """The box predictor's outputs on the given proposals as the
    inference check reads them: ``probs`` (each proposal's class
    probabilities, the background dropped), ``boxes`` (each proposal's
    refined box in the original image's frame), ``valid`` (the
    proposals' mask) and the detections ``det_boxes`` (original frame),
    ``det_scores``, ``det_classes``, ``det_mask``
    (``fast_rcnn_inference_batched``)."""
    dets = fast_rcnn_inference_batched(scores, deltas, proposals.boxes,
                                       proposals.mask, images.hw, pcfg)
    scale = images.orig_hw.float() / images.hw.float()

    def to_orig(b):
        b = box_ops.scale(b, scale[:, None, 1], scale[:, None, 0])
        return box_ops.clip(b, (images.orig_hw[:, 0:1],
                                images.orig_hw[:, 1:2]))
    boxes = box_ops.apply_deltas(deltas, proposals.boxes,
                                 pcfg.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (images.hw[:, 0:1], images.hw[:, 1:2]))
    return {"probs": torch.softmax(scores, -1)[..., :-1],
            "boxes": to_orig(boxes), "valid": proposals.mask,
            "det_boxes": to_orig(dets.boxes), "det_scores": dets.scores,
            "det_classes": dets.classes, "det_mask": dets.mask}


def detector_kwargs(cfg) -> dict:
    """The detector's constructor arguments from ``cfg``."""
    dtype = torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" \
        else torch.float32
    return dict(
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
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        remat_backbone=cfg.TPU.REMAT_BACKBONE)


@register_meta_arch("OvrRCNN")
class OvrRCNN(nn.Module):
    """Submodules carry the Flax scope names: ``backbone``,
    ``rpn_head``, ``roi_heads``. ``int8_eval`` and ``int8_scheme``
    (``TPU.INT8_EVAL``, ``TPU.INT8_SCHEME``) set the int8 mode of
    ``inference``; under the static scheme the model holds the
    calibrated max-abs buffers (zero until ``calibrate_int8``)."""

    def __init__(self, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, pixel_mean: tuple, pixel_std: tuple,
                 rpn_cfg: RPNConfig, rcfg: ROIHeadsConfig,
                 pcfg: BoxPredictorConfig,
                 compute_dtype: torch.dtype = torch.float32,
                 use_rpn: bool = True, freeze_at: int = 0,
                 remat_backbone: bool = False, emb_pred: bool = True,
                 int8_eval: bool = False, int8_scheme: str = "dynamic",
                 device=None):
        super().__init__()
        if int8_scheme not in ("dynamic", "static"):
            raise ValueError(f"TPU.INT8_SCHEME {int8_scheme!r}: 'dynamic' "
                             f"or 'static'")
        self.int8_eval, self.int8_scheme = int8_eval, int8_scheme
        int8_static = int8_eval and int8_scheme == "static"
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
            stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype,
            freeze_at=freeze_at, remat=remat_backbone,
            int8_amax=int8_static)
        if use_rpn:
            self.rpn_head = RPNHead(
                in_channels=res2_out_channels * 4,
                num_anchors=len(rpn_cfg.sizes) * len(rpn_cfg.aspect_ratios),
                conv_dim=res2_out_channels * 4, compute_dtype=compute_dtype)
        self.roi_heads = Res5ROIHeads(
            rcfg, pcfg, stride_in_1x1=stride_in_1x1,
            res2_out_channels=res2_out_channels, num_groups=num_groups,
            width_per_group=width_per_group, compute_dtype=compute_dtype,
            emb_pred=emb_pred, int8_static=int8_static)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        return cls(**detector_kwargs(cfg), int8_eval=cfg.TPU.INT8_EVAL,
                   int8_scheme=cfg.TPU.INT8_SCHEME, device=device)

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

    def losses(self, batch: DetectionBatch, class_emb: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Dict[str, Tuple[torch.Tensor,
                                                  torch.Tensor]]] = None,
               deterministic: bool = True, global_batch=None
               ) -> Dict[str, torch.Tensor]:
        """The training loss dict of one padded batch with ``batch.gt``;
        ``class_emb`` is the [K+1, D] class-embedding matrix (last row
        background). The RPN and ROI samplers rank candidates by uniform
        draws: ``uniforms["rpn"]`` and ``uniforms["roi"]`` are (u_pos,
        u_neg) pairs of [B, N_anchors] and [B, N_proposals + M] where
        given, else they are drawn from ``generator`` (a generator on
        the model's device). The detector has no dropout:
        ``deterministic`` is accepted for the training step's sake.
        ``global_batch`` (``parallel/mesh.py:GlobalBatch``, the global
        contrastive scope) normalises the FastRCNN losses over every
        rank's samples."""
        uniforms = dict(uniforms or {})
        images, gt = batch.images, batch.gt

        def draw(key, n):
            if key not in uniforms:
                shape = (gt.boxes.shape[0], n)
                uniforms[key] = tuple(
                    torch.rand(shape, generator=generator,
                               device=gt.boxes.device) for _ in range(2))
            return uniforms[key]

        with record_function("OvrRCNN.preprocess"):
            x = self.preprocess(images)
        with record_function("OvrRCNN.backbone"):
            features = self.backbone(x)["res4"]
        losses = {}
        if self.use_rpn:
            with record_function("OvrRCNN.rpn_head"):
                anchors, logits, deltas = self.run_rpn(features)
            with record_function("OvrRCNN.rpn_losses"):
                losses.update(rpn_losses(anchors, logits, deltas, gt,
                                         self.rpn_cfg,
                                         *draw("rpn", anchors.shape[0])))
            # proposals are fixed inputs to the second stage (d2 decodes
            # them under no_grad)
            with record_function("OvrRCNN.select_proposals"), \
                    torch.no_grad():
                proposals = select_proposals(
                    anchors, logits.detach(), deltas.detach(), images.hw,
                    self.rpn_cfg, training=True)
        else:
            proposals = _require_proposals(batch)
        with record_function("OvrRCNN.label_and_sample"):
            n = proposals.boxes.shape[1] + (
                gt.boxes.shape[1] if self.rcfg.proposal_append_gt else 0)
            sampled = label_and_sample_proposals(proposals, gt, self.rcfg,
                                                 *draw("roi", n))
        with record_function("OvrRCNN.roi_features"):
            box_feats = self.roi_heads.roi_features(features, sampled.boxes)
        with record_function("OvrRCNN.predict"):
            scores, deltas2 = self.roi_heads.predict(box_feats.float(),
                                                     class_emb.float())
        with record_function("OvrRCNN.roi_heads_losses"):
            losses.update(roi_heads_losses(scores, deltas2, sampled,
                                           self.pcfg, global_batch))
        return losses

    def _int8_mode(self):
        return self.int8_scheme if self.int8_eval else False

    @property
    def couples_ranks(self) -> bool:
        """Whether the ranks of ``torch.distributed`` must run
        ``inference`` in lockstep: the dynamic int8 scheme all-reduces
        each activation max-abs over them (``ops/int8_conv.py:
        global_max_abs``), so every rank makes the same collective calls
        (``idle_pass``)."""
        return self._int8_mode() == "dynamic"

    def amax_buffers(self) -> Dict[str, torch.Tensor]:
        """The static int8 scheme's calibrated max-abs buffers by
        ``state_dict`` name (none unless the model was built for it)."""
        return {k: v for k, v in self.named_buffers() if is_amax_key(k)}

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        """Detections for one padded batch; ``class_emb`` is the
        [K+1, D] class-embedding matrix (last row background)."""
        return self._inference(batch, class_emb, self._int8_mode())

    @torch.inference_mode()
    def idle_pass(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> None:
        """For a rank whose shard is done while another rank still runs
        ``inference`` under ``couples_ranks``: ``batch`` (any batch of
        the run's shapes) through the same collective calls, each
        max-abs contributing 0 (the "dynamic_idle" mode), so that no
        other rank's scale moves; its detections are dropped."""
        if not self.couples_ranks:
            raise ValueError("idle_pass: the model couples no ranks "
                             "(TPU.INT8_EVAL with TPU.INT8_SCHEME dynamic)")
        self._inference(batch, class_emb, "dynamic_idle")

    @torch.no_grad()
    def calibrate_int8(self, batch: DetectionBatch,
                       class_emb: torch.Tensor) -> Detections:
        """One calibration pass of the static int8 scheme: the inference
        with each calibrated max-abs first raised to what this batch shows
        and then used as the scale (after one pass from zero, the dynamic
        scales of the batch). The buffers are written in place under
        ``no_grad``: one written under ``inference_mode`` would become an
        inference tensor, which export and later in-place updates refuse.
        Run it on a few representative batches before ``inference``."""
        if not self.amax_buffers():
            raise ValueError("calibrate_int8: the model was not built for "
                             "the static int8 scheme (TPU.INT8_EVAL True, "
                             "TPU.INT8_SCHEME static)")
        return self._inference(batch, class_emb, "calibrate")

    @torch.inference_mode()
    def detect_from_proposals(self, batch: DetectionBatch,
                              class_emb: torch.Tensor,
                              proposals) -> Dict[str, torch.Tensor]:
        """The detector from the given proposals (``ProposalBatch``, the
        program's), as ``_inference`` computes it, for the inference
        check (``benchmark/reference/steps.py:detect``): ``logits`` (the
        RPN's objectness [B, N_a]) and ``detections_from_scores``'s keys.
        Every meta-architecture that an inference cell runs has it."""
        images = batch.images
        x = self.preprocess(images)
        features = self.backbone(x)["res4"]
        _, logits, _ = self.run_rpn(features)
        feats = self.roi_heads.roi_features(features, proposals.boxes)
        scores, deltas = self.roi_heads.predict(feats.float(),
                                                class_emb.float())
        return {"logits": logits, **detections_from_scores(
            scores, deltas, proposals, images, self.pcfg)}

    def _inference(self, batch: DetectionBatch, class_emb: torch.Tensor,
                   int8) -> Detections:
        images = batch.images
        with record_function("OvrRCNN.preprocess"):
            x = self.preprocess(images)
        with record_function("OvrRCNN.backbone"):
            features = self.backbone(x, int8=int8)["res4"]
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
                                                    proposals.boxes,
                                                    int8=int8)
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
