"""The image-caption (LSM) stage's models.

Counterpart of ``locov_tpu/models/meta_arch/mmss_gcnn.py``.
``DistillProposalMMSSRCNN``'s training (``losses``):

- the language backbone embeds the captions;
- the C4 trunk, the RPN and its losses, proposals (no gradient), the
  sampled ROIs through ROIAlign + res5, the embedding box predictor and
  the FastRCNN losses, as in ``OvrRCNN``;
- the grid pass: res5 over the whole res4 map, flattened into masked
  regions with normalised centres, at most ``SPATIAL_DROPOUT`` random
  valid regions an image, through the MMSS heads;
- the box pass: at most ``SPATIAL_DROPOUT`` random valid sampled boxes
  an image, their res5 features and normalised centres, through the
  MMSS heads (keys prefixed "Box "); under ``TPU.FUSED_MMSS_PASSES`` the
  two passes share one call of the heads where their shapes agree;
- the distillation losses between the heads' costs (``kd_loss``,
  ``box_kd_loss``, ``mixbox_kd_loss``).

``DistillOnlyProposalMMSSRCNN`` runs the box pass alone (only
``box_kd_loss``). ``MMSSGridModel`` and ``DistillMMSSGridModel`` (OVR-CNN's
grid pretraining) have no detector: the trunk's res5 (or res4) map as
grid regions, spatial dropout, the MMSS heads and ``kd_loss``.

The random draws are inputs where given (``uniforms``): the RPN and ROI
samplers' (u_pos, u_neg), the grid and box spatial-dropout keys and the
grounding head's draws of each pass; otherwise they, and the dropout
masks, come from ``generator``. Each stage runs in a
stage range (``utils/trace.py:stage``) ``DistillProposalMMSSRCNN.<stage>``
(``MMSSGridModel.<stage>`` for the grid models).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.nms import top_k
from ...ops.roi_align import _div
from ...structures import boxes as box_ops
from ...structures.batches import (CaptionFeatures, DetectionBatch,
                                   Detections, ImageBatch, RegionFeatures)
from ...utils.device import resolve_device
from ...utils.trace import stage, wait
from .. import register_meta_arch
from ..bert import BertConfig, Dense
from ..box_predictor import fast_rcnn_inference_batched
from ..language import LANGUAGE_BACKBONES
from ..mmss import (DISTILL_LOSSES, GroundingConfig, GroundingHead,
                    MLPHead, TransformerHead, TransformerHeadConfig)
from ..resnet import ResNetC4
from ..roi_heads import label_and_sample_proposals, roi_heads_losses
from ..rpn import rpn_losses, select_proposals
from .ovr_rcnn import OvrRCNN, _require_proposals, detector_kwargs

NAME = "DistillProposalMMSSRCNN"
GRID_NAME = "MMSSGridModel"
HEAD_TYPES = ("GroundingHead", "TransformerHead", "MLPHead")


def make_grid_regions(grid_feats: torch.Tensor, image_hw: torch.Tensor,
                      padded_hw: Tuple[int, int]) -> RegionFeatures:
    """A [B, gh, gw, C] feature grid as masked regions with normalised
    (x, y) centres: cell (y, x) is valid where y < ceil(h * gh / H) and
    x < ceil(w * gw / W), and its location is ((x + .5) / gs_w,
    (y + .5) / gs_h)."""
    b, gh, gw, _ = grid_feats.shape
    hpad, wpad = padded_hw
    dev = grid_feats.device
    # correctly rounded division before ceil() (``_div``)
    gs_h = torch.ceil(_div(image_hw[:, 0].float() * gh, hpad))
    gs_w = torch.ceil(_div(image_hw[:, 1].float() * gw, wpad))
    ys = torch.arange(gh, dtype=torch.float32, device=dev)
    xs = torch.arange(gw, dtype=torch.float32, device=dev)
    mask_y = ys[None, :] < gs_h[:, None]            # [B, gh]
    mask_x = xs[None, :] < gs_w[:, None]            # [B, gw]
    mask = mask_y[:, :, None] & mask_x[:, None, :]  # [B, gh, gw]
    loc_y = (ys[None, :] + 0.5) / gs_h[:, None].clamp(min=1.0)
    loc_x = (xs[None, :] + 0.5) / gs_w[:, None].clamp(min=1.0)
    loc = torch.stack([loc_x[:, None, :].expand(b, gh, gw),
                       loc_y[:, :, None].expand(b, gh, gw)], dim=-1)
    zero = torch.zeros((), device=dev)
    loc = torch.where(mask[..., None], loc, zero)
    feats = torch.where(mask[..., None], grid_feats,
                        zero.to(grid_feats.dtype))
    return RegionFeatures(features=feats.reshape(b, gh * gw, -1),
                          mask=mask.reshape(b, gh * gw),
                          loc=loc.reshape(b, gh * gw, 2))


def spatial_dropout(regions: RegionFeatures, k: int,
                    keys: torch.Tensor) -> RegionFeatures:
    """Up to ``k`` valid regions an image: those with the largest of the
    uniform ``keys`` [B, N] (invalid regions rank last, at -1, in index
    order as ``jax.lax.top_k`` has ties), as a fixed-size gather whose
    invalid slots are zero."""
    keys = torch.where(regions.mask, keys, torch.full_like(keys, -1.0))
    top_keys, idx = top_k(keys, min(k, keys.shape[1]))   # [B, k]
    valid = top_keys >= 0.0

    def take(x):
        g = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        return torch.where(valid[..., None], g,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return RegionFeatures(features=take(regions.features), mask=valid,
                          loc=take(regions.loc))


def box_regions(boxes: torch.Tensor, box_feats: torch.Tensor,
                valid: torch.Tensor, image_hw: torch.Tensor, k: int,
                keys: torch.Tensor) -> RegionFeatures:
    """Up to ``k`` random valid sampled boxes an image as regions, with
    centres normalised by the image's valid (h, w) ``image_hw`` (float);
    ``keys`` [B, S] the dropout's uniform draws."""
    centers = box_ops.centers(boxes)  # [B, S, 2] (x, y)
    loc = torch.stack([
        centers[..., 0] / image_hw[:, None, 1].clamp(min=1.0),
        centers[..., 1] / image_hw[:, None, 0].clamp(min=1.0)], dim=-1)
    return spatial_dropout(
        RegionFeatures(features=box_feats, mask=valid, loc=loc.float()),
        k, keys)


class MMSSHeads(nn.Module):
    """The MMSS heads (``GroundingHead``, ``TransformerHead``,
    ``MLPHead``) with the shared (tied) ``v2l_projection``, which the
    detector's box predictor also uses in place of ``emb_pred`` under
    ``LOAD_EMB_PRED_FROM_MMSS_HEAD``."""

    def __init__(self, head_types: Tuple[str, ...], tie_v2l: bool,
                 gcfg: GroundingConfig, tcfg: TransformerHeadConfig,
                 v_dim: int, l_dim: int):
        super().__init__()
        unknown = set(head_types) - set(HEAD_TYPES)
        if unknown:
            raise ValueError(f"MMSS_HEAD.TYPES {sorted(unknown)}: the "
                             f"heads are {HEAD_TYPES}")
        self.head_types = tuple(head_types)
        self.v2l_projection = Dense(v_dim, l_dim, highest=True) \
            if tie_v2l else None
        if "GroundingHead" in head_types:
            self.grounding_head = GroundingHead(
                gcfg, v_dim, l_dim, external_projection=tie_v2l)
        if "TransformerHead" in head_types:
            self.transformer_head = TransformerHead(
                tcfg, v_dim, l_dim, external_projection=tie_v2l)
        if "MLPHead" in head_types:
            self.mlp_head = MLPHead(tcfg, v_dim, l_dim,
                                    external_projection=tie_v2l)

    def project(self, features: torch.Tensor) -> torch.Tensor:
        return self.v2l_projection(features)

    def forward(self, image: RegionFeatures, caption: CaptionFeatures,
                word_embeddings: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                global_batch=None, draws: Optional[Dict] = None,
                image2: Optional[RegionFeatures] = None,
                draws2: Optional[Dict] = None):
        """-> (outputs, losses, dists) of one region group; with
        ``image2`` (the fused grid + box pass) a tuple of two such
        triples, where the transformer head encodes both groups' pairs
        in one call and the grounding and MLP heads run a group at a
        time. ``draws`` (``draws2``): the grounding head's random draws
        for the group, the rest from ``generator``. With
        ``global_batch`` (``parallel/mesh.py:GlobalBatch``) the regions
        and captions of every rank are gathered first, so that the
        heads' batch-coupled losses (the B x B matchings, the MLM mean
        over the masked tokens) and, after them, the distillation span
        the global batch, as in JAX's global-scope step."""
        groups = [(image, draws)] if image2 is None else \
            [(image, draws), (image2, draws2)]
        if global_batch is not None:
            caption = CaptionFeatures(*map(global_batch.gather, caption))
            groups = [(RegionFeatures(*map(global_batch.gather, img)), d)
                      for img, d in groups]
        if self.v2l_projection is not None:
            groups = [(img._replace(features=self.project(img.features)),
                       d) for img, d in groups]
        acc = [({}, {}, {}) for _ in groups]

        def add(res, into):
            # (other, losses[, dists]) into (outputs, losses, dists)
            for dst, part in zip(into, res):
                dst.update(part)

        if "GroundingHead" in self.head_types:
            for (img, d), into in zip(groups, acc):
                add(self.grounding_head(img, caption, d, generator), into)
        if "TransformerHead" in self.head_types:
            res = self.transformer_head(
                groups[0][0], caption, word_embeddings,
                deterministic=deterministic,
                image2=groups[1][0] if image2 is not None else None,
                generator=generator)
            for r, into in zip((res,) if image2 is None else res, acc):
                add(r, into)
        if "MLPHead" in self.head_types:
            for (img, _), into in zip(groups, acc):
                add(self.mlp_head(img, caption, word_embeddings,
                                  deterministic, generator), into)
        return acc[0] if image2 is None else tuple(acc)


def mmss_kwargs(cfg) -> dict:
    """The language backbone's and the MMSS heads' constructor arguments
    of an image-caption model from ``cfg``."""
    m = cfg.MODEL.MMSS_HEAD
    distill_cfg = None
    if m.DISTILLATION_LOSS:
        distill_cfg = dict(
            loss_type=m.DISTILLATION_LOSS_TYPE,
            temperature=m.DISTILLATION_TEMPERATURE,
            loss_weight=m.DISTILLATION_LOSS_WEIGHT,
            detach_teacher=m.DISTILLATION_DETACH_TEACHER,
            transformer_teacher=m.DISTILLATION_TEACHER_TRANSFORMER)
    return dict(
        language_type=cfg.MODEL.LANGUAGE_BACKBONE.TYPE,
        language_add_position=(
            cfg.MODEL.LANGUAGE_BACKBONE.ADD_POSITION_EMBEDDING),
        lang_bert_cfg=BertConfig.from_cfg_node(
            cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG),
        head_types=tuple(m.TYPES), tie_v2l=m.TIE_VL_PROJECTION_WEIGHTS,
        gcfg=GroundingConfig.from_cfg(cfg),
        tcfg=TransformerHeadConfig.from_cfg(cfg),
        spatial_dropout_k=m.SPATIAL_DROPOUT, distill_cfg=distill_cfg)


class _CaptionModel:
    """What the image-caption models share: ``language_backbone`` and
    ``mmss_heads`` (the Flax scope names), the preprocessing and the
    distillation loss."""

    def _build_caption_side(self, *, language_type: str,
                            language_add_position: bool,
                            lang_bert_cfg: BertConfig,
                            head_types: Tuple[str, ...], tie_v2l: bool,
                            gcfg: GroundingConfig,
                            tcfg: TransformerHeadConfig,
                            spatial_dropout_k: int,
                            distill_cfg: Optional[dict], v_dim: int):
        lang_kwargs = {"bert_cfg": lang_bert_cfg}
        if language_type == "build_bertemb_backbone":
            lang_kwargs["add_position_embedding"] = language_add_position
        self.language_backbone = LANGUAGE_BACKBONES[language_type](
            **lang_kwargs)
        self.mmss_heads = MMSSHeads(head_types, tie_v2l, gcfg, tcfg,
                                    v_dim=v_dim,
                                    l_dim=lang_bert_cfg.hidden_size)
        self.spatial_dropout_k = spatial_dropout_k
        self.distill_cfg = distill_cfg

    def preprocess(self, images: ImageBatch) -> torch.Tensor:
        """(x - mean) / std over the whole canvas: these models, unlike
        ``OvrRCNN``, do not zero the padding (as in the JAX package)."""
        img = images.image
        with wait("pixel_stats"):  # host lists to the card: a blocking copy
            mean = torch.tensor(self.pixel_mean, device=img.device)
            std = torch.tensor(self.pixel_std, device=img.device)
        return ((img - mean) / std).to(self.compute_dtype)

    def _distill(self, trans, w2r, r2w):
        d = self.distill_cfg
        return DISTILL_LOSSES[d["loss_type"]](
            trans, w2r, r2w, d["temperature"], d["loss_weight"],
            d["detach_teacher"], d["transformer_teacher"])


@register_meta_arch(NAME)
class DistillProposalMMSSRCNN(_CaptionModel, OvrRCNN):
    """The detector of ``OvrRCNN`` plus ``language_backbone`` and
    ``mmss_heads``. The box predictor has no ``emb_pred`` when it takes
    the shared ``v2l_projection``. ``fused_mmss``
    (``TPU.FUSED_MMSS_PASSES``): where the heads include the
    transformer head and the grid and box regions have one shape, both
    passes go through the heads in one call (``MMSSHeads``' ``image2``)."""

    grid_mmss = True  # DistillOnlyProposalMMSSRCNN: the box pass alone

    def __init__(self, *, language_type: str, language_add_position: bool,
                 lang_bert_cfg: BertConfig, head_types: Tuple[str, ...],
                 tie_v2l: bool, gcfg: GroundingConfig,
                 tcfg: TransformerHeadConfig, spatial_dropout_k: int,
                 distill_cfg: Optional[dict],
                 load_emb_pred_from_mmss: bool, fused_mmss: bool = False,
                 device=None, **detector):
        self.emb_from_mmss = load_emb_pred_from_mmss and tie_v2l
        super().__init__(device="cpu", emb_pred=not self.emb_from_mmss,
                         **detector)
        self._build_caption_side(
            language_type=language_type,
            language_add_position=language_add_position,
            lang_bert_cfg=lang_bert_cfg, head_types=head_types,
            tie_v2l=tie_v2l, gcfg=gcfg, tcfg=tcfg,
            spatial_dropout_k=spatial_dropout_k, distill_cfg=distill_cfg,
            v_dim=detector["res2_out_channels"] * 8)
        self.fused_mmss = fused_mmss
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        return cls(
            load_emb_pred_from_mmss=cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD,
            fused_mmss=cfg.TPU.FUSED_MMSS_PASSES, device=device,
            **mmss_kwargs(cfg), **detector_kwargs(cfg))

    def _predict_boxes(self, box_feats_flat, class_emb):
        """The box predictor, on the shared ``v2l_projection``'s
        embeddings where the model ties them."""
        emb = self.mmss_heads.project(box_feats_flat) \
            if self.emb_from_mmss else None
        return self.roi_heads.predict(box_feats_flat, class_emb, emb)

    def losses(self, batch: DetectionBatch, class_emb: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Dict[str, object]] = None,
               deterministic: bool = True, global_batch=None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(mmss_outputs, losses) of one padded batch with ``batch.gt``
        and ``batch.text``; ``class_emb`` [K+1, D] (last row background).
        ``uniforms`` may hold ``"rpn"`` and ``"roi"`` (u_pos, u_neg)
        pairs as ``OvrRCNN.losses`` takes them, ``"grid_drop"`` [B, gh *
        gw] and ``"box_drop"`` [B, S] (the spatial dropout's keys), and
        ``"grid_heads"`` and ``"box_heads"`` (the grounding head's draws
        in each pass, ``GroundingHead.forward``); what is missing is
        drawn from ``generator``. ``deterministic=False`` makes the MMSS
        heads' dropout live (the training step). ``global_batch`` (the
        global contrastive scope) makes the MMSS heads and the FastRCNN
        losses read every rank's batch."""
        uniforms = dict(uniforms or {})
        images, gt = batch.images, batch.gt
        b = gt.boxes.shape[0]
        dev = gt.boxes.device

        def draw(key, n, pair=True):
            if key not in uniforms:
                u = [torch.rand((b, n), generator=generator, device=dev)
                     for _ in range(2 if pair else 1)]
                uniforms[key] = tuple(u) if pair else u[0]
            return uniforms[key]

        with stage(NAME, "language"):
            caption = self.language_backbone(batch.text, deterministic=True)
        with stage(NAME, "preprocess"):
            x = self.preprocess(images)
        with stage(NAME, "backbone"):
            features = self.backbone(x)["res4"]
        losses: Dict[str, torch.Tensor] = {}
        if self.use_rpn:
            with stage(NAME, "rpn_head"):
                anchors, logits, deltas = self.run_rpn(features)
            with stage(NAME, "rpn_losses"):
                losses.update(rpn_losses(anchors, logits, deltas, gt,
                                         self.rpn_cfg,
                                         *draw("rpn", anchors.shape[0])))
            with stage(NAME, "select_proposals"), torch.no_grad():
                proposals = select_proposals(
                    anchors, logits.detach(), deltas.detach(), images.hw,
                    self.rpn_cfg, training=True)
        else:
            proposals = _require_proposals(batch)
        with stage(NAME, "label_and_sample"):
            n = proposals.boxes.shape[1] + (
                gt.boxes.shape[1] if self.rcfg.proposal_append_gt else 0)
            sampled = label_and_sample_proposals(proposals, gt, self.rcfg,
                                                 *draw("roi", n))
        with stage(NAME, "roi_features"):
            box_feats = self.roi_heads.roi_features(
                features, sampled.boxes).float()
        s, c = box_feats.shape[1:]
        with stage(NAME, "predict"):
            scores, deltas2 = self._predict_boxes(
                box_feats.reshape(b * s, c), class_emb)
            losses.update(roi_heads_losses(
                scores.reshape(b, s, -1), deltas2.reshape(b, s, 4), sampled,
                self.pcfg, global_batch))

        word_emb = self.language_backbone.word_embedding_matrix()

        def heads(regions, key, **two_groups):
            return self.mmss_heads(regions, caption, word_emb,
                                   deterministic, generator, global_batch,
                                   uniforms.get(key), **two_groups)

        def make_box_regions():
            k = self.spatial_dropout_k if self.spatial_dropout_k > 0 else s
            return box_regions(sampled.boxes, box_feats, sampled.valid,
                               images.hw.float(), k,
                               draw("box_drop", s, pair=False))

        regions = bregions = grid_res = box_res = None
        if self.grid_mmss:
            with stage(NAME, "grid_features"):
                grid = self.roi_heads.grid_features(features).float()
                regions = make_grid_regions(grid, images.hw,
                                            (x.shape[1], x.shape[2]))
                if self.spatial_dropout_k > 0:
                    regions = spatial_dropout(
                        regions, self.spatial_dropout_k,
                        draw("grid_drop", regions.mask.shape[1],
                             pair=False))
        if regions is not None and self.fused_mmss and \
                "TransformerHead" in self.mmss_heads.head_types:
            with stage(NAME, "box_regions"):
                bregions = make_box_regions()
            if regions.mask.shape == bregions.mask.shape:
                with stage(NAME, "fused_mmss"):
                    grid_res, box_res = heads(
                        regions, "grid_heads", image2=bregions,
                        draws2=uniforms.get("box_heads"))
        if regions is not None and grid_res is None:
            with stage(NAME, "grid_mmss"):
                grid_res = heads(regions, "grid_heads")
        if box_res is None:
            with stage(NAME, "box_mmss"):
                if bregions is None:
                    bregions = make_box_regions()
                box_res = heads(bregions, "box_heads")

        outputs: Dict[str, torch.Tensor] = {}
        dists: Dict[str, torch.Tensor] = {}
        if grid_res is not None:
            og, lg, dg = grid_res
            outputs.update(og)
            losses.update(lg)
            dists.update(dg)
        o, l, d = box_res
        outputs.update({"Box " + k2: v for k2, v in o.items()})
        losses.update({"Box " + k2: v for k2, v in l.items()})
        dists.update({"box_" + k2: v for k2, v in d.items()})
        if self.distill_cfg is not None:
            with stage(NAME, "distill"):
                if self.grid_mmss:
                    losses["kd_loss"] = self._distill(
                        dists["trans"], dists["w2r"], dists["r2w"])
                losses["box_kd_loss"] = self._distill(
                    dists["box_trans"], dists["box_w2r"], dists["box_r2w"])
                if self.grid_mmss:
                    losses["mixbox_kd_loss"] = self._distill(
                        dists["trans"], dists["box_w2r"], dists["box_r2w"])
        return outputs, losses

    @torch.inference_mode()
    def inference(self, batch: DetectionBatch,
                  class_emb: torch.Tensor) -> Detections:
        """Detections for one padded batch, with the box predictor on the
        shared projection where the model ties it."""
        images = batch.images
        with stage(NAME, "preprocess"):
            x = self.preprocess(images)
        with stage(NAME, "backbone"):
            features = self.backbone(x)["res4"]
        if self.use_rpn:
            with stage(NAME, "rpn_head"):
                anchors, logits, deltas = self.run_rpn(features)
            with stage(NAME, "select_proposals"):
                proposals = select_proposals(anchors, logits, deltas,
                                             images.hw, self.rpn_cfg)
        else:
            proposals = _require_proposals(batch)
        with stage(NAME, "roi_features"):
            box_feats = self.roi_heads.roi_features(
                features, proposals.boxes).float()
        b, s, c = box_feats.shape
        with stage(NAME, "predict"):
            scores, deltas2 = self._predict_boxes(
                box_feats.reshape(b * s, c), class_emb)
        with stage(NAME, "fast_rcnn_inference"):
            dets = fast_rcnn_inference_batched(
                scores.reshape(b, s, -1), deltas2.reshape(b, s, 4),
                proposals.boxes, proposals.mask, images.hw, self.pcfg)
            scale = images.orig_hw.float() / images.hw.float()
            boxes = box_ops.scale(dets.boxes, scale[:, None, 1],
                                  scale[:, None, 0])
            boxes = box_ops.clip(boxes, (images.orig_hw[:, 0:1],
                                         images.orig_hw[:, 1:2]))
        return dets._replace(boxes=boxes)


@register_meta_arch("DistillOnlyProposalMMSSRCNN")
class DistillOnlyProposalMMSSRCNN(DistillProposalMMSSRCNN):
    """The box MMSS pass alone (no grid features, no grid pass): of the
    distillation losses only ``box_kd_loss``. Its profile ranges are
    named ``DistillProposalMMSSRCNN.<stage>``."""

    grid_mmss = False


@register_meta_arch(GRID_NAME)
class MMSSGridModel(_CaptionModel, nn.Module):
    """The proposal-free grid model (OVR-CNN's pretraining): the trunk's
    ``MMSS_HEAD.IN_FEATURES`` map (res5, the default, by a fifth stage
    in ``backbone``; or res4) as masked grid regions, spatial dropout,
    the MMSS heads and, under ``DISTILLATION_LOSS``, ``kd_loss``. No
    RPN and no detector, so no ``inference``: its evaluation is the
    loss-only pass ('ovr'). The random draws are inputs where given
    (``uniforms``: ``"grid_drop"`` [B, gh * gw] and ``"grid_heads"``,
    the grounding head's draws), else drawn from ``generator``. Each
    stage runs in a stage range (``utils/trace.py:stage``)
    ``MMSSGridModel.<stage>``."""

    def __init__(self, *, depth: int, num_groups: int, width_per_group: int,
                 stem_out_channels: int, res2_out_channels: int,
                 stride_in_1x1: bool, pixel_mean: tuple, pixel_std: tuple,
                 in_features: str,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_at: int = 0, remat_backbone: bool = False,
                 device=None, **caption_side):
        super().__init__()
        if in_features not in ("res4", "res5"):
            raise ValueError(f"MMSS_HEAD.IN_FEATURES {in_features!r}")
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.compute_dtype = compute_dtype
        self.in_features = in_features
        self.backbone = ResNetC4(
            depth=depth, out_features=("res4",) if in_features == "res4"
            else ("res4", "res5"), num_groups=num_groups,
            width_per_group=width_per_group,
            stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype,
            freeze_at=freeze_at, remat=remat_backbone)
        self._build_caption_side(
            v_dim=res2_out_channels * (8 if in_features == "res5" else 4),
            **caption_side)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, cfg, device=None):
        kw = detector_kwargs(cfg)
        for key in ("rpn_cfg", "rcfg", "pcfg", "use_rpn"):
            del kw[key]
        return cls(in_features=cfg.MODEL.MMSS_HEAD.IN_FEATURES,
                   device=device, **kw, **mmss_kwargs(cfg))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def losses(self, batch: DetectionBatch, class_emb=None,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Dict[str, object]] = None,
               deterministic: bool = True, global_batch=None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(mmss_outputs, losses) of one padded batch with
        ``batch.text``; ``class_emb`` is not read (the training step
        passes it to every model). ``deterministic=False`` makes the
        MMSS heads' dropout live; ``global_batch`` makes the heads read
        every rank's regions and captions."""
        uniforms = dict(uniforms or {})
        images = batch.images
        with stage(GRID_NAME, "language"):
            caption = self.language_backbone(batch.text, deterministic=True)
        with stage(GRID_NAME, "preprocess"):
            x = self.preprocess(images)
        with stage(GRID_NAME, "backbone"):
            feats = self.backbone(x)[self.in_features].float()
        with stage(GRID_NAME, "grid_features"):
            regions = make_grid_regions(feats, images.hw,
                                        (x.shape[1], x.shape[2]))
            if self.spatial_dropout_k > 0:
                if "grid_drop" not in uniforms:
                    uniforms["grid_drop"] = torch.rand(
                        regions.mask.shape, generator=generator,
                        device=feats.device)
                regions = spatial_dropout(regions, self.spatial_dropout_k,
                                          uniforms["grid_drop"])
        word_emb = self.language_backbone.word_embedding_matrix()
        with stage(GRID_NAME, "grid_mmss"):
            outputs, losses, dists = self.mmss_heads(
                regions, caption, word_emb, deterministic, generator,
                global_batch, uniforms.get("grid_heads"))
        if self.distill_cfg is not None:
            with stage(GRID_NAME, "distill"):
                losses["kd_loss"] = self._distill(
                    dists["trans"], dists["w2r"], dists["r2w"])
        return outputs, losses


@register_meta_arch("DistillMMSSGridModel")
class DistillMMSSGridModel(MMSSGridModel):
    """The grid model with distillation (``kd_loss`` under
    ``DISTILLATION_LOSS``, which ``from_cfg`` wires); its profile ranges
    are named ``MMSSGridModel.<stage>``."""
