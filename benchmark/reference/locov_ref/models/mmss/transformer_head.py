"""TransformerHead: a multimodal BERT encoder with masked language
modelling and image-caption matching.

Counterpart of ``locov_tpu/models/mmss/transformer_head.py`` for
``MMM_LOSS`` "cross_entropy" and "". Projected
region features plus location embeddings are appended to the caption's
token embeddings; a small BERT encoder (6 layers, 8 heads in
coco_lsm.yaml) encodes every (caption, image) pair of the batch,
gathered by index; the pooled first token scores the pair
(``bi_seq_relationship[:, 0]`` -> a B x B cost), and the diagonal
pairs' caption tokens feed the tied MLM decoder (the reference decodes
all B^2 pairs and takes the diagonal: the same numbers).

The attention mask is the reference's: the raw 0/1 mask is added to the
pre-softmax logits (``PROPER_ATTENTION_MASK`` switches to the most
negative value). ``TPU.PAIRWISE_CHUNK`` c below the pair count P cuts
the pair list into P // c equal chunks, each encoded and pooled in turn
under ``bert.remat`` (JAX's ``nn.scan(nn.remat(_PairChunkEncoder))``):
only one chunk's activations are alive in the backward.

The fused grid + box pass (``image2``, ``TPU.FUSED_MMSS_PASSES``): the
two region groups, of equal shapes, are stacked on the batch axis and
their two B x B pair lists go back to back through one encoder, pooler
and LM-head call (the chunks, where ``PAIRWISE_CHUNK`` asks for them,
cut the fused list of 2 B^2 pairs); the regions of one group never
attend to the other's. Each group's losses are those of its own pass;
only the dropout masks are drawn in another order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ...ops.losses import mean_cross_entropy
from ...structures.batches import CaptionFeatures, RegionFeatures
from ..bert import (BertConfig, BertEncoder, BertLMHead, BertPooler, Dense,
                    LayerNorm, _dense, dropout, remat)


class TransformerHeadConfig(NamedTuple):
    bert: BertConfig
    mlm: bool = True
    mlm_validation: bool = True
    mvm_loss: str = ""
    mmm_loss: str = "cross_entropy"
    return_dist: bool = False
    pairwise_chunk: int = 0
    # False: the reference's raw additive 0/1 mask; True: (1 - m) * min
    proper_attention_mask: bool = False

    @classmethod
    def from_cfg(cls, cfg):
        """Under ``TPU.COMPUTE_DTYPE`` bfloat16 the joint encoder's
        products run in bfloat16 (``BertConfig.dtype``)."""
        t = cfg.MODEL.MMSS_HEAD.TRANSFORMER
        bert = BertConfig.from_cfg_node(t.BERT_CONFIG)
        if cfg.TPU.COMPUTE_DTYPE == "bfloat16":
            bert = bert._replace(dtype=torch.bfloat16)
        return cls(
            bert=bert,
            mlm=t.MASKED_LANGUAGE_MODELING,
            mlm_validation=t.MASKED_LANGUAGE_MODELING_VALIDATION,
            mvm_loss=t.MVM_LOSS,
            mmm_loss=t.MMM_LOSS,
            return_dist=cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS,
            pairwise_chunk=cfg.TPU.PAIRWISE_CHUNK,
            proper_attention_mask=t.PROPER_ATTENTION_MASK)


class VisualEmbedding(nn.Module):
    """linear(img) + linear(loc) -> LayerNorm -> dropout."""

    def __init__(self, cfg: BertConfig, in_dim: int, loc_dim: int = 2):
        super().__init__()
        self.cfg = cfg
        self.image_embeddings = _dense(cfg, in_dim, cfg.hidden_size)
        self.image_location_embeddings = _dense(cfg, loc_dim,
                                                cfg.hidden_size)
        self.norm = LayerNorm(cfg.hidden_size, eps=1e-12)

    def forward(self, features, loc, deterministic=True, generator=None):
        x = self.norm(self.image_embeddings(features) +
                      self.image_location_embeddings(loc))
        return dropout(x, self.cfg.hidden_dropout_prob, deterministic,
                       generator)


class TransformerHead(nn.Module):
    """With ``external_projection`` the regions arrive projected by the
    shared ``v2l_projection`` of ``MMSSHeads``. Under ``MMM_LOSS`` ""
    no pooler and no ``bi_seq_relationship`` are built (Flax creates
    none for modules that never run)."""

    def __init__(self, tcfg: TransformerHeadConfig, v_dim: int, l_dim: int,
                 loc_dim: int = 2, external_projection: bool = False):
        super().__init__()
        if tcfg.mmm_loss not in ("cross_entropy", ""):
            raise NotImplementedError(tcfg.mmm_loss)
        self.tcfg = tcfg
        c = tcfg.bert
        self.v2l_projection = None if external_projection else Dense(
            v_dim, l_dim)
        self.visual_emb = VisualEmbedding(c, l_dim, loc_dim)
        self.encoder = BertEncoder(c)
        if tcfg.mmm_loss == "cross_entropy":
            self.pooler = BertPooler(c)
            self.bi_seq_relationship = _dense(c, c.hidden_size, 2)
        self.predictions = BertLMHead(c)

    def _encode_pairs(self, caption_emb, image_emb, caption_mask,
                      region_mask, cap_idx, img_idx, deterministic,
                      raw_mask, generator=None):
        """(sequence, pooled first token) of the pairs (caption
        ``cap_idx[k]``, image ``img_idx[k]``) through the joint
        encoder."""
        tokens = torch.cat([caption_emb[cap_idx], image_emb[img_idx]],
                           dim=1)
        mask = torch.cat([caption_mask[cap_idx], region_mask[img_idx]],
                         dim=1)
        seq = self.encoder(tokens, mask, deterministic=deterministic,
                           raw_additive_mask=raw_mask, generator=generator)
        return seq, self.pooler(seq)

    def forward(self, image: RegionFeatures, caption: CaptionFeatures,
                word_embeddings: torch.Tensor, deterministic: bool = True,
                image2: Optional[RegionFeatures] = None,
                generator: Optional[torch.Generator] = None):
        """-> (other, losses) or, with ``return_dist``, (other, losses,
        {"trans": [B, B] cost, [caption, image]}); with ``image2`` a
        tuple of two such results, one a group."""
        t = self.tcfg
        caption_emb = caption.encoded_tokens           # [B, W, D]
        caption_mask = caption.attention_mask.float()
        target_ids = torch.where(caption.mlm_mask > 0, caption.target_ids,
                                 torch.full_like(caption.target_ids, -1))
        raw_mask = not t.proper_attention_mask
        b, max_w = caption_mask.shape
        groups = [image] if image2 is None else [image, image2]
        ng = len(groups)
        if ng == 2 and image.mask.shape != image2.mask.shape:
            raise ValueError(
                f"the fused MMSS pass needs equal region counts, got "
                f"{tuple(image.mask.shape)} and {tuple(image2.mask.shape)}")
        feats = torch.cat([g.features for g in groups])
        locs = torch.cat([g.loc for g in groups])
        region_mask = torch.cat([g.mask for g in groups]).float()

        image_emb = feats if self.v2l_projection is None else \
            self.v2l_projection(feats)
        image_emb = self.visual_emb(image_emb, locs, deterministic,
                                    generator)      # [ng * B, R, D]

        ar = torch.arange(b, device=caption_mask.device)
        if t.mmm_loss == "cross_entropy":
            # the B x B (caption, image) pairs of each group by index,
            # back to back: pair k of group g is caption k // b with
            # image g * b + k % b
            cap_idx = ar.repeat_interleave(b).repeat(ng)
            img_idx = torch.cat([ar.repeat(b) + g * b for g in range(ng)])
            embs = (caption_emb, image_emb, caption_mask, region_mask)
            npairs = ng * b * b
            if 0 < t.pairwise_chunk < npairs:
                # JAX's reshape(nchunk, -1): P // c chunks of equal size
                nchunk = npairs // t.pairwise_chunk
                if npairs % nchunk:
                    raise ValueError(
                        f"TPU.PAIRWISE_CHUNK {t.pairwise_chunk}: {npairs} "
                        f"pairs do not split into {nchunk} equal chunks")
                outs = [remat(self._encode_pairs, *embs, ci, ii,
                              deterministic, raw_mask, generator,
                              generator=generator)
                        for ci, ii in zip(cap_idx.reshape(nchunk, -1),
                                          img_idx.reshape(nchunk, -1))]
                seq = torch.cat([o[0] for o in outs])
                pooled = torch.cat([o[1] for o in outs])
            else:
                seq, pooled = self._encode_pairs(*embs, cap_idx, img_idx,
                                                 deterministic, raw_mask,
                                                 generator)
            scores = self.bi_seq_relationship(pooled)[:, 0]  # [ng*B*B]
            pw_costs = scores.reshape(ng, b, b).unbind(0)
            diag = torch.cat([ar * b + ar + g * b * b for g in range(ng)])
            seq_t_diag = seq[diag, :max_w]            # [ng * B, W, D]
        else:
            tokens = torch.cat([caption_emb.repeat(ng, 1, 1), image_emb],
                               dim=1)
            mask = torch.cat([caption_mask.repeat(ng, 1), region_mask],
                             dim=1)
            seq = self.encoder(tokens, mask, deterministic=deterministic,
                               raw_additive_mask=raw_mask,
                               generator=generator)
            pw_costs = [None] * ng
            seq_t_diag = seq[:, :max_w]

        # one tied-decoder product over every group's diagonal pairs
        lm_logits_all = self.predictions(seq_t_diag, word_embeddings)
        results = [self._group_result(lm_logits, target_ids, pw_cost)
                   for lm_logits, pw_cost in
                   zip(lm_logits_all.split(b), pw_costs)]
        return results[0] if image2 is None else tuple(results)

    def _group_result(self, lm_logits, target_ids, pw_cost):
        """(other, losses[, dists]) of one region group from its MLM
        logits [B, W, V] and its B x B matching cost."""
        t = self.tcfg
        losses: Dict[str, torch.Tensor] = {
            "Masked Language Modeling Loss":
                mean_cross_entropy(lm_logits, target_ids, ignore_index=-1)}
        other: Dict[str, torch.Tensor] = {}
        valid = target_ids >= 0
        acc_num = ((lm_logits.argmax(-1) == target_ids) & valid).sum()
        acc_den = valid.sum()
        other["Masked Language Modeling Accuracy"] = torch.where(
            acc_den > 0, acc_num.float() / acc_den.clamp(min=1).float(),
            torch.zeros((), device=lm_logits.device))

        if t.mmm_loss == "cross_entropy":
            lc = torch.log_softmax(-pw_cost, dim=0)
            li = torch.log_softmax(-pw_cost, dim=1)
            losses["Image Caption Matching Loss"] = (
                -torch.diagonal(lc).mean() - torch.diagonal(li).mean())
            ar = torch.arange(pw_cost.shape[0], device=pw_cost.device)
            other["Batch Accuracy (Choose Caption)"] = \
                (pw_cost.argmin(dim=0) == ar).float().mean()
            other["Batch Accuracy (Choose Image)"] = \
                (pw_cost.argmin(dim=1) == ar).float().mean()
        else:
            losses["Image Caption Matching Loss"] = torch.zeros(
                (), device=lm_logits.device)

        if t.return_dist:
            return other, losses, {"trans": pw_cost}
        return other, losses
