"""MLPHead: an attention-free multimodal matching head.

Counterpart of ``locov_tpu/models/mmss/mlp_head.py``: each token of the
caption and each projected region (plus its location embedding) goes
through one shared MLP block (``mlp_in``, exact GELU, ``mlp_out``, the
residual, ``mlp_norm``) with no attention between them; the caption's
tokens feed the tied MLM decoder (``predictions``); the masked means of
the caption tokens (through ``match_proj``) and of the regions give the
B x B matching cost as a dot product in full float32.

The JAX module builds ``mlp_in``, ``mlp_out`` and ``mlp_norm`` inside a
helper it calls twice, once for the captions and once for the regions,
and Flax refuses the second call's modules (``NameInUseError``): the
JAX head cannot be built. This head computes what it means, one MLP
shared by both calls under those names.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import mean_cross_entropy
from ...ops.matmul import matmul_f32
from ...structures.batches import CaptionFeatures, RegionFeatures
from ..bert import BertLMHead, Dense, LayerNorm, _dense
from .transformer_head import TransformerHeadConfig, VisualEmbedding


class MLPHead(nn.Module):
    """With ``external_projection`` the regions arrive projected by the
    shared ``v2l_projection`` of ``MMSSHeads``. Under ``MMM_LOSS`` ""
    no ``match_proj`` is built (Flax creates none for a module that
    never runs)."""

    def __init__(self, tcfg: TransformerHeadConfig, v_dim: int, l_dim: int,
                 loc_dim: int = 2, external_projection: bool = False):
        super().__init__()
        self.tcfg = tcfg
        c = tcfg.bert
        self.v2l_projection = None if external_projection else Dense(
            v_dim, l_dim)
        self.visual_emb = VisualEmbedding(c, l_dim, loc_dim)
        self.mlp_in = _dense(c, c.hidden_size, c.intermediate_size)
        self.mlp_out = _dense(c, c.intermediate_size, c.hidden_size)
        self.mlp_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.predictions = BertLMHead(c)
        if tcfg.mmm_loss == "cross_entropy":
            self.match_proj = _dense(c, c.hidden_size, c.hidden_size)

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.mlp_in(tokens), approximate="none")
        return self.mlp_norm(self.mlp_out(h) + tokens)

    def forward(self, image: RegionFeatures, caption: CaptionFeatures,
                word_embeddings: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """-> (other, losses) or, with ``return_dist``, (other, losses,
        {"trans": [B, B] cost, [caption, image]})."""
        t = self.tcfg
        caption_mask = caption.attention_mask.float()
        target_ids = torch.where(caption.mlm_mask > 0, caption.target_ids,
                                 torch.full_like(caption.target_ids, -1))
        b = caption_mask.shape[0]
        image_emb = image.features if self.v2l_projection is None else \
            self.v2l_projection(image.features)
        image_emb = self.visual_emb(image_emb, image.loc, deterministic,
                                    generator)
        region_mask = image.mask.float()

        seq_t = self.encode(caption.encoded_tokens)   # [B, W, D]
        seq_v = self.encode(image_emb)                # [B, R, D]

        lm_logits = self.predictions(seq_t, word_embeddings)
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
            cap_pool = (seq_t * caption_mask[..., None]).sum(1) / \
                caption_mask.sum(1, keepdim=True).clamp(min=1.0)
            img_pool = (seq_v * region_mask[..., None]).sum(1) / \
                region_mask.sum(1, keepdim=True).clamp(min=1.0)
            score = self.match_proj(cap_pool)
            # einsum("cd,id->ci") at Precision.HIGHEST
            pw_cost = -matmul_f32(score.float(), img_pool.float().t())
            lc = torch.log_softmax(-pw_cost, dim=0)
            li = torch.log_softmax(-pw_cost, dim=1)
            losses["Image Caption Matching Loss"] = (
                -torch.diagonal(lc).mean() - torch.diagonal(li).mean())
            ar = torch.arange(b, device=pw_cost.device)
            other["Batch Accuracy (Choose Caption)"] = \
                (pw_cost.argmin(dim=0) == ar).float().mean()
            other["Batch Accuracy (Choose Image)"] = \
                (pw_cost.argmin(dim=1) == ar).float().mean()
        else:
            pw_cost = None
            losses["Image Caption Matching Loss"] = torch.zeros(
                (), device=lm_logits.device)

        if t.return_dist:
            return other, losses, {"trans": pw_cost}
        return other, losses
