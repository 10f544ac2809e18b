"""The multi-token grounding box classifier.

Counterpart of ``locov_tpu/models/box_emb_grounding.py``
(``EmbeddingGroundingFastRCNNOutputLayers``): a class name may tokenize
to several BERT tokens, so a region scores a class by aligning its
embedding to the class's tokens (softmax or hardmax over the tokens)
and summing the aligned local distances. The class tokens are a padded
[K+1, T, D] tensor with a [K+1, T] mask (``ClassTokenEmbeddings``; the
background a single zero token), a forward input like the class
embedding matrix of ``EmbeddingBoxPredictor``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.losses import normalize_vec
from ..ops.matmul import matmul_f32


class ClassTokenEmbeddings(NamedTuple):
    tokens: torch.Tensor  # [K+1, T, D]
    mask: torch.Tensor    # [K+1, T], at least one valid token a class

    @classmethod
    def from_ragged(cls, per_class_embs: Sequence, emb_dim: int,
                    background_class: bool = True, device=None):
        """One [t_k, D] array a class -> the padded tokens and mask (on
        ``device``, the CPU by default); with ``background_class`` a
        last row of one zero token."""
        k = len(per_class_embs) + (1 if background_class else 0)
        t = max(max((len(e) for e in per_class_embs), default=1), 1)
        tokens = np.zeros((k, t, emb_dim), np.float32)
        mask = np.zeros((k, t), np.float32)
        for i, e in enumerate(per_class_embs):
            e = np.asarray(e, np.float32).reshape(-1, emb_dim)
            tokens[i, :len(e)] = e
            mask[i, :len(e)] = 1.0
        if background_class:
            mask[-1, 0] = 1.0
        return cls(torch.from_numpy(tokens).to(device),
                   torch.from_numpy(mask).to(device))

    @classmethod
    def single_token(cls, class_emb: torch.Tensor):
        """A [K+1, D] class-embedding matrix as one token a class."""
        return cls(class_emb[:, None, :],
                   torch.ones(class_emb.shape[:1] + (1,),
                              dtype=class_emb.dtype,
                              device=class_emb.device))

    def float(self) -> "ClassTokenEmbeddings":
        return ClassTokenEmbeddings(self.tokens.float(), self.mask.float())


def grounding_class_scores(region_emb: torch.Tensor,
                           class_tokens: ClassTokenEmbeddings,
                           local_metric: str = "dot",
                           alignment: str = "softmax",
                           temperature: float = 1.0,
                           normalize_emb: bool = False) -> torch.Tensor:
    """[N, D] region embeddings x [K+1, T, D] class tokens -> [N, K+1]
    scores, the negated global distance. The token similarity is one
    full float32 product (``Precision.HIGHEST`` in JAX); padded tokens
    take min - 100 before the alignment, and a class with no token
    (none in practice) max + 100 after it, both constants without a
    gradient."""
    emb = normalize_vec(region_emb) if normalize_emb else region_emb
    toks = class_tokens.tokens
    if local_metric == "cosine":
        toks = normalize_vec(toks)
    k, t, d = toks.shape
    sim = matmul_f32(emb.float(), toks.reshape(k * t, d).float().t())
    sim = sim.reshape(-1, k, t)                      # [N, K+1, T]
    if local_metric == "cosine":
        sim = torch.where(torch.isnan(sim), torch.zeros_like(sim), sim)
        dist = (1.0 - sim) / temperature
    elif local_metric == "dot":
        dist = -sim / temperature
    else:
        raise ValueError(f"GROUNDING.LOCAL_METRIC {local_metric!r}")
    sim = sim / temperature

    mask = class_tokens.mask[None]
    masked_sim = torch.where(mask > 0, sim, sim.min().detach() - 100.0)
    if alignment == "softmax":
        attn = torch.softmax(masked_sim, dim=2)
    elif alignment == "hardmax":
        idx = masked_sim.argmax(dim=2, keepdim=True)
        attn = torch.zeros_like(sim).scatter_(2, idx, 1.0)
    else:
        raise ValueError(f"GROUNDING.ALIGNMENT {alignment!r} for the "
                         f"grounding box predictor")
    global_dist = (attn * mask * dist).sum(dim=2)    # [N, K+1]
    has_tok = class_tokens.mask.sum(dim=1) > 0
    global_dist = torch.where(has_tok[None], global_dist,
                              global_dist.max().detach() + 100.0)
    return -global_dist


class EmbeddingGroundingBoxPredictor(nn.Module):
    """``bbox_pred`` (class-agnostic deltas) and ``emb_pred`` (the
    region embedding), the scores from ``grounding_class_scores``
    against ``ClassTokenEmbeddings``. With ``detach_cls_predictor`` no
    gradient flows through the classification."""

    def __init__(self, in_features: int, emb_dim: int,
                 local_metric: str = "dot", alignment: str = "softmax",
                 temperature: float = 1.0, normalize_emb: bool = False,
                 detach_cls_predictor: bool = False):
        super().__init__()
        self.bbox_pred = nn.Linear(in_features, 4)
        self.emb_pred = nn.Linear(in_features, emb_dim)
        self.local_metric = local_metric
        self.alignment = alignment
        self.temperature = temperature
        self.normalize_emb = normalize_emb
        self.detach_cls_predictor = detach_cls_predictor

    def forward(self, x: torch.Tensor, class_tokens: ClassTokenEmbeddings
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., C_in] -> (scores [..., K+1], deltas [..., 4])."""
        deltas = self.bbox_pred(x)
        emb = self.emb_pred(x.detach() if self.detach_cls_predictor else x)
        scores = grounding_class_scores(
            emb.reshape(-1, emb.shape[-1]), class_tokens,
            self.local_metric, self.alignment, self.temperature,
            self.normalize_emb)
        scores = scores.reshape(emb.shape[:-1] + scores.shape[-1:])
        if self.detach_cls_predictor:
            scores = scores.detach()
        return scores, deltas
