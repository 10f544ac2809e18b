"""GroundingHead: localized word-region contrastive matching.

Counterpart of ``locov_tpu/models/mmss/grounding_head.py``. The
all-pairs local similarity is one product,

    sim[c, i, w, r] = caption_emb[c, w, :] . image_emb[i, r, :] / T,

in full float32 (``Precision.HIGHEST`` in JAX; ``ops/matmul.py``), then:
invalid word/region pairs filled with min - 100, the softmax, hardmax,
random_categorical or random_top3 alignment, the aligned_local or
reconstruction_mse global distance, the cross-entropy or triplet
(hardest, easiest or random negatives) losses over the B x B cost, the
batch accuracies, and the (w2r, r2w) costs returned for distillation.

The random draws are inputs where given (``draws``), else they come from
``generator``:

- ``random_categorical`` samples each word's region (and each region's
  word) from the softmax of its similarities as ``jax.random.
  categorical`` does: argmax(logits - log(-log(u))) with u uniform over
  [tiny, 1). ``draws["align_words"]`` is u [C, I, W, R],
  ``draws["align_regions"]`` u [C, I, R, W]. ``random_top3`` samples
  uniformly among the three most similar (the same draws, over the
  log of a three-hot vector).
- ``random`` negative mining takes, for each positive, one of the B - 1
  other captions (images): ``draws["neg_words"]`` and
  ``draws["neg_regions"]`` are (caption index, image index) pairs of
  int [B] in [0, B - 1), indices into the cost without its diagonal.
  With neither draws nor a generator the triplet loss draws from a
  generator seeded 0 (JAX's default ``PRNGKey(0)``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ...ops.matmul import matmul_f32
from ...ops.nms import top_k
from ...structures.batches import CaptionFeatures, RegionFeatures
from ..bert import Dense

RANDOM_ALIGNMENTS = ("random_categorical", "random_top3")


class GroundingConfig(NamedTuple):
    local_metric: str = "dot"
    global_metric: str = "aligned_local"
    alignment: str = "softmax"
    temperature: float = 10.0
    loss_type: str = "cross_entropy"
    negative_mining: str = "random"
    margin: float = 1.0
    align_words: bool = True
    align_regions: bool = True
    text_input: str = "input_embeddings"
    return_dist: bool = False

    @classmethod
    def from_cfg(cls, cfg):
        g = cfg.MODEL.MMSS_HEAD.GROUNDING
        return cls(
            local_metric=g.LOCAL_METRIC,
            global_metric=g.GLOBAL_METRIC,
            alignment=g.ALIGNMENT,
            temperature=g.ALIGNMENT_TEMPERATURE,
            loss_type=g.LOSS,
            negative_mining=g.NEGATIVE_MINING,
            margin=g.TRIPLET_MARGIN,
            align_words=g.ALIGN_WORDS_TO_REGIONS,
            align_regions=g.ALIGN_REGIONS_TO_WORDS,
            text_input=g.TEXT_INPUT,
            return_dist=cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS)


def _one_hot_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One-hot of the first maximum along ``dim``."""
    idx = x.argmax(dim=dim, keepdim=True)
    return torch.zeros_like(x).scatter_(dim, idx, 1.0)


def gumbel_categorical(logits: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, given its uniform
    draws ``u`` (the shape of ``logits``, over [tiny, 1)): the index of
    the largest logits + Gumbel noise, -log(-log(u))."""
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _three_hot_logits(sim: torch.Tensor) -> torch.Tensor:
    """log(three-hot + 1e-20) over the last axis: 0 at the three largest
    similarities (``lax.top_k``'s order among ties), log(1e-20)
    elsewhere."""
    _, idx = top_k(sim, 3)
    three = torch.zeros_like(sim).scatter_(-1, idx, 1.0)
    return torch.log(three + 1e-20)


def _remove_diag(mat: torch.Tensor, dim: int) -> torch.Tensor:
    """N x N -> N x (N-1) (dim 1) or (N-1) x N (dim 0), dropping the
    diagonal."""
    n = mat.shape[0]
    keep = ~torch.eye(n, dtype=torch.bool, device=mat.device)
    if dim == 1:
        return mat[keep].reshape(n, n - 1)
    return mat.t()[keep].reshape(n, n - 1).t()


def local_similarity(caption_emb: torch.Tensor,
                     image_emb: torch.Tensor) -> torch.Tensor:
    """einsum("cwd,ird->ciwr") of [C, W, D] and [I, R, D] as one full
    float32 product."""
    c, w, d = caption_emb.shape
    i, r, _ = image_emb.shape
    sim = matmul_f32(caption_emb.reshape(c * w, d),
                     image_emb.reshape(i * r, d).t())
    return sim.reshape(c, w, i, r).permute(0, 2, 1, 3)


class GroundingHead(nn.Module):
    """With ``external_projection`` the regions arrive projected by the
    shared ``v2l_projection`` of ``MMSSHeads`` and the head has no
    parameters."""

    def __init__(self, gcfg: GroundingConfig, v_dim: int, l_dim: int,
                 external_projection: bool = False):
        super().__init__()
        if gcfg.local_metric != "dot":
            raise NotImplementedError(gcfg.local_metric)
        self.gcfg = gcfg
        self.v2l_projection = None if external_projection else Dense(
            v_dim, l_dim, highest=True)

    def forward(self, image: RegionFeatures, caption: CaptionFeatures,
                draws: Optional[Dict[str, object]] = None,
                generator: Optional[torch.Generator] = None):
        """-> (other, losses) or, with ``return_dist``, (other, losses,
        {"w2r": [B, B], "r2w": [B, B]}); costs are [caption, image].
        ``draws``: the random alignment's and the random negative
        mining's draws (module docstring); what is missing is drawn from
        ``generator``."""
        g = self.gcfg
        draws = dict(draws or {})
        caption_emb = getattr(caption, g.text_input)  # [B, W, D]
        caption_mask = (caption.attention_mask *
                        (1 - caption.special_tokens_mask)).float()
        num_words = caption_mask.sum(dim=1)
        region_mask = image.mask.float()  # [B, R]
        num_regions = region_mask.sum(dim=1)
        b = region_mask.shape[0]

        image_emb = image.features if self.v2l_projection is None else \
            self.v2l_projection(image.features)
        sim = local_similarity(caption_emb.float(), image_emb.float()) / \
            g.temperature
        pair_mask = (caption_mask[:, None, :, None]
                     * region_mask[None, :, None, :]) > 0
        fill = sim.min().detach() - 100.0
        sim = torch.where(pair_mask, sim, fill)
        dist = -sim

        if g.alignment == "softmax":
            attn_w2r = torch.softmax(sim, dim=3) if g.align_words else None
            attn_r2w = torch.softmax(sim, dim=2) if g.align_regions else None
        elif g.alignment == "hardmax":
            attn_w2r = _one_hot_argmax(sim, 3) if g.align_words else None
            attn_r2w = _one_hot_argmax(sim, 2) if g.align_regions else None
        elif g.alignment in RANDOM_ALIGNMENTS:
            tiny = torch.finfo(torch.float32).tiny

            def sample(logits, key):
                # one index of the last axis for each row of [C, I, a, b]
                if key not in draws:
                    if generator is None:
                        raise ValueError(
                            f"GROUNDING alignment {g.alignment!r} needs "
                            f"draws[{key!r}] or a generator")
                    draws[key] = torch.rand(
                        logits.shape, generator=generator,
                        device=logits.device).clamp_(min=tiny)
                if g.alignment == "random_top3":
                    logits = _three_hot_logits(logits)
                idx = gumbel_categorical(logits.detach(), draws[key])
                return torch.zeros_like(logits).scatter_(
                    -1, idx[..., None], 1.0)
            attn_w2r = sample(sim, "align_words") if g.align_words \
                else None
            attn_r2w = sample(sim.transpose(2, 3), "align_regions") \
                .transpose(2, 3) if g.align_regions else None
        else:
            raise NotImplementedError(g.alignment)

        ones = torch.ones_like(num_words)
        nw = torch.maximum(num_words, ones)[:, None]     # [cap, 1]
        nr = torch.maximum(num_regions, ones)[None, :]   # [1, img]
        if g.global_metric == "aligned_local":
            if g.align_words:
                a = attn_w2r * caption_mask[:, None, :, None]
                gd_w2r = (a * dist).sum(dim=(2, 3)) / nw
            if g.align_regions:
                a = attn_r2w * region_mask[None, :, None, :]
                gd_r2w = (a * dist).sum(dim=(2, 3)) / nr
        elif g.global_metric == "reconstruction_mse":
            if g.align_words:
                rec = torch.einsum("ciwr,ird->ciwd", attn_w2r, image_emb)
                mse = ((rec - caption_emb[:, None]) ** 2).mean(dim=3)
                gd_w2r = (mse * caption_mask[:, None, :]).sum(dim=2) / nw
            if g.align_regions:
                rec = torch.einsum("cwd,ciwr->cird", caption_emb, attn_r2w)
                mse = ((rec - image_emb[None]) ** 2).mean(dim=3)
                gd_r2w = (mse * region_mask[None, :, :]).sum(dim=2) / nr
        else:
            raise NotImplementedError(g.global_metric)

        # an empty caption AND an empty region set -> a huge distance
        # (the reference's boolean + is an OR)
        pair_ok = (num_words[:, None] > 0) | (num_regions[None, :] > 0)
        if g.align_words:
            gd_w2r = torch.where(pair_ok, gd_w2r,
                                 gd_w2r.max().detach() + 100.0)
        if g.align_regions:
            gd_r2w = torch.where(pair_ok, gd_r2w,
                                 gd_r2w.max().detach() + 100.0)

        losses: Dict[str, torch.Tensor] = {}
        other: Dict[str, torch.Tensor] = {}
        arange = torch.arange(b, device=sim.device)

        def ce_losses(pw_cost, tag, key=None):
            lc = torch.log_softmax(-pw_cost, dim=0)
            li = torch.log_softmax(-pw_cost, dim=1)
            losses[f"CE_loss ({tag}, Choose Caption)"] = \
                -torch.diagonal(lc).mean()
            losses[f"CE_loss ({tag}, Choose Image)"] = \
                -torch.diagonal(li).mean()

        def triplet_losses(pw_cost, tag, key):
            pos = torch.diagonal(pw_cost)
            if b < 2:
                neg_cap = neg_img = pos + g.margin
            elif g.negative_mining == "hardest":
                neg_cap = _remove_diag(pw_cost, 0).amin(dim=0)
                neg_img = _remove_diag(pw_cost, 1).amin(dim=1)
            elif g.negative_mining == "easiest":
                neg_cap = _remove_diag(pw_cost, 0).amax(dim=0)
                neg_img = _remove_diag(pw_cost, 1).amax(dim=1)
            elif g.negative_mining == "random":
                if key not in draws:
                    draws[key] = tuple(
                        torch.randint(0, b - 1, (b,), generator=generator,
                                      device=arange.device)
                        for _ in range(2))
                ic, ii = (i.long() for i in draws[key])
                neg_cap = _remove_diag(pw_cost, 0)[ic, arange]
                neg_img = _remove_diag(pw_cost, 1)[arange, ii]
            else:
                raise NotImplementedError(g.negative_mining)
            losses[f"Triplet Loss ({tag}, Choose Caption)"] = \
                torch.relu(pos - neg_cap + g.margin).mean()
            losses[f"Triplet Loss ({tag}, Choose Image)"] = \
                torch.relu(pos - neg_img + g.margin).mean()

        def accuracies(pw_cost, tag):
            other[f"Batch Accuracy ({tag}, Choose Caption)"] = \
                (pw_cost.argmin(dim=0) == arange).float().mean()
            other[f"Batch Accuracy ({tag}, Choose Image)"] = \
                (pw_cost.argmin(dim=1) == arange).float().mean()

        if g.loss_type == "matching":
            raise ValueError("Matching loss undefined for dot product")
        if g.loss_type == "cross_entropy":
            loss_fn = ce_losses
        elif g.loss_type == "triplet":
            loss_fn = triplet_losses
            if generator is None:  # JAX's default key, PRNGKey(0)
                generator = torch.Generator(
                    device=arange.device).manual_seed(0)
        else:
            raise NotImplementedError(g.loss_type)
        if g.align_words:
            loss_fn(gd_w2r, "Align Words", "neg_words")
            accuracies(gd_w2r, "Align Words")
        if g.align_regions:
            loss_fn(gd_r2w, "Align Regions", "neg_regions")
            accuracies(gd_r2w, "Align Regions")

        if g.return_dist:
            return other, losses, {"w2r": gd_w2r, "r2w": gd_r2w}
        return other, losses
