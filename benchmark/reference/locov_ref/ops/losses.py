"""Loss primitives (masked, static-shape) and the vector normalizations
of the embedding box predictor.

Counterpart of ``locov_tpu/ops/losses.py``. The
reductions are empty-safe as in the JAX package: where nothing is
valid they give 0, not NaN. Where a loss's gradient has a kink, it takes
JAX's value there (``l1``, ``max0``), so that both packages train
alike.
"""
from __future__ import annotations

from typing import Tuple

import torch


def l1(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient at 0, which is 1 (``Tensor.abs``
    gives 0 there, and a box delta that is exactly 0, as an anchor centred
    on its gt gives, then trains differently)."""
    return torch.where(x >= 0, x, -x)


def max0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s gradient at the tie (1/2, where
    ``clamp`` gives 1)."""
    return torch.maximum(x, torch.zeros_like(x))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber); beta <= 1e-8 is plain L1, as in
    fvcore."""
    diff = l1(pred - target)
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def giou(pred_boxes: torch.Tensor,
         target_boxes: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU loss (1 - GIoU) on aligned XYXY boxes [..., 4]."""
    px0, py0, px1, py1 = pred_boxes.unbind(-1)
    tx0, ty0, tx1, ty1 = target_boxes.unbind(-1)
    pa = max0(px1 - px0) * max0(py1 - py0)
    ta = max0(tx1 - tx0) * max0(ty1 - ty0)
    ix0, iy0 = torch.maximum(px0, tx0), torch.maximum(py0, ty0)
    ix1, iy1 = torch.minimum(px1, tx1), torch.minimum(py1, ty1)
    inter = max0(ix1 - ix0) * max0(iy1 - iy0)
    union = pa + ta - inter
    iou = inter / union.clamp(min=1e-7)
    cx0, cy0 = torch.minimum(px0, tx0), torch.minimum(py0, ty0)
    cx1, cy1 = torch.maximum(px1, tx1), torch.maximum(py1, ty1)
    carea = max0(cx1 - cx0) * max0(cy1 - cy0)
    return 1.0 - (iou - (carea - union) / carea.clamp(min=1e-7))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element cross entropy with ``ignore_index``: returns (ce,
    valid), ce 0 where ignored; the caller reduces. logits [..., K],
    labels [...] int."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, logz - picked, torch.zeros_like(logz)), valid


def mean_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean cross entropy over the labels that are not ignored; 0 when
    none is (where ``F.cross_entropy`` gives NaN)."""
    ce, valid = softmax_cross_entropy(logits, labels, ignore_index)
    return ce.sum() / valid.sum().clamp(min=1)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor,
                                     mask: torch.Tensor = None
                                     ) -> torch.Tensor:
    """Binary cross entropy of ``logits`` against ``targets``, written
    stably as max(x, 0) - x t + log1p(exp(-|x|)): the mean over every
    element (0 for an empty input), or with ``mask`` the masked sum over
    the mask's sum (at least 1)."""
    loss = max0(logits) - logits * targets + torch.log1p(
        torch.exp(-l1(logits)))
    if mask is None:
        if loss.numel() == 0:
            return loss.new_zeros(())
        return loss.mean()
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp(min=1)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Softmax along ``dim`` with the entries outside ``mask`` at the
    dtype's most negative value; rows with no entry in the mask are all
    zeros (not NaN)."""
    neg = torch.finfo(logits.dtype).min
    out = torch.softmax(torch.where(mask, logits, neg), dim=dim)
    any_valid = mask.any(dim=dim, keepdim=True)
    return torch.where(any_valid, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """Log-softmax along ``dim`` with the entries outside ``mask`` at the
    dtype's most negative value."""
    neg = torch.finfo(logits.dtype).min
    return torch.log_softmax(torch.where(mask, logits, neg), dim=dim)


def kl_div_batchmean(log_probs: torch.Tensor,
                     target_probs: torch.Tensor) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean')``: sum(p * (log p - log q)) / B
    with 0 * log 0 = 0, written as the JAX package writes it (two
    ``where``s), so that its gradient is JAX's too."""
    pos = target_probs > 0
    zero = torch.zeros((), dtype=target_probs.dtype,
                       device=target_probs.device)
    logp = torch.where(pos, torch.log(target_probs), zero)
    elt = torch.where(pos, target_probs * (logp - log_probs), zero)
    return elt.sum() / log_probs.shape[0]


def normalize_vec(x: torch.Tensor, dim: int = -1,
                  eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp(min=eps)


def standardize_vec(x: torch.Tensor, dim: int = -1,
                    eps: float = 1e-12) -> torch.Tensor:
    mu = x.mean(dim=dim, keepdim=True)
    # jnp.std is the population std (ddof 0)
    sd = x.std(dim=dim, keepdim=True, correction=0)
    return (x - mu) / sd.clamp(min=eps)
