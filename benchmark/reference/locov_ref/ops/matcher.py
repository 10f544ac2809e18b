"""Mask-aware IoU matcher and label subsampler, batched.

Counterpart of ``locov_tpu/ops/matcher.py`` (d2's ``Matcher`` and
``subsample_labels`` as fixed-shape masked ops). Every function takes
any leading batch dimensions. The random draw is kept apart from the
selection: ``subsample_labels`` takes the two uniform vectors it ranks
by, so that a caller draws them from its own ``torch.Generator`` and a
test can hand in the JAX package's ``jax.random.uniform`` draws.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .nms import top_k


def match(quality: torch.Tensor, gt_mask: torch.Tensor,
          thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality_matches: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match each of N predictions to one of M (padded) ground truths.

    quality [..., M, N] (IoU), gt_mask [..., M] bool. ``labels[i]``
    applies to a best quality in [thresholds[i-1], thresholds[i]), with
    -inf and +inf as the outer bounds (d2 Matcher). With low-quality
    matches, the predictions that tie a gt's best quality become
    positive. Returns (matched_idx [..., N] int64, matched_label
    [..., N] int8); with no valid gt every label is ``labels[0]`` and
    every index 0."""
    thresholds, labels = list(thresholds), list(labels)
    assert len(labels) == len(thresholds) + 1
    q = torch.where(gt_mask[..., :, None], quality,
                    torch.full_like(quality, -1.0))
    matched_vals = q.amax(dim=-2)
    matched_idx = q.argmax(dim=-2)  # the first of equal maxima
    matched_label = torch.full(matched_vals.shape, labels[0],
                               dtype=torch.int8, device=q.device)
    bounds = [-float("inf")] + thresholds + [float("inf")]
    for lab, lo, hi in zip(labels, bounds[:-1], bounds[1:]):
        in_bin = (matched_vals >= lo) & (matched_vals < hi)
        matched_label = torch.where(
            in_bin, torch.full_like(matched_label, lab), matched_label)
    if allow_low_quality_matches:
        highest = q.amax(dim=-1, keepdim=True)
        is_best = (q == highest) & gt_mask[..., :, None] & (highest > 0)
        matched_label = torch.where(is_best.any(dim=-2),
                                    torch.ones_like(matched_label),
                                    matched_label)
    any_gt = gt_mask.any(dim=-1, keepdim=True)
    matched_label = torch.where(any_gt, matched_label,
                                torch.full_like(matched_label, labels[0]))
    matched_idx = torch.where(any_gt, matched_idx,
                              torch.zeros_like(matched_idx))
    return matched_idx, matched_label


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float, u_pos: torch.Tensor,
                     u_neg: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size random sample of positives (label 1) and negatives
    (label 0); -1 is ignored (d2 ``subsample_labels``). Up to
    ``int(num_samples * positive_fraction)`` positives, the rest filled
    with negatives; each kind is ranked by its uniform draw
    (``u_pos``, ``u_neg``, the shape of ``labels``), ties and the
    excluded entries (key -1) in index order as ``jax.lax.top_k`` takes
    them.

    Returns (sampled_idx [..., num_samples] int64, sampled_is_pos,
    sampled_valid [..., num_samples] bool); a slot is invalid only when
    there are fewer candidates than slots."""
    n = labels.shape[-1]
    is_pos, is_neg = labels == 1, labels == 0
    neg1 = torch.full_like(u_pos, -1.0)
    pos_keys = torch.where(is_pos, u_pos, neg1)
    neg_keys = torch.where(is_neg, u_neg, neg1)
    if n < num_samples:  # fewer candidates than slots: pad the keys
        pad = neg1.new_full(neg1.shape[:-1] + (num_samples - n,), -1.0)
        pos_keys = torch.cat([pos_keys, pad], dim=-1)
        neg_keys = torch.cat([neg_keys, pad], dim=-1)
    pos_order = top_k(pos_keys, num_samples)[1].clamp(max=n - 1)
    neg_order = top_k(neg_keys, num_samples)[1].clamp(max=n - 1)

    num_pos = is_pos.sum(-1, keepdim=True).clamp(
        max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(is_neg.sum(-1, keepdim=True),
                            num_samples - num_pos)
    slots = torch.arange(num_samples, device=labels.device)
    take_pos = slots < num_pos
    neg_slot = (slots - num_pos).clamp(0, num_samples - 1)
    sampled_idx = torch.where(take_pos, pos_order,
                              torch.gather(neg_order, -1, neg_slot))
    sampled_valid = slots < num_pos + num_neg
    return sampled_idx, take_pos & sampled_valid, sampled_valid
