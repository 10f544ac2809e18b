"""Vector normalizations used by the embedding box predictor.

The inference subset of ``locov_tpu/ops/losses.py``; the losses come
with the training slice.
"""
from __future__ import annotations

import torch


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
