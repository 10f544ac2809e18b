"""Small numeric helpers + VOC-style AP.

The port's own copy of ``locov_tpu/utils/misc.py``: ports of
``ovr/misc.py`` (dot-similarity / l2-normalize helpers) and
``ovr/utils/metrics.py`` (numpy VOC-AP helpers kept for parity; the
main eval path uses locov_torch.evaluation.coco_eval). JAX's
``compile_cache_dir`` is left out: it names XLA's persistent
compilation cache, which the port does not have.
"""
from __future__ import annotations

import re

import numpy as np


def l2_normalize_np(x: np.ndarray, axis: int = -1,
                    eps: float = 1e-12) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def dot_similarity_np(a: np.ndarray, b: np.ndarray,
                      normalize: bool = False) -> np.ndarray:
    """[N, D] x [M, D] -> [N, M] dot (optionally cosine) similarity."""
    if normalize:
        a = l2_normalize_np(a)
        b = l2_normalize_np(b)
    return a @ b.T


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """Classic VOC AP from a PR curve (utils/metrics.py behavior)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def parameter_count_table(params, max_depth: int = 2) -> str:
    """Per-module parameter counts (the reference prints a prettytable
    of these at startup; trainer.py:111 vicinity). ``params`` is a
    nested dict or a flat one, keyed by Flax paths (``a/b``) or by a
    ``state_dict``'s names (``a.b``)."""
    from .checkpoint import flatten_params
    flat = flatten_params(params)
    agg = {}
    for k, v in flat.items():
        prefix = "/".join(re.split(r"[/.]", k)[:max_depth])
        agg[prefix] = agg.get(prefix, 0) + int(np.prod(v.shape))
    total = sum(agg.values())
    lines = [f"{'module':50s} {'#params':>12s}"]
    for k in sorted(agg):
        lines.append(f"{k:50s} {agg[k]:12,d}")
    lines.append(f"{'TOTAL':50s} {total:12,d}")
    return "\n".join(lines)
