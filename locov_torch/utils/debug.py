"""NaN forensics: the counterpart of ``locov_tpu/utils/debug.py`` (the
reference's ``LoggedModule``, ``ovr/modeling/logged_module.py``, keeps
min/max/mean/std of named tensors so that a NaN loss can name its
culprit).

- ``tensor_stats``: the min, max, mean and (population) std of a tensor
  as a dict of 0-d tensors, which a model can fold into its metrics;
- ``nan_guard``: prints those stats when a tensor is not finite;
- ``enable_nan_debugging``: autograd's anomaly mode, the counterpart of
  JAX's ``jax_debug_nans`` (``TPU.DEBUG_NANS``): a backward that makes a
  NaN raises and names the forward operation that made it.
"""
from __future__ import annotations

from typing import Dict

import torch


def tensor_stats(name: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """min/max/mean/std of ``x`` in float32 (LoggedModule.log)."""
    xf = x.float()
    return {f"{name}/min": xf.min(), f"{name}/max": xf.max(),
            f"{name}/mean": xf.mean(), f"{name}/std": xf.std(correction=0)}


def nan_guard(name: str, x: torch.Tensor,
              enabled: bool = True) -> torch.Tensor:
    """``x``, after printing its stats if any element is not finite. The
    check reads one flag on the host, so on the card it waits for the
    work queued before it (JAX prints from inside the program)."""
    if not enabled:
        return x
    xf = x.detach().float()
    if not bool(torch.isfinite(xf).all()):
        print(f"NaN-guard [{name}]: finite=False min={xf.min().item()} "
              f"max={xf.max().item()} mean={xf.mean().item()}", flush=True)
    return x


def enable_nan_debugging() -> None:
    """Global fail-fast NaN mode (``TPU.DEBUG_NANS``): autograd's anomaly
    detection, as ``jax_debug_nans`` is JAX's."""
    torch.autograd.set_detect_anomaly(True)
