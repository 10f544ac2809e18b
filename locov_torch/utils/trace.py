"""The port's spans: ``torch.profiler`` ranges, in the same trace as the
device's rows, so that they share its clock.

- ``stage(prefix, name)``: the range ``<prefix>.<name>`` around one stage
  of a model or of a step (``OvrRCNN.backbone``, ``train_step.backward``,
  ``eval.h2d``). Always on, as ``record_function`` is: a trace joins each
  kernel to the innermost stage range around its launch, and each
  backward node, through its sequence number, to the stage of the
  forward op that built it.
- ``wait(site)``: the range ``wait.<site>`` around a place where the host
  blocks on the card (a flag read, a synchronous copy). Opened only while
  a profiler is recording; otherwise a no-op context, one C call a site.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_NONE = contextlib.nullcontext()


def stage(prefix: str, name: str) -> record_function:
    """The range ``<prefix>.<name>``."""
    return record_function(f"{prefix}.{name}")


def wait(site: str):
    """The range ``wait.<site>`` while a profiler records, else nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(f"wait.{site}")
    return _NONE
