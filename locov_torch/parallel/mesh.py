"""The training step on one device.

Counterpart of ``locov_tpu/parallel/mesh.py:make_train_step`` without
the mesh: the loss dict of ``model.losses``, the backward of its sum,
and one optimizer and scheduler step. The backward and the update run
in ``torch.profiler.record_function`` ranges ``train_step.backward``
and ``train_step.optimizer``, beside the model's ``<model>.<stage>``
ranges.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.profiler import record_function


def make_train_step(model: torch.nn.Module, optimizer, scheduler
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, class_emb, generator, uniforms=None) ->
    metrics. ``model.losses`` returns a loss dict, or (outputs, losses)
    as the image-caption model does; only the losses are summed (in key
    order, as ``jax.tree.leaves`` takes a dict) into ``total_loss``, and
    the outputs (accuracies) join the metrics. The model runs with
    ``deterministic=False``, so its dropout is live and draws from
    ``generator``. The metrics are detached tensors on the device, so
    that the step waits for nothing on the host."""

    def step(batch, class_emb, generator, uniforms=None):
        optimizer.zero_grad(set_to_none=True)
        res = model.losses(batch, class_emb, generator, uniforms,
                           deterministic=False)
        outputs, losses = res if isinstance(res, tuple) else ({}, res)
        total = sum(losses[k] for k in sorted(losses))
        with record_function("train_step.backward"):
            total.backward()
        with record_function("train_step.optimizer"):
            optimizer.step()
            scheduler.step()
        metrics = {k: v.detach() for k, v in {**losses, **outputs}.items()}
        metrics["total_loss"] = total.detach()
        return metrics
    return step
