"""The training and evaluation steps on one device.

Counterpart of ``locov_tpu/parallel/mesh.py:make_train_step`` and
``make_eval_step`` without the mesh. The training step: the loss dict
of ``model.losses``, the backward of its sum, and one optimizer and
scheduler step; the backward and the update run in
``torch.profiler.record_function`` ranges ``train_step.backward`` and
``train_step.optimizer``, beside the model's ``<model>.<stage>``
ranges. The evaluation step: ``model.inference`` on the model's device.
``process_rank_world`` stands in for ``jax.process_index()`` and
``jax.process_count()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from ..structures.batches import Detections, to_torch


def process_rank_world() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``, or (0, 1) where it
    is not initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def make_eval_step(model: torch.nn.Module
                   ) -> Callable[..., Detections]:
    """Returns step(batch, class_emb) -> Detections: ``model.inference``
    under ``torch.inference_mode``, with the batch (numpy arrays or
    tensors) and ``class_emb`` moved to the model's device. Unlike JAX's
    step it takes no ``params``: the module holds its weights.
    ``step.device`` is the model's device, where the evaluation loop
    (``evaluation/evaluator.py:collect_detections``) moves each batch
    first."""
    device = next(model.parameters()).device

    def step(batch, class_emb) -> Detections:
        with torch.inference_mode():
            return model.inference(to_torch(batch, device),
                                   to_torch(class_emb, device))
    step.device = device
    return step
