"""The training and evaluation steps on one device, and the input
prefetcher.

Counterpart of ``locov_tpu/parallel/mesh.py:make_train_step``,
``make_eval_step``, ``make_loss_eval_step`` and ``DevicePrefetcher``
without the mesh. The training step: the loss dict of ``model.losses``,
the backward of its sum, and one optimizer and scheduler step; the
backward and the update run in ``torch.profiler.record_function``
ranges ``train_step.backward`` and ``train_step.optimizer``, beside the
model's ``<model>.<stage>`` ranges. The evaluation step:
``model.inference`` on the model's device. The loss evaluation step:
``model.losses`` without gradients. ``process_rank_world`` stands in
for ``jax.process_index()`` and ``jax.process_count()``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
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


def make_loss_eval_step(model: torch.nn.Module
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, class_emb, generator, uniforms=None) ->
    metrics: the validation-loss pass (reference
    inference_on_caption_ovr_dataset, evaluator.py:99-196), the loss
    dict and the outputs of ``model.losses`` under ``torch.no_grad``
    with ``deterministic=True`` (JAX's default: the heads' dropout is
    off), the batch moved to the model's device first. The samplers'
    and the spatial dropout's draws come from ``generator`` where
    ``uniforms`` does not give them. The metrics stay tensors on the
    device."""
    device = next(model.parameters()).device

    def step(batch, class_emb, generator, uniforms=None):
        with torch.no_grad():
            res = model.losses(to_torch(batch, device),
                               to_torch(class_emb, device), generator,
                               uniforms, deterministic=True)
        outputs, losses = res if isinstance(res, tuple) else ({}, res)
        return {**losses, **outputs}
    step.device = device
    return step


JOIN_TIMEOUT_S = 10.0  # the prefetch thread may be inside a loader step


class DevicePrefetcher:
    """Host->device input pipelining on one device: a background thread
    pulls host batches (numpy) from ``it`` and moves them to ``device``,
    keeping up to ``depth`` batches in flight, so that JPEG decode,
    collate and the copy overlap the step. On a CUDA device each array
    is pinned and copied on a side stream; ``next()`` makes the
    caller's stream wait on the copy's event and marks the tensors as
    used there (``record_stream``), so that the allocator does not hand
    their memory to the side stream while a step still reads it. The
    bytes of a batch are not changed. ``close()`` stops the thread: it
    lets a put that waits on a full queue through, joins with a
    timeout and puts the end sentinel; a consumer that calls ``next()``
    afterwards gets ``StopIteration``."""

    def __init__(self, it: Iterator, device, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = object()
        self._done = False
        self._closing = threading.Event()
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(self.device) if cuda else None

        def move(batch):
            if not cuda:
                return to_torch(batch, self.device), None
            with torch.cuda.stream(stream):
                out = _pinned_copy(batch, self.device)
                event = torch.cuda.Event()
                event.record(stream)
            return out, event

        def put(item) -> bool:
            while not self._closing.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in it:
                    if self._closing.is_set() or not put(move(batch)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                put(e)
                return
            put(self._stop)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        # iterator protocol: once exhausted (or errored, or closed),
        # every further next() must raise again
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._stop:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            _record_stream(batch, current)
        return batch

    def close(self) -> None:
        """Stop the prefetch thread: drain the queue so that a blocked
        put returns, join with a timeout, put the end sentinel."""
        self._closing.set()
        self._drain()
        self._thread.join(JOIN_TIMEOUT_S)
        self._drain()
        try:
            self._q.put_nowait(self._stop)
        except queue.Full:  # a put that was under way when we drained
            pass

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return


def _pinned_copy(batch, device):
    """A (nested) NamedTuple of numpy arrays on ``device``, each array
    copied through pinned memory without blocking the host thread
    (call on the stream the copy should run on)."""
    if batch is None:
        return None
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_pinned_copy(v, device) for v in batch))
    host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
    return host.to(device, non_blocking=True)


def _record_stream(batch, stream) -> None:
    if batch is None:
        return
    if isinstance(batch, tuple):
        for v in batch:
            _record_stream(v, stream)
        return
    batch.record_stream(stream)
