"""The training and evaluation steps, data parallel over the ranks of
``torch.distributed``, and the input prefetcher.

Counterpart of ``locov_tpu/parallel/mesh.py``: a rank of
``torch.distributed`` (one process, one device) stands for a device of
JAX's mesh. ``initialize_distributed`` joins the process group (JAX's
multi-host bootstrap). The training step: the loss dict of
``model.losses``, the backward of its sum, the gradients averaged over
the ranks by one all-reduce (JAX's ``pmean``, DDP's all-reduce; not
overlapped with the backward), one optimizer and scheduler step, and
the metrics averaged over the ranks. Its contrastive scope: "local"
(the batch-coupled losses span each rank's own images, the reference's
per-GPU semantics) or "global" (they span every rank's images, JAX's
GSPMD step over the global batch: ``GlobalBatch``). The sum of the
losses, the backward and the update run in the stage ranges
(``utils/trace.py:stage``) ``train_step.losses``,
``train_step.backward`` and ``train_step.optimizer``, beside the
model's ``<model>.<stage>`` ranges. The evaluation step:
``model.inference`` on the model's device, the batch's copy there in a
``wait.h2d_batch`` span. The calibration step of the static int8
scheme: ``model.calibrate_int8``, its max-abs buffers then
the global max over the ranks. The loss evaluation step:
``model.losses`` without gradients; the evaluation loop merges its
metrics over the ranks (``evaluation/evaluator.py:
inference_on_caption_dataset``). ``process_rank_world`` stands in for
``jax.process_index()`` and ``jax.process_count()``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..structures.batches import Detections, to_torch
from ..utils.trace import stage, wait


def process_rank_world() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``, or (0, 1) where it
    is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(dist_url: str, world_size: int, rank: int,
                           backend: str = "nccl") -> None:
    """Join the process group of ``world_size`` ranks at ``dist_url``
    (``tcp://host:port``) as ``rank``: ``backend`` NCCL where the ranks
    drive cards, gloo on the CPU. Nothing for a world of one, as JAX's
    ``initialize_distributed``."""
    if world_size > 1:
        dist.init_process_group(backend, init_method=dist_url,
                                world_size=world_size, rank=rank)


def local_url() -> str:
    """``tcp://127.0.0.1:<a free port>``: a rendezvous for ranks of one
    machine."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{sock.getsockname()[1]}"


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's ``x`` along dim 0, in rank order;
    the backward sums the gradient of the whole over the ranks and
    returns this rank's slice (what ``torch.distributed.nn.functional.
    all_gather`` computes; its backward goes through all_to_all on
    gloo, here through one all_reduce)."""

    @staticmethod
    def forward(ctx, x, batch):
        ctx.batch = batch
        return batch.gather_values(x)

    @staticmethod
    def backward(ctx, grad):
        b = ctx.batch
        grad = grad.contiguous()
        dist.all_reduce(grad)
        return grad.chunk(b.world)[b.rank], None


class GlobalBatch:
    """Every rank's images read as one batch: what the JAX package's
    global-scope step (one GSPMD program over the global batch)
    computes, written as collectives.

    ``gather`` concatenates a tensor of every rank along dim 0, in rank
    order; a floating tensor keeps its gradient, summed back over the
    ranks into each rank's slice. The MMSS heads read their regions and
    captions through it (``MMSSHeads.forward``), so each rank computes
    the whole global head loss; the gather's backward then gives each
    rank's features ``world`` times their share of its gradient, and
    the step's mean over the ranks gives every parameter the gradient of
    the global loss. ``share`` is a loss normalised by a count of the
    batch's items (``fast_rcnn_losses``): ``world * total / count
    summed over the ranks``, whose mean over the ranks is the global
    batch's mean, as JAX's global step normalises it."""

    def __init__(self):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()

    def gather_values(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point() and x.requires_grad:
            return _AllGather.apply(x, self)
        return self.gather_values(x)

    def share(self, total: torch.Tensor, count: torch.Tensor
              ) -> torch.Tensor:
        count = count.detach().to(total.dtype).clone()
        dist.all_reduce(count)
        return total * self.world / count.clamp(min=1)


def _mean_over_ranks_(tensors, world: int) -> None:
    """Average each tensor over the ranks in place: one all_reduce of
    all of them flattened into one buffer, divided by the world size."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_train_step(model: torch.nn.Module, optimizer, scheduler,
                    contrastive_scope: str = "local"
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, class_emb, generator, uniforms=None) ->
    metrics. ``model.losses`` returns a loss dict, or (outputs, losses)
    as the image-caption model does; only the losses are summed (in key
    order, as ``jax.tree.leaves`` takes a dict) into ``total_loss``, and
    the outputs (accuracies) join the metrics. The model runs with
    ``deterministic=False``, so its dropout is live and draws from
    ``generator``. The metrics are detached tensors on the device, so
    that the step waits for nothing on the host.

    Where ``torch.distributed`` runs more than one rank, each rank's
    step takes its own batch and draws; after the backward the
    gradients of the trainable parameters (zeros where a rank got none)
    are averaged over the ranks by one all-reduce, and so are the
    metrics. Under ``contrastive_scope`` "global" the model's
    losses read the batch through ``GlobalBatch``; on one rank the
    global scope is the local one. An optimizer that accumulates
    (``engine/solver.py:MultiSteps``) accumulates the rank-averaged
    gradients."""
    if contrastive_scope not in ("local", "global"):
        raise ValueError(f"TPU.CONTRASTIVE_SCOPE {contrastive_scope!r}")
    world = process_rank_world()[1]
    scope = {}
    if contrastive_scope == "global" and world > 1:
        scope["global_batch"] = GlobalBatch()
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, class_emb, generator, uniforms=None):
        optimizer.zero_grad(set_to_none=True)
        res = model.losses(batch, class_emb, generator, uniforms,
                           deterministic=False, **scope)
        outputs, losses = res if isinstance(res, tuple) else ({}, res)
        with stage("train_step", "losses"):
            total = sum(losses[k] for k in sorted(losses))
        with stage("train_step", "backward"):
            total.backward()
        metrics = {k: v.detach() for k, v in {**losses, **outputs}.items()}
        metrics["total_loss"] = total.detach()
        if world > 1:
            with stage("train_step", "all_reduce"):
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                _mean_over_ranks_([p.grad for p in params], world)
                keys = list(metrics)
                stacked = torch.stack([metrics[k].float().reshape(())
                                       for k in keys])
                _mean_over_ranks_([stacked], world)
                metrics = dict(zip(keys, stacked.unbind()))
        with stage("train_step", "optimizer"):
            # False: a MultiSteps optimizer only accumulated; the schedule
            # advances once an update
            if optimizer.step() is not False:
                scheduler.step()
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
    first. ``step.couples_ranks``: the model's (``OvrRCNN.couples_ranks``:
    the dynamic int8 scheme all-reduces its scales over the ranks), so
    the loop keeps the ranks in lockstep, running ``step.idle_pass(batch,
    class_emb)`` (``OvrRCNN.idle_pass``) on a rank whose shard is done."""
    device = next(model.parameters()).device

    def step(batch, class_emb) -> Detections:
        with torch.inference_mode():
            with wait("h2d_batch"):  # pageable host arrays: a blocking copy
                batch = to_torch(batch, device)
                class_emb = to_torch(class_emb, device)
            return model.inference(batch, class_emb)
    step.device = device
    step.couples_ranks = bool(getattr(model, "couples_ranks", False))
    if step.couples_ranks:
        def idle_pass(batch, class_emb) -> None:
            model.idle_pass(to_torch(batch, device),
                            to_torch(class_emb, device))
        step.idle_pass = idle_pass
    return step


def make_calibrate_step(model: torch.nn.Module
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, class_emb) -> {name: amax}: one int8
    calibration pass (``model.calibrate_int8`` under ``no_grad``, the
    batch moved to the model's device first). Each max-abs it records is
    all-reduced by MAX over the ranks where it is taken
    (``models/resnet.py:record_amax_``), so every rank holds the global
    running max, as JAX's replicated output of its calibration step
    does, and quantizes with it. The dict holds the buffers themselves
    by ``state_dict`` name."""
    device = next(model.parameters()).device

    def step(batch, class_emb) -> Dict[str, torch.Tensor]:
        model.calibrate_int8(to_torch(batch, device),
                             to_torch(class_emb, device))
        return model.amax_buffers()
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
