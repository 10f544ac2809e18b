"""The program's side of a run: set-up, the measured window and, with
``--trace 1``, the traced window, for the two loops a traffic file can
name (``"loop"``): ``train`` (training steps back to back) and
``infer`` (one client calling the evaluation step in a closed loop).

Each loop builds the program (``locov_torch``) from the cell's
configuration and the seeded weights, and returns what the window
measured and what the check needs: the losses, first gradients and
parameter changes of the first steps (``train``), or a sample of the
window's calls with their inputs and detections (``infer``), with the
proposals of those steps or calls and the RPN outputs they came from.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from . import build
from .traffic.detection import Traffic, draw_shapes, draws


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def captured(module, name: str, into: List[dict]):
    """Record every call of ``module.<name>`` (the RPN's
    ``select_proposals``: anchors, logits, deltas, the valid sizes,
    training) and its output into ``into``; the function is put back on
    exit.

    The contract with a meta-architecture of the program (any family;
    ``reference/steps.py:detect`` has the reference's side): the module
    that defines the model's class exposes ``select_proposals(anchors,
    logits, deltas, image_hw, rpn_cfg, training)`` and the model calls
    it by that module-level name once a batch, with anchors [N_a, 4],
    logits [B, N_a] and deltas [B, N_a, 4] flattened over the feature
    levels, returning a ``ProposalBatch``; a trained model trains through
    ``losses``."""
    orig = getattr(module, name)

    def wrapper(anchors, logits, deltas, image_hw, rpn_cfg,
                training=False):
        out = orig(anchors, logits, deltas, image_hw, rpn_cfg, training)
        into.append({"anchors": anchors, "logits": logits.detach(),
                     "deltas": deltas.detach(), "hw": image_hw,
                     "training": training, "out": out})
        return out
    setattr(module, name, wrapper)
    try:
        yield into
    finally:
        setattr(module, name, orig)


def model_module(model):
    """The module whose ``select_proposals`` the model calls."""
    import importlib
    return importlib.import_module(type(model).__module__)


def profile_window(run_one: Callable[[int], None], n: int, device,
                   trace_dir: str):
    """One warm-up request under the profiler's warm-up (discarded: a
    trace started cold lost kernel events), then ``n`` requests
    recorded, the host clock around them ending in a synchronisation.
    Returns (the Chrome trace's path, the traced window's seconds)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run_one(-1)
        sync(device)
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            run_one(i)
        sync(device)
        window_s = time.perf_counter() - t0
    path = os.path.join(trace_dir, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    return path, window_s


def batch_of(types, arrays: dict):
    """Host arrays -> the program's ``DetectionBatch`` of numpy arrays."""
    return types.DetectionBatch(
        images=types.ImageBatch(**arrays["images"]),
        gt=types.GtBatch(**arrays["gt"]) if "gt" in arrays else None,
        text=types.TextBatch(**arrays["text"]) if "text" in arrays
        else None)


# ----------------------------------------------------------------- train
def train(run) -> dict:
    """Training steps back to back through ``make_train_step``, batches
    through ``DevicePrefetcher``. The first ``check_steps`` steps (one a
    bucket) are set-up: they warm every shape and are the steps the
    reference follows."""
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import DevicePrefetcher, make_train_step
    from locov_torch.structures import batches as types

    dev, p = run.device, run.traffic
    marks = [("start", time.perf_counter())]
    cfg = build.program_cfg(run.config, control=run.control)
    model = build_meta_arch(cfg, device=dev)
    marks.append(("build", time.perf_counter()))
    model.load_state_dict(build.make_weights(
        model, run.seed, dev, run.config["trained_scale"]))
    marks.append(("weights", time.perf_counter()))
    optimizer, scheduler = build_optimizer(cfg, model)
    step = make_train_step(model, optimizer, scheduler,
                           cfg.TPU.CONTRASTIVE_SCOPE)
    step = run.wrap_step(step)
    traffic = Traffic(p, run.seed)
    marks.append(("pool", time.perf_counter()))
    class_emb = torch.from_numpy(traffic.class_emb).to(dev)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    ugen = torch.Generator(device=dev).manual_seed(traffic.draw_seed)
    b, n_gt = p["batch"], p["gt"]["boxes"]

    def feed():
        i = 0
        while True:
            yield batch_of(types, traffic.request(i)[1])
            i += 1
    prefetch = DevicePrefetcher(feed(), dev, depth=2)
    counter = {"i": 0}

    def one(keep=None):
        i = counter["i"]
        counter["i"] += 1
        bucket = traffic.order[i]
        u = draws(draw_shapes(cfg, b, *traffic.padded(bucket), n_gt), b,
                  ugen, dev)
        with record_function("bench.step"):
            metrics = step(next(prefetch), class_emb, gen, u)
        if keep is not None:
            keep.append({"bucket": bucket, "uniforms": u,
                         "loss": metrics["total_loss"]})
        return bucket

    rec: Dict[str, object] = {"steps": []}
    trained = {n: q for n, q in model.named_parameters() if q.requires_grad}
    p0 = {n: q.detach().clone() for n, q in trained.items()}
    props: List[dict] = []
    try:
        with captured(model_module(model), "select_proposals", props):
            for k in range(p["check_steps"]):
                one(rec["steps"])
                if k == 0:
                    rec["grad_norms"] = first_gradients(optimizer, trained,
                                                        p0)
        sync(dev)
        rec["update_norms"] = {n: float((q.detach() - p0[n]).norm())
                               for n, q in trained.items()}
        rec["losses"] = [float(s.pop("loss")) for s in rec["steps"]]
        rec["proposals"] = props
        del p0
        rec["setup_end"] = time.perf_counter()
        marks.append(("first_steps", rec["setup_end"]))
        rec["setup_parts"] = parts(marks)
        if run.trace:
            rec["trace_path"], rec["window_s"] = profile_window(
                lambda i: one(), p["trace_steps"], dev, run.trace_dir)
            first = p["check_steps"] + 1  # after the discarded warm step
            rec["window_buckets"] = traffic.order[first:first +
                                                  p["trace_steps"]]
        else:
            sync(dev)
            t0 = time.perf_counter()
            n, last, step_s = 0, t0, []
            while time.perf_counter() - t0 < run.seconds:
                bucket = one()
                n += 1
                now = time.perf_counter()
                step_s.append((bucket, now - last))
                last = now
            sync(dev)
            rec["window_s"] = time.perf_counter() - t0
            rec["requests"] = n
            rec["images"] = n * b
            rec["step_s"] = step_s
    finally:
        prefetch.close()
    rec["shapes"] = {"batch": b, "cfg": cfg, "traffic": traffic}
    run.free = [model, optimizer, scheduler, step, prefetch]
    return rec


def first_gradients(optimizer, trained, p0) -> Dict[str, float]:
    """Each trained leaf's norm of the first gradient as SGD took it,
    worked out from its state after one step: the momentum buffer (the
    gradient plus the weight decay's share) less the decay's share."""
    names = {id(q): n for n, q in trained.items()}
    out = {}
    for group in optimizer.param_groups:
        wd = group["weight_decay"]
        for q in group["params"]:
            buf = optimizer.state.get(q, {}).get("momentum_buffer")
            n = names[id(q)]
            out[n] = 0.0 if buf is None else float((buf - wd * p0[n]).norm())
    return out


# ----------------------------------------------------------------- infer
def infer(run) -> dict:
    """One client in a closed loop: each call hands ``batch`` images of
    one bucket over as host arrays to ``make_eval_step``, which copies
    them to the card, and is done when its ``Detections`` are on the
    host. A sample of calls drawn from the seed keeps its inputs, its
    detections and its proposals (with the RPN outputs they came from)
    for the check; a sampled call the window did not reach runs after
    it, outside the window."""
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import make_eval_step
    from locov_torch.structures import batches as types

    dev, p = run.device, run.traffic
    marks = [("start", time.perf_counter())]
    cfg = build.program_cfg(run.config, control=run.control)
    model = build_meta_arch(cfg, device=dev)
    marks.append(("build", time.perf_counter()))
    model.load_state_dict(build.make_weights(
        model, run.seed, dev, run.config["trained_scale"]))
    model.eval()
    marks.append(("weights", time.perf_counter()))
    step = run.wrap_step(make_eval_step(model))
    traffic = Traffic(p, run.seed)
    marks.append(("pool", time.perf_counter()))
    if cfg.TPU.INT8_EVAL and cfg.TPU.INT8_SCHEME == "static":
        calibrate(model, traffic, run.config.get("calibration", 4), dev)
    class_emb = torch.from_numpy(traffic.class_emb).to(dev)
    mod = model_module(model)
    sample = sampled_calls(p, run.seed, run.trace)
    counter = {"i": 0}
    kept: Dict[int, dict] = {}
    latencies: List[float] = []

    def call(i, timed=True):
        name, arrays = traffic.request(i)
        props: List[dict] = []
        ctx = captured(mod, "select_proposals", props) if i in sample \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx, record_function("bench.call"):
            dets = step(batch_of(types, arrays), class_emb)
            host = type(dets)(*(t.cpu() for t in dets))
        if timed:
            latencies.append((name, time.perf_counter() - t0))
        if i in sample:
            kept[i] = {"bucket": name, "arrays": arrays, "dets": host,
                       "proposals": props}

    # set-up: every bucket ``warm_calls`` times, outside the numbering
    for name in p["first"]:
        arrays = traffic.pool[name][0]
        for _ in range(p["warm_calls"]):
            dets = step(batch_of(types, arrays), class_emb)
            type(dets)(*(t.cpu() for t in dets))
    sync(dev)
    rec: Dict[str, object] = {"setup_end": time.perf_counter()}
    marks.append(("warm", rec["setup_end"]))
    rec["setup_parts"] = parts(marks)
    if run.trace:
        def one(i):
            if i < 0:  # the profiler's warm-up call, discarded
                dets = step(batch_of(types, traffic.request(0)[1]),
                            class_emb)
                type(dets)(*(t.cpu() for t in dets))
                return
            call(counter["i"])
            counter["i"] += 1
        rec["trace_path"], rec["window_s"] = profile_window(
            one, p["trace_calls"], dev, run.trace_dir)
        rec["window_buckets"] = traffic.order[:p["trace_calls"]]
        rec["latencies"] = latencies
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            call(counter["i"])
            counter["i"] += 1
        rec["window_s"] = time.perf_counter() - t0
        rec["requests"] = counter["i"]
        rec["images"] = counter["i"] * p["batch"]
        rec["latencies"] = latencies
    while counter["i"] <= max(sample):  # sampled calls past the close
        call(counter["i"], timed=False)
        counter["i"] += 1
    rec["sample"] = [kept[i] for i in sample]
    rec["shapes"] = {"batch": p["batch"], "cfg": cfg, "traffic": traffic}
    run.free = [model, step]
    return rec


def sampled_calls(p: dict, seed: int, trace: bool) -> List[int]:
    """The numbers of the calls that the check compares, drawn from the
    seed among the first ``sample_from`` (``trace_calls`` traced)."""
    rng = np.random.default_rng(seed + 2)
    span = p["trace_calls"] if trace else p["sample_from"]
    return sorted(rng.choice(span, p["sample_calls"], replace=False)
                  .tolist())


def parts(marks) -> Dict[str, float]:
    """Seconds between successive (name, time) marks, by the later
    name."""
    return {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}


def calibrate(model, traffic, n: int, device) -> None:
    """The static int8 scheme's calibration (``make_calibrate_step``)
    over ``n`` batches of the pool, every bucket in turn."""
    from locov_torch.parallel.mesh import make_calibrate_step
    from locov_torch.structures import batches as types
    step = make_calibrate_step(model)
    class_emb = torch.from_numpy(traffic.class_emb).to(device)
    names = sorted(traffic.pool)
    for i in range(n):
        pool = traffic.pool[names[i % len(names)]]
        step(batch_of(types, pool[(i // len(names)) % len(pool)]),
             class_emb)


LOOPS = {"train": train, "infer": infer}


def trace_dir() -> str:
    """A new directory for the trace under the run's ``TMPDIR``."""
    return tempfile.mkdtemp(prefix="bench_trace_")
