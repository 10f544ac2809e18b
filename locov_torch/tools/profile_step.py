"""Profile a step of the port and print a per-subsystem time table. Twin
of ``tools/profile_step.py``.

    python -m locov_torch.tools.profile_step [--mode lsm_train|stt_eval]
        [--steps 6] [--by subsystem|stage|kernel] [--top 30]
        [--trace-dir DIR] [--device cpu]

The step is the bench twin's workload (``tools/bench.py``):
``--mode lsm_train`` the LSM training step (``build_full``: batch 4 of
800 x 1344, coco_lsm.yaml in bfloat16, through ``build_optimizer`` and
``make_train_step``), ``stt_eval`` STT inference (``build_stt_eval``:
batch 8, through ``make_eval_step``). Three warm steps run first, then
one under the profiler's warm-up (discarded), then ``--steps`` steps
recorded by ``torch.profiler``, whose Chrome trace is
written to a new temporary directory (its path goes to stderr) and
parsed. ``--trace-dir`` parses the newest trace under DIR instead of
running (``--steps`` then says how many steps it holds).

Rows are the work the device did: on the card each kernel, memcpy and
memset; on the CPU each operator's exclusive time. Nested rows take
JAX's exclusive-time rule (a row's time less the rows nested in it,
within one thread or stream). A kernel belongs to the host context it
was launched from (the operators and ``record_function`` ranges around
its launch, found by its correlation id); the ``<model>.<stage>`` and
``train_step.<stage>`` ranges there map it to JAX's ``SUBSYSTEMS``
buckets. Any row whose kernel or launching operator names ROIAlign goes
to ``roi_align``, so K3-bwd, which autograd launches from its own
thread outside every range, lands there too; the other kernels of
autograd's thread, and those under ``train_step.backward``, are
``backward (unattributed)``. The host column is the exclusive time of
the stage ranges of a bucket on the host, ``other`` taking the rest of
the step's wall time: on this card the host sets the pace of a step.

``--by``: ``subsystem`` (the buckets), ``stage`` (the innermost
``record_function`` stage range) or ``kernel`` (the kernel's name);
``stage`` and ``kernel`` stand where JAX's ``source``, ``tf_op`` and
``category`` (XLA op metadata) have no torch counterpart.

The backward splits by the forward stage that built each node
(``backward_split``): a row of ``backward (unattributed)`` goes, through
the ``autograd::engine::evaluate_function`` event around its launch,
that event's ``Sequence number`` and the forward op with the same number
on the thread ``Fwd thread id`` names, to the innermost stage range
around that op; its bucket is one of ``BACKWARD_BUCKETS``,
``parameters`` (``AccumulateGrad``, which has no number) or
``unattributed``. ``wait_spans`` counts the ``wait.<site>`` spans
(``utils/trace.py:wait``: the host blocked on the card) and their ms;
``idle_gaps`` names each of the card's idle gaps by the innermost stage
range on the stepping thread, and one inside ``train_step.backward`` by
the stage of the autograd node running at its middle (``backward
<stage>``, ``backward parameters`` or ``backward unattributed``). These
three go to stderr as tables and into the JSON line (``backward``,
``waits``, ``idle_gaps``).

Prints the table (bucket, ms a step, %, host ms a step, heaviest op),
then one JSON line: the mode, steps, the device (``timing.describe``),
busy ms a step (the rows' sum), the idle share against the step's wall
time, what the rows are (``rows``: card kernels or cpu operators; a
card's trace parses on the CPU too), and each bucket's ms, host ms and
heaviest op; ``hand_kernels``
says in which buckets the port's own kernels ran, and how often; then
``backward``, ``waits`` and ``idle_gaps`` (above). Runs on ``cuda``
unless ``--device cpu`` is given.

``profile`` and ``stage_line`` are also ``chip_smoke.py``'s profiler:
``stage_line`` gives its ``*_profile`` lines.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time

import torch

from ..ops import kernel_lib
from ..utils.device import resolve_device
from .bench import build_full, build_stt_eval
from .timing import describe, sync

# The buckets of JAX's tool (keyed there on XLA source files), filled
# here from the stage ranges: (bucket, the stages after "<model>." or
# "train_step.").
SUBSYSTEMS = (
    ("backbone", ("backbone",)),
    ("res5", ("roi_features", "grid_features")),
    ("rpn+nms", ("rpn_head", "rpn_losses", "select_proposals",
                 "fast_rcnn_inference")),
    ("mmss_heads", ("grid_mmss", "box_mmss", "fused_mmss", "distill")),
    ("language", ("language",)),
    ("optimizer", ("optimizer",)),
    ("boxes/match", ("label_and_sample", "predict", "roi_heads_losses")),
    ("backward (unattributed)", ("backward",)),
    # ViTDetRCNN's own stages (the attention nested in its backbone)
    ("window_attn", ("window_attention",)),
    ("global_attn", ("global_attention",)),
    ("pyramid", ("pyramid",)),
    ("box_head", ("box_head",)),
)
BUCKET_OF_STAGE = {s: b for b, stages in SUBSYSTEMS for s in stages}
ROI_ALIGN = "roi_align"  # kernels and operators named so: their own bucket
BACKWARD = "backward (unattributed)"
OTHER = "other"
STAGE_PREFIXES = ("OvrRCNN.", "DistillProposalMMSSRCNN.", "MMSSGridModel.",
                  "ViTDetRCNN.", "train_step.", "eval.")
# the port's hand-written kernels (locov_torch/csrc/*.cu)
HAND_KERNELS = kernel_lib.DEVICE_FUNCTIONS
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the backward's buckets: (bucket, the forward stages whose nodes it holds)
BACKWARD_BUCKETS = (
    ("trunk", ("backbone",)),
    ("res5", ("roi_features", "grid_features")),
    ("mmss", ("grid_mmss", "box_mmss", "fused_mmss", "distill")),
    ("language", ("language",)),
    ("rpn", ("rpn_head", "rpn_losses")),
    ("boxes", ("label_and_sample", "predict", "box_regions")),
)
BACKWARD_BUCKET_OF_STAGE = {s: b for b, stages in BACKWARD_BUCKETS
                            for s in stages}
PARAMETERS = "parameters"
UNATTRIBUTED = "unattributed"
EVALUATE = "autograd::engine::evaluate_function"
WAIT = "wait."


def profile(run, device: torch.device, steps: int = 1, trace_path=None,
            warmup: int = 0):
    """``run()`` ``steps`` times under torch.profiler (CPU activity, and
    CUDA on the card), the host clock around them ending in a
    synchronisation. ``warmup`` runs before them go under the profiler's
    warm-up, their events discarded: a trace started cold can lack the
    first kernels launched (seen on the card: a launch with no kernel
    event). Writes the Chrome trace to ``trace_path`` where given.
    Returns (the profiler, wall ms)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import schedule
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with torch_profile(activities=activities, schedule=schedule(
            wait=0, warmup=warmup, active=1) if warmup else None) as prof:
        for _ in range(warmup):
            run()
            sync(device)
            prof.step()  # after the last, recording to the block's end
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    return prof, wall_ms


def stage_line(phase, prof, wall_ms, unprofiled_ms) -> dict:
    """One profiled run as a line: the device's busy time (the sum of
    its kernels' times) against the wall time, the kernels that take the
    most of it, and for each stage range (``STAGE_PREFIXES``: the
    models' ``<model>.<stage>``, ``train_step.<stage>``,
    ``eval.<stage>``) its host time and the device time of the
    kernels launched in it (kernels that autograd launches from its own
    thread belong to no range: ``unattributed_kernels_ms``). The
    profiler stretches the wall time, so the idle share is also given
    against ``unprofiled_ms``, the same run's time unprofiled."""
    from torch.autograd import DeviceType

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    events = prof.key_averages()
    ranges = [e for e in events if e.key.startswith(STAGE_PREFIXES)]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    stages = {}
    for e in ranges:
        st = stages.setdefault(e.key.split(".", 1)[1], {})
        if e.device_type == DeviceType.CUDA:  # the range on the device
            st["device_span_ms"] = device_us(e) / 1e3
        else:
            st["host_ms"] = e.cpu_time_total / 1e3
            st["device_kernels_ms"] = device_us(e) / 1e3
    attributed = sum(st.get("device_kernels_ms", 0.0)
                     for st in stages.values())
    return {"phase": phase, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "stages": stages,
            "unattributed_kernels_ms": busy_ms - attributed,
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


# ----------------------------------------------------------- the trace
def exclusive_times(rows) -> None:
    """JAX's rule (``tools/profile_step.py:parse_trace``): each row's
    ``self`` is its ``dur`` less the rows nested in it, flame-graph
    style. Rows are dicts with ``ts`` and ``dur`` (microseconds), of one
    thread or stream; sorted in place."""
    rows.sort(key=lambda r: (r["ts"], -r["dur"]))
    stack = []
    for r in rows:
        r["self"] = r["dur"]
        end = r["ts"] + r["dur"]
        while stack and stack[-1][0] <= r["ts"]:
            stack.pop()
        if stack and end <= stack[-1][0] + 1e-3:
            stack[-1][1]["self"] -= r["dur"]
        stack.append((end, r))
    for r in rows:
        r["self"] = max(r["self"], 0)


def _lanes(events):
    lanes = collections.defaultdict(list)
    for e in events:
        lanes[(e["pid"], e["tid"])].append(e)
    return lanes


def _contexts(intervals, times):
    """For each time in ``times``, the names of the ``intervals`` (one
    thread's) that contain it, outermost first."""
    iv = sorted(intervals, key=lambda e: (e["ts"], -e["dur"]))
    out = [()] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(iv) and iv[j]["ts"] <= t:
            stack.append((iv[j]["ts"] + iv[j]["dur"], iv[j]["name"]))
            j += 1
        stack = [s for s in stack if s[0] > t]
        out[i] = tuple(name for _, name in stack)
    return out


def trace_file(trace_dir: str) -> str:
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise SystemExit(f"no trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_events(path: str):
    """The complete events of a Chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]


def parse_trace(path: str):
    """``parse_events`` of the trace at ``path``."""
    return parse_events(load_events(path))


def parse_events(events):
    """A Chrome trace's complete events -> (rows, host ranges, wall us).
    Rows: the device's work, each a dict with ``name``, ``self`` (us,
    exclusive), ``context`` (the names of the host operators and ranges
    it was launched from, outermost first) and ``launch`` (its launch's
    thread and time). On a trace without device events the rows are the
    CPU operators. Host ranges: the stage ranges with their exclusive
    host time. Wall: the trace's span."""
    host = [e for e in events if e.get("cat") in HOST_CATS]
    device = [dict(e) for e in events if e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    host_lanes = _lanes(host)
    if device:
        for lane in _lanes(device).values():
            exclusive_times(lane)
        by_thread = collections.defaultdict(list)
        for r in device:
            src = launch.get(r.get("args", {}).get("correlation"))
            thread = None if src is None else (src["pid"], src["tid"])
            by_thread[thread].append((r, src))
        for thread, items in by_thread.items():
            ctx = _contexts(host_lanes.get(thread, []),
                            [src["ts"] for _, src in items]) \
                if thread is not None else [()] * len(items)
            for (r, src), c in zip(items, ctx):
                r["context"] = c
                r["launch"] = None if src is None else (thread, src["ts"])
        rows = device
    else:
        rows = [dict(e) for e in host if e.get("cat") == "cpu_op"]
        for thread, lane in _lanes(rows).items():
            exclusive_times(lane)
            ctx = _contexts(host_lanes[thread], [r["ts"] for r in lane])
            for r, c in zip(lane, ctx):
                r["context"] = c
                r["launch"] = (thread, r["ts"])
    ranges = [dict(e) for e in host if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE_PREFIXES)]
    for lane in _lanes(ranges).values():
        exclusive_times(lane)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    wall = (max(b for _, b in spans) - min(a for a, _ in spans)) \
        if spans else 0.0
    return rows, ranges, wall


def innermost_stage(context) -> str:
    for name in reversed(context):
        if name.startswith(STAGE_PREFIXES):
            return name
    return ""


def classify(row) -> str:
    """The bucket of one row (see the module's docstring)."""
    if ROI_ALIGN in row["name"] or any(ROI_ALIGN in n
                                       for n in row["context"]):
        return ROI_ALIGN
    stage = innermost_stage(row["context"])
    if stage:
        return BUCKET_OF_STAGE.get(stage.split(".", 1)[1], OTHER)
    if any(n.startswith("autograd::engine") for n in row["context"]):
        return BACKWARD
    return OTHER


def hand_kernel(name: str) -> str:
    for k in HAND_KERNELS:
        if re.search(rf"\b{k}\b", name):
            return k
    return ""


def table(rows, ranges, wall_us, steps, by="subsystem") -> dict:
    """Per key of ``by``: device ms a step, host ms a step and the
    heaviest row; plus the totals. The buckets' ms sum to ``busy_ms``;
    under ``subsystem`` and ``stage`` their host ms sum to ``wall_ms``
    (``other`` or "(none)" takes what no stage range holds)."""
    keyfn = {"subsystem": classify,
             "stage": lambda r: innermost_stage(r["context"]) or "(none)",
             "kernel": lambda r: r["name"]}[by]
    agg = collections.defaultdict(float)
    heaviest = {}
    hand = collections.defaultdict(collections.Counter)
    for r in rows:
        key = keyfn(r)
        agg[key] += r["self"]
        if r["self"] > heaviest.get(key, (-1.0, ""))[0]:
            heaviest[key] = (r["self"], r["name"][:60])
        k = hand_kernel(r["name"])
        if k:
            hand[k][classify(r)] += 1
    host = collections.defaultdict(float)
    if by != "kernel":
        rest = OTHER if by == "subsystem" else "(none)"
        for e in ranges:
            key = BUCKET_OF_STAGE.get(e["name"].split(".", 1)[1], OTHER) \
                if by == "subsystem" else e["name"]
            host[key] += e["self"]
        host[rest] += wall_us - sum(host.values())
    buckets = {k: {"ms": agg.get(k, 0.0) / 1e3 / steps,
                   "host_ms": (None if by == "kernel"
                               else host.get(k, 0.0) / 1e3 / steps),
                   "heaviest": heaviest.get(k, (0, ""))[1]}
               for k in sorted(set(agg) | set(host),
                               key=lambda k: -agg.get(k, 0.0))}
    busy = sum(r["self"] for r in rows) / 1e3 / steps
    return {"busy_ms": busy, "wall_ms": wall_us / 1e3 / steps,
            "buckets": buckets,
            "hand_kernels": {k: dict(v) for k, v in sorted(hand.items())}}


def print_table(result, top, rows_are) -> None:
    print(f"{'bucket':<44} {'ms/step':>9} {'%':>6} {'host ms':>9}"
          f"   heaviest op")
    total = result["busy_ms"]
    for k, v in list(result["buckets"].items())[:top]:
        host = "" if v["host_ms"] is None else f"{v['host_ms']:.2f}"
        share = 100 * v["ms"] / total if total else 0.0
        print(f"{k[:44]:<44} {v['ms']:>9.2f} {share:>5.1f}% {host:>9}"
              f"   {v['heaviest']}")
    print(f"{f'TOTAL ({rows_are})':<44} {total:>9.2f} "
          f"100.0% {result['wall_ms']:>9.2f}   (host: the step's wall "
          f"time)")


# ---------------------------------------------- the backward and waits
def _innermost(intervals, times):
    """For each time in ``times``, the innermost of ``intervals`` (one
    thread's events) that contains it, or None."""
    iv = sorted(intervals, key=lambda e: (e["ts"], -e["dur"]))
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(iv) and iv[j]["ts"] <= t:
            stack.append(iv[j])
            j += 1
        stack = [e for e in stack if e["ts"] + e["dur"] > t]
        out[i] = stack[-1] if stack else None
    return out


def _lane(e):
    return (e["pid"], e["tid"])


def _is_forward(e) -> bool:
    a = e.get("args", {})
    return e.get("cat") == "cpu_op" and "Sequence number" in a and \
        not a.get("Fwd thread id") and not e["name"].startswith("autograd::")


def _nodes(events):
    return [e for e in events if e.get("cat") == "cpu_op"
            and e["name"].startswith(EVALUATE)]


def node_stages(events) -> dict:
    """``id`` of each ``evaluate_function`` event -> the stage range
    that built its node: the innermost stage range around the last
    forward op (``Fwd thread id`` 0) before the node with its
    ``Sequence number``, on the thread holding most of the numbers of
    the node's ``Fwd thread id``; ``parameters`` for ``AccumulateGrad``
    (no number); "" where none is found."""
    nodes = _nodes(events)
    fwd = collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        if _is_forward(e):
            fwd[_lane(e)][e["args"]["Sequence number"]].append((e["ts"], e))
    for by_seq in fwd.values():
        for ops in by_seq.values():
            ops.sort(key=lambda p: p[0])
    votes = collections.defaultdict(collections.Counter)
    for n in nodes:
        a = n["args"]
        if "Sequence number" in a:
            for lane, by_seq in fwd.items():
                if a["Sequence number"] in by_seq:
                    votes[a.get("Fwd thread id")][lane] += 1
    thread = {f: c.most_common(1)[0][0] for f, c in votes.items()}
    out, found = {}, collections.defaultdict(list)
    for n in nodes:
        a = n["args"]
        if "Sequence number" not in a:
            out[id(n)] = PARAMETERS if "AccumulateGrad" in n["name"] else ""
            continue
        lane = thread.get(a.get("Fwd thread id"))
        ops = fwd.get(lane, {}).get(a["Sequence number"], [])
        k = bisect.bisect_left(ops, n["ts"], key=lambda p: p[0])
        if k == 0:
            out[id(n)] = ""
        else:
            found[lane].append((id(n), ops[k - 1][1]))
    ranges = _lanes([e for e in events if e.get("cat") == "user_annotation"])
    for lane, items in found.items():
        ctx = _contexts(ranges.get(lane, []), [op["ts"] for _, op in items])
        for (key, _), c in zip(items, ctx):
            out[key] = innermost_stage(c)
    return out


def backward_bucket(stage: str) -> str:
    if stage == PARAMETERS:
        return PARAMETERS
    return BACKWARD_BUCKET_OF_STAGE.get(stage.split(".", 1)[1],
                                        UNATTRIBUTED) if stage \
        else UNATTRIBUTED


def backward_split(events, rows, steps: int) -> dict:
    """The rows of ``backward (unattributed)`` by the forward stage that
    built their node: ``buckets`` and ``stages`` (ms a step), ``ops``
    (rows launched inside autograd's engine a step, ROIAlign's
    included), ``nodes`` and ``mapped`` (numbered nodes in the trace,
    those traced to a stage)."""
    stage_of = node_stages(events)
    nodes = _lanes(_nodes(events))
    mine = collections.defaultdict(list)
    ops = 0
    for r in rows:
        if any(n.startswith("autograd::engine") for n in r["context"]):
            ops += 1
        if classify(r) == BACKWARD and r.get("launch") is not None:
            mine[r["launch"][0]].append(r)
    buckets = collections.defaultdict(float)
    stages = collections.defaultdict(float)
    for lane, items in mine.items():
        around = _innermost(nodes.get(lane, []),
                            [r["launch"][1] for r in items])
        for r, n in zip(items, around):
            stage = stage_of.get(id(n), "") if n is not None else ""
            buckets[backward_bucket(stage)] += r["self"] / 1e3 / steps
            stages[stage or UNATTRIBUTED] += r["self"] / 1e3 / steps
    numbered = [k for k, v in stage_of.items() if v != PARAMETERS]
    return {"buckets": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
            "stages": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
            "ops": ops / steps, "nodes": len(numbered),
            "mapped": sum(1 for k in numbered if stage_of[k])}


def wait_spans(events, steps: int) -> dict:
    """The ``wait.<site>`` spans: {site: {"count", "ms"}} a step."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(WAIT):
            site = out.setdefault(e["name"][len(WAIT):],
                                  {"count": 0.0, "ms": 0.0})
            site["count"] += 1 / steps
            site["ms"] += e["dur"] / 1e3 / steps
    return out


def idle_gaps(events, rows, steps: int, top: int = 10) -> dict:
    """The card's idle gaps (ms a step) between its first and last row,
    named by the innermost stage range on the thread that holds the
    stage ranges, at the gap's middle; a gap inside
    ``train_step.backward`` by the stage of the autograd node running
    then (``backward <stage>``). Empty without device rows."""
    dev = [r for r in rows if r.get("cat") in DEVICE_CATS]
    if not dev:
        return {}
    spans, t = [], min(r["ts"] for r in dev)
    for r in sorted(dev, key=lambda r: r["ts"]):
        if r["ts"] > t:
            spans.append((t, r["ts"]))
        t = max(t, r["ts"] + r["dur"])
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE_PREFIXES)]
    if not spans or not ranges:
        return {}
    main = collections.Counter(_lane(e) for e in ranges).most_common(1)[0][0]
    mids = [(a + b) / 2 for a, b in spans]
    ctx = _contexts([e for e in ranges if _lane(e) == main], mids)
    stage_of = node_stages(events)
    running = {}
    for lane, lane_nodes in _lanes(_nodes(events)).items():
        for m, n in zip(mids, _innermost(lane_nodes, mids)):
            if n is not None:
                running[m] = n
    out = collections.defaultdict(float)
    for (a, b), m, c in zip(spans, mids, ctx):
        name = innermost_stage(c) or "(no stage)"
        if name == "train_step.backward":
            n = running.get(m)
            stage = stage_of.get(id(n), "") if n is not None else ""
            name = f"backward {stage or UNATTRIBUTED}"
        out[name] += (b - a) / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def print_spans(line, file=sys.stderr) -> None:
    """The backward split, the waits and the idle gaps as tables."""
    bwd = line["backward"]
    total = sum(bwd["buckets"].values())
    print(f"# backward by forward stage: {bwd['mapped']} of {bwd['nodes']} "
          f"numbered nodes traced; {bwd['ops']:.0f} rows a step in "
          "autograd's engine", file=file)
    for k, v in bwd["buckets"].items():
        share = 100 * v / total if total else 0.0
        print(f"#   {k:<54} {v:>9.2f} ms {share:>5.1f}%", file=file)
    for k, v in line["waits"].items():
        print(f"# wait.{k:<52} {v['count']:>7.1f} a step {v['ms']:>9.2f} ms",
              file=file)
    for k, v in line["idle_gaps"].items():
        print(f"# idle {k:<52} {v:>9.2f} ms", file=file)


# ------------------------------------------------------------ the step
def make_step(mode: str, device: torch.device):
    """A callable that runs one step of ``mode`` on ``device``."""
    if mode == "stt_eval":
        from ..parallel.mesh import make_eval_step
        _, model, data, class_emb = build_stt_eval(device=device)
        step = make_eval_step(model)
        return lambda: step(data, class_emb)
    from ..engine.solver import build_optimizer
    from ..parallel.mesh import make_train_step
    cfg, model, data, class_emb = build_full(device=device)
    step = make_train_step(model, *build_optimizer(cfg, model))
    gen = torch.Generator(device=device).manual_seed(0)
    return lambda: step(data, class_emb, gen)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--by", default="subsystem",
                    choices=["subsystem", "stage", "kernel"])
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace-dir", default=None,
                    help="parse an existing trace instead of running")
    ap.add_argument("--mode", default="lsm_train",
                    choices=["lsm_train", "stt_eval"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    trace_dir, wall_ms = args.trace_dir, None
    if trace_dir is None:
        run = make_step(args.mode, device)
        for _ in range(3):  # warm-up: cuDNN plans, allocator, caches
            run()
        trace_dir = tempfile.mkdtemp(prefix=f"{args.mode}_trace_")
        _, wall_ms = profile(run, device, args.steps, os.path.join(
            trace_dir, f"{args.mode}.pt.trace.json.gz"), warmup=1)
        print(f"# trace: {trace_dir}", file=sys.stderr)
    events = load_events(trace_file(trace_dir))
    rows, ranges, span_us = parse_events(events)
    rows_are = ("card kernels" if any(r.get("cat") in DEVICE_CATS
                                      for r in rows) else "cpu operators")
    result = table(rows, ranges,
                   span_us if wall_ms is None else wall_ms * 1e3,
                   args.steps, args.by)
    print_table(result, args.top, rows_are)
    line = {"metric": "profile_step", "mode": args.mode,
            "steps": args.steps, "by": args.by, **describe(device),
            "rows": rows_are,
            "wall_from": "trace" if wall_ms is None else "host_clock",
            "busy_ms": result["busy_ms"], "wall_ms": result["wall_ms"],
            "idle_share": 1.0 - result["busy_ms"] / result["wall_ms"],
            "buckets": result["buckets"],
            "hand_kernels": result["hand_kernels"], "trace": trace_dir,
            "backward": backward_split(events, rows, args.steps),
            "waits": wait_spans(events, args.steps),
            "idle_gaps": idle_gaps(events, rows, args.steps)}
    print_spans(line)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
