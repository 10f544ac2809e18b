"""The backward split and the host's waits, read from the same
torch.profiler Chrome trace as ``trace.py``: a frozen copy of the join
in the port's ``tools/profile_step.py`` (``node_stages``,
``backward_split``, ``wait_spans``), plus two checks of the trace
(``unspanned_syncs``, ``clock_excess``).

A device row that autograd launched (``trace.classify`` puts it under
``backward (unattributed)``) is traced back to the forward stage that
built its node: its launch by ``correlation``; the
``autograd::engine::evaluate_function`` event around that launch; that
event's ``Sequence number``; the forward ``cpu_op`` with the same
number on the thread that ``Fwd thread id`` names (the last one before
the node ran; a forward op carries ``Fwd thread id`` 0); the innermost
stage range around that op. ``AccumulateGrad`` nodes have no number:
``parameters``. Rows under ROIAlign stay out, as ``classify`` has them.

``wait.<site>`` ranges are the program's spans around a host read of the
card (``locov_torch/utils/trace.py:wait``), recorded only under a
profiler.
"""
from __future__ import annotations

import bisect
import collections
import sys
from typing import Dict, List, Optional, Tuple

from . import trace

BACKWARD_BUCKETS = trace.stage_tables()["backward"]  # benchmark/stages/
BUCKET_OF_STAGE = {s: b for b, stages in BACKWARD_BUCKETS for s in stages}
PARAMETERS = "parameters"
UNATTRIBUTED = "unattributed"
EVALUATE = "autograd::engine::evaluate_function"
ACCUMULATE = "AccumulateGrad"
WAIT = "wait."
MARKS = ("bench.step", "bench.call")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
         "cuEventSynchronize")


def _innermost(intervals, times) -> List[Optional[dict]]:
    """For each time in ``times``, the innermost of ``intervals`` (one
    thread's events) that contains it, or None."""
    iv = sorted(intervals, key=lambda e: (e["ts"], -e["dur"]))
    out: List[Optional[dict]] = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(iv) and iv[j]["ts"] <= t:
            stack.append(iv[j])
            j += 1
        stack = [e for e in stack if e["ts"] + e["dur"] > t]
        out[i] = stack[-1] if stack else None
    return out


def _lane(e) -> Tuple[int, int]:
    return (e["pid"], e["tid"])


def _is_forward(e) -> bool:
    a = e.get("args", {})
    return e.get("cat") == "cpu_op" and "Sequence number" in a and \
        not a.get("Fwd thread id") and not e["name"].startswith("autograd::")


def node_stages(events) -> Dict[int, str]:
    """``id`` of each ``evaluate_function`` event -> the stage range that
    built its node (``<model>.<stage>`` or ``train_step.<stage>``),
    ``PARAMETERS`` for ``AccumulateGrad``, ``""`` where none is found."""
    nodes = [e for e in events if e.get("cat") == "cpu_op"
             and e["name"].startswith(EVALUATE)]
    fwd: Dict[Tuple[int, int], Dict[int, List[Tuple[float, dict]]]] = \
        collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        if _is_forward(e):
            fwd[_lane(e)][e["args"]["Sequence number"]].append((e["ts"], e))
    for by_seq in fwd.values():
        for ops in by_seq.values():
            ops.sort(key=lambda p: p[0])
    # the forward thread of each ``Fwd thread id``: the lane holding the
    # most of its nodes' numbers
    votes: Dict[int, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for n in nodes:
        a = n["args"]
        if "Sequence number" in a:
            for lane, by_seq in fwd.items():
                if a["Sequence number"] in by_seq:
                    votes[a.get("Fwd thread id")][lane] += 1
    thread = {f: c.most_common(1)[0][0] for f, c in votes.items()}
    out: Dict[int, str] = {}
    found: Dict[Tuple[int, int], List[Tuple[int, dict]]] = \
        collections.defaultdict(list)
    for n in nodes:
        a = n["args"]
        if "Sequence number" not in a:
            out[id(n)] = PARAMETERS if ACCUMULATE in n["name"] else ""
            continue
        lane = thread.get(a.get("Fwd thread id"))
        ops = fwd.get(lane, {}).get(a["Sequence number"], [])
        k = bisect.bisect_left(ops, n["ts"], key=lambda p: p[0])
        if k == 0:
            out[id(n)] = ""
            continue
        found[lane].append((id(n), ops[k - 1][1]))
    ranges = trace._lanes([e for e in events
                           if e.get("cat") == "user_annotation"])
    for lane, items in found.items():
        ctx = trace._contexts(ranges.get(lane, []),
                              [op["ts"] for _, op in items])
        for (key, _), c in zip(items, ctx):
            out[key] = trace.innermost_stage(c)
    return out


def bucket_of(stage: str) -> str:
    if stage == PARAMETERS:
        return PARAMETERS
    return BUCKET_OF_STAGE.get(stage.split(".", 1)[1], UNATTRIBUTED) \
        if stage else UNATTRIBUTED


def backward_split(events) -> Dict[str, object]:
    """The backward's device rows by the forward stage that built them:
    ``buckets`` {bucket: device s} (``BACKWARD_BUCKETS``, ``parameters``,
    ``unattributed``), ``stages`` {stage: device s}, ``ops`` (the rows
    launched inside autograd's engine, ROIAlign's included), ``nodes``
    and ``mapped`` (the numbered nodes, those traced to a stage)."""
    rows = trace.parse_events(events)[0]
    stage_of = node_stages(events)
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in trace.LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    nodes = trace._lanes([e for e in events if e.get("cat") == "cpu_op"
                          and e["name"].startswith(EVALUATE)])
    mine = collections.defaultdict(list)
    ops = 0
    for r in rows:
        if any(n.startswith("autograd::engine") for n in r["context"]):
            ops += 1
        if trace.classify(r) != trace.BACKWARD:
            continue
        src = launch.get(r.get("args", {}).get("correlation"))
        if src is not None:
            mine[_lane(src)].append((r, src["ts"]))
    buckets: Dict[str, float] = collections.defaultdict(float)
    stages: Dict[str, float] = collections.defaultdict(float)
    for lane, items in mine.items():
        around = _innermost(nodes.get(lane, []), [t for _, t in items])
        for (r, _), n in zip(items, around):
            stage = stage_of.get(id(n), "") if n is not None else ""
            buckets[bucket_of(stage)] += r["self"] / 1e6
            stages[stage or UNATTRIBUTED] += r["self"] / 1e6
    numbered = [k for k, v in stage_of.items() if v != PARAMETERS]
    return {"buckets": dict(buckets), "stages": dict(stages), "ops": ops,
            "nodes": len(numbered),
            "mapped": sum(1 for k in numbered if stage_of[k])}


def _marks(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in MARKS]


def _inside(e, spans) -> bool:
    return any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] +
               s["dur"] for s in spans)


def wait_spans(events) -> Dict[str, Dict[str, float]]:
    """The ``wait.<site>`` spans on the thread of the ``bench.*`` marks,
    inside them: {site: {"count", "s"}}, and under ``"all"`` the count
    and the seconds of their union."""
    marks = _marks(events)
    if not marks:
        return {}
    main = _lane(marks[0])
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(WAIT) and _lane(e) == main
             and _inside(e, marks)]
    out: Dict[str, Dict[str, float]] = {}
    for e in spans:
        site = out.setdefault(e["name"][len(WAIT):], {"count": 0, "s": 0.0})
        site["count"] += 1
        site["s"] += e["dur"] / 1e6
    union = trace.busy_intervals(spans, float("-inf"), float("inf"))
    out["all"] = {"count": len(spans),
                  "s": sum(b - a for a, b in union) / 1e6}
    return out


def is_sync(e) -> bool:
    """A runtime call that blocks the host on the card."""
    return e.get("cat") in trace.LAUNCH_CATS and (
        e["name"] in SYNCS or (e["name"].startswith("cudaMemcpy")
                               and not e["name"].endswith("Async")))


def unspanned_syncs(events) -> Tuple[List[Tuple[str, ...]],
                                     List[Tuple[str, ...]]]:
    """The blocking runtime calls on the marks' thread inside a
    ``bench.*`` mark and outside every ``wait.*`` span, each as its host
    context (outermost first): (those inside a stage range, those
    outside every stage range: the harness's own reads)."""
    marks = _marks(events)
    if not marks:
        return [], []
    main = _lane(marks[0])
    syncs = [e for e in events if is_sync(e) and _lane(e) == main
             and _inside(e, marks)]
    host = [e for e in events if _lane(e) == main
            and e.get("cat") in trace.HOST_CATS]
    staged, bare = [], []
    for c in trace._contexts(host, [e["ts"] for e in syncs]):
        if any(n.startswith(WAIT) for n in c):
            continue
        (staged if trace.innermost_stage(c) else bare).append(c)
    return staged, bare


def clock_excess(events) -> List[float]:
    """For each ``wait.*`` span: how far (us) the last device operation
    launched before it starts ends after it ends (<= 0: the read
    returned after the work it waits on, as one clock must show)."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in trace.LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    done = sorted((launch[r["args"]["correlation"]], r["ts"] + r["dur"])
                  for r in events if r.get("cat") in trace.DEVICE_CATS
                  and r.get("args", {}).get("correlation") in launch)
    starts = [t for t, _ in done]
    out = []
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(WAIT):
            k = bisect.bisect_left(starts, e["ts"])
            if k:
                out.append(done[k - 1][1] - (e["ts"] + e["dur"]))
    return out


def summary(events) -> Dict[str, object]:
    """What the readers of ``metrics/`` take: the backward split and the
    waits."""
    return {"backward": backward_split(events), "waits": wait_spans(events)}


def _trace_path(ctx) -> Optional[str]:
    """The traced window's file: ``run.py:run_cell`` holds it in ``rec``
    beside the ``ctx`` it hands each reader."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        rec = loc.get("rec")
        if loc.get("ctx") is ctx and isinstance(rec, dict) and \
                rec.get("trace_path"):
            return rec["trace_path"]
        f = f.f_back
    return None


def of(ctx) -> Optional[Dict[str, object]]:
    """``summary`` of the traced window that ``ctx`` was read from, made
    once a run and kept in ``ctx``; None where no trace is found."""
    if "spans" not in ctx:
        events = ctx.get("events")
        if events is None:
            path = _trace_path(ctx)
            events = trace.load_events(path) if path else None
        ctx["spans"] = summary(events) if events else None
    return ctx["spans"]
