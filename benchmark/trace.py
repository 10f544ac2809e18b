"""The trace join: a torch.profiler Chrome trace of the program, read
into the device's work by host stage, a frozen copy of the arithmetic of
the port's ``tools/profile_step.py`` (``exclusive_times``,
``parse_trace``, ``classify``, ``table``), plus the union of the
device's activity and its idle gaps named by the host stage that covers
them.

A kernel belongs to the host context it was launched from, found by its
``correlation`` id: the operators and ``record_function`` ranges around
its launch on the launching thread. The innermost ``<model>.<stage>`` or
``train_step.<stage>`` range there names its bucket (``SUBSYSTEMS``).
The prefixes of those ranges and the stage -> bucket maps are data: one
file a model family under ``benchmark/stages/`` (``stage_tables``), so
that a new family's stages enter the join as a file of its own.
Any row whose kernel or launching operator names ROIAlign goes to
``roi_align``, so the feature gradient, which autograd launches from its
own thread outside every range, lands there too; the other kernels of
autograd's thread are ``backward (unattributed)``.
"""
from __future__ import annotations

import collections
import gzip
import json
import os
from typing import Dict, List, Tuple

STAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "stages")


def stage_tables(directory: str = STAGES) -> Dict[str, tuple]:
    """Every ``*.json`` of ``directory`` merged, in sorted name order:
    ``prefixes`` (the stage ranges' ``<model>.`` prefixes, each once) and
    ``forward`` and ``backward``, each a tuple of (bucket, stages) in the
    order the buckets and stages first appear. A file gives ``prefixes``
    as a list and each side as {bucket: [stage, ...]}. A stage given two
    buckets on one side raises, naming the two files."""
    prefixes: List[str] = []
    sides = {"forward": {}, "backward": {}}
    owner: Dict[Tuple[str, str], Tuple[str, str]] = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(directory, name)) as f:
            table = json.load(f)
        prefixes += [p for p in table.get("prefixes", [])
                     if p not in prefixes]
        for side, buckets in sides.items():
            for bucket, stages in table.get(side, {}).items():
                for stage in stages:
                    seen = owner.setdefault((side, stage), (bucket, name))
                    if seen[0] != bucket:
                        raise ValueError(
                            f"stage {stage!r} ({side}): bucket {seen[0]!r} "
                            f"in {seen[1]}, {bucket!r} in {name}")
                    if stage not in buckets.setdefault(bucket, []):
                        buckets[bucket].append(stage)
    out = {side: tuple((b, tuple(s)) for b, s in buckets.items())
           for side, buckets in sides.items()}
    out["prefixes"] = tuple(prefixes)
    return out


_TABLES = stage_tables()
SUBSYSTEMS = _TABLES["forward"]
BUCKET_OF_STAGE = {s: b for b, stages in SUBSYSTEMS for s in stages}
ROI_ALIGN = "roi_align"
BACKWARD = "backward (unattributed)"
OTHER = "other"
STAGE_PREFIXES = _TABLES["prefixes"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def exclusive_times(rows) -> None:
    """Each row's ``self``: its ``dur`` less the rows nested in it,
    flame-graph style. Rows are dicts with ``ts`` and ``dur``
    (microseconds), of one thread or stream; sorted in place."""
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


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]


def parse_events(events: List[dict]):
    """Complete events of a Chrome trace -> (device rows, host stage
    ranges, host lanes). Device rows: kernels, copies and sets, each with
    ``self`` (us, exclusive on its stream) and ``context`` (the host
    operators and ranges around its launch, outermost first). Stage
    ranges: ``STAGE_PREFIXES`` ranges with their exclusive host time."""
    host = [e for e in events if e.get("cat") in HOST_CATS]
    device = [dict(e) for e in events if e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    host_lanes = _lanes(host)
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
        for (r, _), c in zip(items, ctx):
            r["context"] = c
    ranges = [dict(e) for e in host if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE_PREFIXES)]
    for lane in _lanes(ranges).values():
        exclusive_times(lane)
    return device, ranges, host_lanes


def innermost_stage(context) -> str:
    for name in reversed(context):
        if name.startswith(STAGE_PREFIXES):
            return name
    return ""


def classify(row) -> str:
    """The bucket of one device row (see the module's docstring)."""
    if ROI_ALIGN in row["name"] or any(ROI_ALIGN in n
                                       for n in row["context"]):
        return ROI_ALIGN
    stage = innermost_stage(row["context"])
    if stage:
        return BUCKET_OF_STAGE.get(stage.split(".", 1)[1], OTHER)
    if any(n.startswith("autograd::engine") for n in row["context"]):
        return BACKWARD
    return OTHER


def buckets(rows, ranges) -> Dict[str, Dict[str, float]]:
    """Per bucket: device seconds (its rows' exclusive time) and host
    seconds (its stage ranges' exclusive time)."""
    out = collections.defaultdict(lambda: {"device_s": 0.0, "host_s": 0.0})
    for r in rows:
        out[classify(r)]["device_s"] += r["self"] / 1e6
    for e in ranges:
        key = BUCKET_OF_STAGE.get(e["name"].split(".", 1)[1], OTHER)
        out[key]["host_s"] += e["self"] / 1e6
    return dict(out)


def busy_intervals(rows, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the device rows' [ts, ts + dur] (us), cut to
    [lo, hi]: when any operation ran on the device."""
    spans = sorted((max(r["ts"], lo), min(r["ts"] + r["dur"], hi))
                   for r in rows)
    out: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi] (us) that ``busy`` leaves."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def name_gaps(gaps, host_lanes, main_thread) -> Dict[str, float]:
    """Seconds of idle gaps by what the host was doing: the innermost
    stage range on ``main_thread`` (pid, tid) at the gap's middle, else
    its innermost operator, else "(no host op)"."""
    lane = host_lanes.get(main_thread, [])
    ranges = [e for e in lane if e.get("cat") == "user_annotation"]
    ops = [e for e in lane if e.get("cat") == "cpu_op"]
    mids = [(a + b) / 2 for a, b in gaps]
    stage_ctx = _contexts(ranges, mids)
    op_ctx = _contexts(ops, mids)
    out = collections.defaultdict(float)
    for (a, b), sc, oc in zip(gaps, stage_ctx, op_ctx):
        stage = innermost_stage(sc)
        name = stage or (sc[-1] if sc else "") or \
            (oc[-1] if oc else "(no host op)")
        out[name] += (b - a) / 1e6
    return dict(out)


def top(d: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
