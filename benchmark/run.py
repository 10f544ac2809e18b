"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, work
and limits are files under ``benchmark/`` found by the names in
``BENCHMARK.json``. The run makes the weights and inputs from the seed,
builds the program (``locov_torch``) and warms every shape of the cell
(set-up), measures for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or records a short window under torch.profiler (``--trace 1``:
the per-layer metrics), then checks the outputs against the plain
reference (``check.py``). The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checked``: each compared
number beside its limit, also the last lines of standard error).

Exits 2 without a result where no CUDA device is found, or fewer than
the cell asks for, and 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

from . import build  # noqa: E402

CACHE = os.path.join(build.ROOT, "build", "bench_cache")


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/kernels/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


class Run:
    """What one run of a cell is given."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, control: bool = False,
                 wrap_step: Optional[Callable] = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.control = trace, device, control
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.wrap_step = wrap_step or (lambda step: step)
        self.trace_dir = None
        self.free = []


def reader(name: str):
    """The per-layer metric ``name``'s reader: ``metrics/<name>.py``, or
    ``metrics/<quantity>.py`` for ``<quantity>.<suffix>``."""
    base = os.path.join(build.BENCH, "metrics")
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(base, stem + ".py")
        if os.path.exists(path):
            mod = f"benchmark.metrics.{stem}" if stem.isidentifier() \
                else None
            if mod:
                return importlib.import_module(mod).read
            spec = importlib.util.spec_from_file_location(
                "benchmark.metrics._" + stem.replace(".", "_"), path,
                submodule_search_locations=None)
            module = importlib.util.module_from_spec(spec)
            module.__package__ = "benchmark.metrics"
            spec.loader.exec_module(module)
            return module.read
    raise SystemExit(f"no reader for the per-layer metric {name}")


def request_work(run, rec) -> Dict[str, float]:
    """The model FLOPs and ROIAlign bytes of the traced requests."""
    work = importlib.import_module(
        f"benchmark.work.{run.cell['workload']['work']}")
    cfg = rec["shapes"]["cfg"]
    traffic = rec["shapes"]["traffic"]
    words = run.traffic.get("text", {}).get("slots", 0)
    total = {"flops": 0.0, "roi_bytes": 0.0}
    for bucket in rec["window_buckets"]:
        w = work.request_work(cfg, traffic.class_emb.shape[0],
                              rec["shapes"]["batch"],
                              traffic.padded(bucket), words)
        for k in total:
            total[k] += w[k]
    return total


def trace_context(run, rec) -> dict:
    """The traced window read through ``trace.py``: buckets, busy and
    window seconds, the breakdown, and the work of its requests."""
    from . import trace
    events = trace.load_events(rec["trace_path"])
    rows, ranges, lanes = trace.parse_events(events)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in ("bench.step", "bench.call")]
    lo = min(e["ts"] for e in marks)
    hi = max([e["ts"] + e["dur"] for e in marks] +
             [r["ts"] + r["dur"] for r in rows])
    busy = trace.busy_intervals(rows, lo, hi)
    main = (marks[0]["pid"], marks[0]["tid"])
    gaps = trace.name_gaps(trace.idle_gaps(busy, lo, hi), lanes, main)
    ops: Dict[str, float] = {}
    for r in rows:
        ops[r["name"]] = ops.get(r["name"], 0.0) + r["dur"] / 1e6
    ctx = {"buckets": trace.buckets(rows, ranges),
           "requests": len(rec["window_buckets"]),
           "window_s": (hi - lo) / 1e6,
           "busy_s": sum(b - a for a, b in busy) / 1e6,
           "latencies": [t for _, t in rec.get("latencies", [])],
           "breakdown": {"device_ops": trace.top(ops),
                         "idle_gaps": trace.top(gaps)}}
    ctx.update(request_work(run, rec))
    return ctx


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def end_to_end(run, rec, setup_s: float, peak: float) -> Dict[str, float]:
    """The end-to-end quantities of a run. A metric named
    ``<quantity>.<suffix>`` (a later cell's own entry) reads its
    quantity."""
    values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30}
    if run.traffic["loop"] == "train":
        values["train_img_per_s"] = rec["images"] / rec["window_s"]
    else:
        values["infer_img_per_s"] = rec["images"] / rec["window_s"]
    return values


def window_note(rec) -> str:
    """A line for standard error: the window's requests and, for calls,
    the median and 95th percentile latency of each bucket."""
    note = f"window {rec['requests']} requests in {rec['window_s']:.3f} s"
    by = {}
    for name, t in rec.get("step_s", []):
        by.setdefault(name, []).append(t)
    for name, ts in sorted(by.items()):
        note += (f"; {name} {len(ts)} steps, host s "
                 f"{', '.join(f'{t:.3f}' for t in ts)}")
    by = {}
    for name, t in rec.get("latencies", []):
        by.setdefault(name, []).append(t)
    for name, ts in sorted(by.items()):
        ts.sort()
        note += (f"; {name} {len(ts)} calls, median "
                 f"{1e3 * ts[len(ts) // 2]:.1f} ms, p95 {1e3 * p95(ts):.1f}")
    return note


def run_cell(run: Run, t_start: float = None) -> dict:
    """One run of the cell: the program's loop, the metrics, then the
    reference's check. Returns the result line's fields."""
    import torch
    from . import check
    from .loops import LOOPS, trace_dir
    t_start = T_START if t_start is None else t_start
    cuda = run.device.type == "cuda"
    if run.trace:
        run.trace_dir = trace_dir()
    try:
        rec = LOOPS[run.traffic["loop"]](run)
        peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
        setup_s = rec["setup_end"] - t_start
        parts = rec["setup_parts"]
        before = setup_s - sum(parts.values())
        print("set-up " + ", ".join(
            [f"before the loop {before:.2f} s"] +
            [f"{k} {v:.2f} s" for k, v in parts.items()]),
            file=sys.stderr, flush=True)
        metrics, extra = {}, {}
        if run.trace:
            ctx = trace_context(run, rec)
            for m in run.cell["per_layer"]:
                value = reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra = {"busy_s": ctx["busy_s"], "window_s": ctx["window_s"],
                     "breakdown": ctx["breakdown"]}
            attempted = ctx["requests"]
        else:
            values = end_to_end(run, rec, setup_s, peak)
            for m in run.cell["end_to_end"]:
                name = m["name"]
                value = values[name if name in values
                               else name.split(".", 1)[0]]
                metrics[name] = {"value": value, "unit": m["unit"]}
            attempted = rec["requests"]
            print(window_note(rec), file=sys.stderr, flush=True)
    finally:
        if run.trace_dir:
            shutil.rmtree(run.trace_dir, ignore_errors=True)
    run.free.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if run.traffic["loop"] == "train":
        ref = check.reference_train(run, rec)
        numbers = check.train_numbers(rec, ref)
        print("widest " + json.dumps(check.train_notes(rec, ref)),
              file=sys.stderr, flush=True)
    else:
        notes = {}
        numbers = check.infer_numbers(run, rec, notes)
        print("widest " + json.dumps(notes), file=sys.stderr, flush=True)
    print(f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr,
          flush=True)
    limits = run.cell["limits"]
    failed = sum(1 for k in limits if not numbers[k] <= limits[k])
    return {"correct": check.verdict(numbers, limits),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "peak": peak, "extra": extra,
            "checked": {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in build.FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = build.load_cell(args.workload)
    import torch
    chips = cell["entry"].get("chips", 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    import locov_torch  # noqa: F401  (the program; fails without it)
    device = torch.device("cuda", 0)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    res = run_cell(run)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(res["peak"]),
           "power_limit": power_limit()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": dev}
    if args.trace:
        dev["busy_s"] = res["extra"]["busy_s"]
        dev["window_s"] = res["extra"]["window_s"]
        line["breakdown"] = res["extra"]["breakdown"]
    line["checked"] = res["checked"]
    print(json.dumps(line), flush=True)
    for k, v in res["checked"].items():
        print(f"checked {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
