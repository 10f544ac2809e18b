"""The backward split and the waits (``spans.py``) on the CPU.

- A hand-written card trace (a main thread, autograd's thread, a
  stream; sequence numbers, correlations and ``wait.*`` spans) gives the
  expected bucket ms, operation count, reads and wait ms through the
  metrics' readers, and the checks of the trace (syncs outside a span,
  the one clock) read what it holds.
- A real CPU profiler trace of the tiny LSM cell's steps (the harness's
  own traced window) maps at least 95% of the numbered
  ``evaluate_function`` events to a stage, and a traced run's line holds
  the span metrics, found from the run's own trace.
- ``trace_context`` reads the same values for every key with the new
  spans in the trace as without them, but for ``other``'s host time
  (``train_step.losses``, a range no bucket names), which no metric
  reads; the readers leave those keys as they were.
"""
import json
import shutil

import numpy as np
import pytest

from benchmark import loops, spans, trace
from benchmark.run import reader, trace_context
from benchmark.tests.tiny import cpu_run

MAIN, AUTOGRAD, OTHER, STREAM = (1, 10), (1, 11), (1, 12), (0, 7)
M = "DistillProposalMMSSRCNN."
EVAL = "autograd::engine::evaluate_function: "


def X(name, cat, ts, dur, lane, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": lane[0], "tid": lane[1], "args": args}


def op(name, ts, dur, seq, lane=MAIN, fwd=0):
    return X(name, "cpu_op", ts, dur, lane,
             **{"Sequence number": seq, "Fwd thread id": fwd})


def launch(ts, corr, lane=MAIN):
    return X("cudaLaunchKernel", "cuda_runtime", ts, 2, lane,
             correlation=corr)


def kernel(name, ts, dur, corr):
    return X(name, "kernel", ts, dur, STREAM, correlation=corr)


def node(name, ts, dur, seq=None):
    args = {} if seq is None else {"Sequence number": seq,
                                   "Fwd thread id": 1}
    return X(EVAL + name, "cpu_op", ts, dur, AUTOGRAD, **args)


def synthetic(new_spans=True):
    """One LSM step: forward ops numbered 5-9 in their stages, their
    nodes on autograd's thread, ROIAlign's backward, an AccumulateGrad
    node, a node whose number no forward op carries; two NMS reads and
    a sync in their ``wait.*`` spans (``new_spans``: with them and
    ``train_step.losses``, else the same trace without those ranges)."""
    ev = [X("bench.step", "user_annotation", 0, 1000, MAIN),
          X(M + "backbone", "user_annotation", 0, 90, MAIN),
          op("aten::conv2d", 10, 50, 5), launch(20, 1),
          X(M + "language", "user_annotation", 90, 10, MAIN),
          op("aten::embedding", 92, 4, 6),  # no node: carries 6 too
          op("aten::copy_", 105, 2, 6, lane=OTHER),  # another thread
          X(M + "box_mmss", "user_annotation", 100, 100, MAIN),
          op("aten::mm", 110, 30, 6), launch(120, 2),
          X(M + "select_proposals", "user_annotation", 200, 100, MAIN),
          launch(205, 13),
          X("cudaStreamSynchronize", "cuda_runtime", 215, 10, MAIN),
          X(M + "roi_features", "user_annotation", 300, 100, MAIN),
          op("locov::roi_align", 310, 20, 7), launch(315, 3),
          op("aten::mean", 350, 20, 8), launch(355, 15),
          X("cudaStreamSynchronize", "cuda_runtime", 380, 5, MAIN),
          op("aten::add", 405, 5, 9), launch(406, 14),
          X("train_step.backward", "user_annotation", 420, 480, MAIN),
          node("AddBackward0", 430, 10, 9), launch(432, 4, AUTOGRAD),
          node("MeanBackward1", 440, 30, 8), launch(445, 5, AUTOGRAD),
          node("GeneratedBackwardFor_locov_roi_align_default", 470, 30, 7),
          X("locov::roi_align_bwd", "cpu_op", 472, 20, AUTOGRAD),
          launch(475, 6, AUTOGRAD),
          node("MmBackward0", 500, 100, 6),
          X("MmBackward0", "cpu_op", 502, 90, AUTOGRAD,
            **{"Sequence number": 6, "Fwd thread id": 1}),
          launch(510, 7, AUTOGRAD), launch(540, 8, AUTOGRAD),
          node("ConvolutionBackward0", 600, 100, 5),
          launch(610, 9, AUTOGRAD),
          node("torch::autograd::AccumulateGrad", 700, 20),
          launch(705, 10, AUTOGRAD),
          node("AddBackward0", 720, 20, 99), launch(725, 11, AUTOGRAD),
          X("train_step.optimizer", "user_annotation", 900, 80, MAIN),
          launch(910, 12),
          X("cudaStreamSynchronize", "cuda_runtime", 990, 5, MAIN),
          # the card
          kernel("sm90_conv_fprop", 30, 50, 1),
          kernel("nvjet_gemm", 130, 30, 2),
          kernel("nms_sweep", 213, 12, 13),
          kernel("roi_align_fwd_kernel", 320, 10, 3),
          kernel("reduce_kernel", 360, 10, 15),
          kernel("add_kernel", 408, 1, 14),
          kernel("fill_kernel", 434, 1, 4),
          kernel("mean_bwd_kernel", 450, 20, 5),
          kernel("roi_align_bwd_kernel", 480, 25, 6),
          kernel("nvjet_dgrad", 515, 40, 7),
          kernel("nvjet_wgrad", 560, 10, 8),
          kernel("conv_wgrad", 615, 60, 9),
          kernel("accumulate_kernel", 708, 5, 10),
          kernel("stray_kernel", 728, 3, 11),
          kernel("sgd_kernel", 920, 10, 12)]
    if new_spans:
        ev += [X("wait.nms_converge", "user_annotation", 210, 20, MAIN),
               X("wait.nms_tile", "user_annotation", 240, 10, MAIN),
               X("train_step.losses", "user_annotation", 400, 20, MAIN)]
    return ev


def test_hand_written_trace_splits_the_backward():
    events = synthetic()
    stages = spans.node_stages(events)
    by_name = {}
    for e in events:
        if e["name"].startswith(EVAL):
            by_name.setdefault(e["name"][len(EVAL):], []).append(
                stages[id(e)])
    assert by_name == {
        "AddBackward0": ["train_step.losses", ""],
        "MeanBackward1": [M + "roi_features"],
        "GeneratedBackwardFor_locov_roi_align_default": [M + "roi_features"],
        "MmBackward0": [M + "box_mmss"],
        "ConvolutionBackward0": [M + "backbone"],
        "torch::autograd::AccumulateGrad": ["parameters"]}
    split = spans.backward_split(events)
    assert split["buckets"] == {
        "trunk": pytest.approx(60e-6), "res5": pytest.approx(20e-6),
        "mmss": pytest.approx(50e-6), "parameters": pytest.approx(5e-6),
        "unattributed": pytest.approx(4e-6)}
    assert split["ops"] == 8 and split["nodes"] == 6 and \
        split["mapped"] == 5
    ctx = {"requests": 1, "events": events}
    got = {name: reader(name)(ctx) for name in (
        "bwd_trunk_ms.train", "bwd_res5_ms.train", "bwd_mmss_ms.train",
        "bwd_ops.train", "nms_reads.train", "host_wait_ms.train")}
    assert got == {"bwd_trunk_ms.train": pytest.approx(0.06),
                   "bwd_res5_ms.train": pytest.approx(0.02),
                   "bwd_mmss_ms.train": pytest.approx(0.05),
                   "bwd_ops.train": 8, "nms_reads.train": 2,
                   "host_wait_ms.train": pytest.approx(0.03)}
    # the backward's buckets hold what trace.py calls unattributed
    rows, ranges, _ = trace.parse_events(events)
    b = trace.buckets(rows, ranges)
    assert sum(split["buckets"].values()) == pytest.approx(
        b["backward (unattributed)"]["device_s"])


def test_checks_of_the_trace():
    events = synthetic()
    staged, bare = spans.unspanned_syncs(events)
    assert staged == [("bench.step", M + "roi_features")]
    assert bare == [("bench.step",)]
    excess = spans.clock_excess(events)
    assert excess == [pytest.approx(-5.0), pytest.approx(-25.0)]


def test_no_spans_no_metrics():
    """On a program without the spans (the parent of this change) the
    readers of the waits find nothing and return None."""
    ctx = {"requests": 1, "events": synthetic(new_spans=False)}
    assert reader("nms_reads.infer")(ctx) is None
    assert reader("host_wait_ms.infer")(ctx) is None
    assert reader("bwd_mmss_ms.train")(ctx) == pytest.approx(0.05)
    assert reader("nms_reads.train")({"requests": 1, "events": []}) is None


class _Shapes:
    class_emb = np.zeros((66, 768))

    @staticmethod
    def padded(bucket):
        return (800, 1344)


def _context(path):
    class R:
        cell = {"workload": {"work": "stt_infer"}}
        traffic = {}
    from benchmark.build import load_cell, program_cfg
    cfg = program_cfg(load_cell("stt_infer_b8")["config"])
    rec = {"trace_path": str(path), "window_buckets": ["landscape"],
           "shapes": {"cfg": cfg, "traffic": _Shapes, "batch": 8}}
    return trace_context(R, rec)


def test_trace_context_reads_the_same_with_the_new_spans(tmp_path):
    ctxs = []
    for new in (False, True):
        path = tmp_path / f"t{int(new)}.json"
        path.write_text(json.dumps({"traceEvents": synthetic(new)}))
        ctxs.append(_context(path))
    before, after = ctxs
    assert set(before) == set(after)
    names = ("idle_share.infer", "mfu.infer", "roi_align_roofline.infer",
             "backbone_ms.infer", "rpn_nms_host_ms.infer", "res5_ms.infer",
             "mmss_ms.train", "backward_ms.train", "infer_batch_p95_ms")
    assert [reader(n)(before) for n in names] == \
        [reader(n)(after) for n in names]
    # the one change: the new range's own host time, in ``other``,
    # which no metric reads
    extra = after["buckets"]["other"]["host_s"] - \
        before["buckets"]["other"]["host_s"]
    assert extra == pytest.approx(20e-6)
    before["buckets"]["other"]["host_s"] += extra
    assert json.dumps(before, sort_keys=True) == json.dumps(after,
                                                            sort_keys=True)
    kept = json.dumps(after, sort_keys=True)
    after["events"] = synthetic()
    assert reader("nms_reads.infer")(after) == 2
    del after["events"], after["spans"]
    assert json.dumps(after, sort_keys=True) == kept


def test_a_real_cpu_trace_maps_the_backward(monkeypatch, tmp_path):
    kept = []
    window = loops.profile_window

    def keep(*args, **kw):
        path, seconds = window(*args, **kw)
        kept.append(shutil.copy(path, tmp_path / f"w{len(kept)}.json"))
        return path, seconds
    monkeypatch.setattr(loops, "profile_window", keep)
    res = cpu_run("lsm_global_b32", seed=2 ** 31 + 9, trace=True)
    assert res["correct"] is True
    events = trace.load_events(str(kept[0]))
    stages = spans.node_stages(events)
    numbered = [v for v in stages.values() if v != spans.PARAMETERS]
    assert len(numbered) > 500
    assert sum(1 for v in numbered if v) >= 0.95 * len(numbered)
    # the run found its own trace: the waits are read, and on the CPU
    # (no device rows) the backward's device metrics stay silent
    metrics = res["metrics"]
    assert metrics["nms_reads.train"]["value"] > 0
    assert metrics["host_wait_ms.train"]["value"] > 0
    assert not any(k.startswith("bwd_") for k in metrics)
