"""The trace join on a synthetic card trace: kernels joined to their
launch by correlation id, bucketed by the innermost stage range around
the launch, autograd's thread and ROIAlign by name; the device's busy
union and its idle gaps named by the host stage that covers them."""
import pytest

from benchmark import trace
from benchmark.run import trace_context

MAIN, AUTOGRAD, STREAM = (1, 10), (1, 11), (0, 7)


def X(name, cat, ts, dur, lane, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": lane[0], "tid": lane[1], "args": args}


def synthetic():
    """Two steps' worth: a backbone kernel, an RPN kernel, a ROIAlign
    kernel launched inside its op, a backward kernel from autograd's
    thread, an optimizer kernel; idle gaps inside select_proposals."""
    ev = [X("bench.step", "user_annotation", 0, 1000, MAIN),
          X("OvrRCNN.backbone", "user_annotation", 0, 200, MAIN),
          X("aten::conv2d", "cpu_op", 10, 50, MAIN),
          X("cudaLaunchKernel", "cuda_runtime", 20, 5, MAIN, correlation=1),
          X("OvrRCNN.select_proposals", "user_annotation", 200, 400, MAIN),
          X("cudaLaunchKernel", "cuda_runtime", 210, 5, MAIN, correlation=2),
          X("OvrRCNN.roi_features", "user_annotation", 600, 100, MAIN),
          X("locov::roi_align", "cpu_op", 610, 50, MAIN),
          X("cudaLaunchKernel", "cuda_runtime", 620, 5, MAIN, correlation=3),
          X("autograd::engine::evaluate_function: X", "cpu_op", 700, 100,
            AUTOGRAD),
          X("cudaLaunchKernel", "cuda_runtime", 710, 5, AUTOGRAD,
            correlation=4),
          X("train_step.optimizer", "user_annotation", 900, 100, MAIN),
          X("cudaLaunchKernel", "cuda_runtime", 910, 5, MAIN, correlation=5),
          # the card
          X("sm90_conv_fprop", "kernel", 30, 150, STREAM, correlation=1),
          X("nms_sweep", "kernel", 220, 30, STREAM, correlation=2),
          X("roi_align_fwd_kernel", "kernel", 630, 40, STREAM,
            correlation=3),
          X("wgrad_kernel", "kernel", 720, 100, STREAM, correlation=4),
          X("sgd_kernel", "kernel", 920, 60, STREAM, correlation=5)]
    return ev


def test_rows_go_to_their_buckets():
    rows, ranges, lanes = trace.parse_events(synthetic())
    by = {r["name"]: trace.classify(r) for r in rows}
    assert by == {"sm90_conv_fprop": "backbone", "nms_sweep": "rpn+nms",
                  "roi_align_fwd_kernel": "roi_align",
                  "wgrad_kernel": "backward (unattributed)",
                  "sgd_kernel": "optimizer"}
    b = trace.buckets(rows, ranges)
    assert b["backbone"]["device_s"] == pytest.approx(150e-6)
    assert b["rpn+nms"]["host_s"] == pytest.approx(400e-6)
    assert b["res5"]["host_s"] == pytest.approx(100e-6)


def test_exclusive_time_of_nested_rows():
    rows = [{"ts": 0, "dur": 100}, {"ts": 10, "dur": 30},
            {"ts": 50, "dur": 20}, {"ts": 200, "dur": 5}]
    trace.exclusive_times(rows)
    assert [r["self"] for r in rows] == [50, 30, 20, 5]


def test_busy_union_and_named_gaps():
    rows, _, lanes = trace.parse_events(synthetic())
    busy = trace.busy_intervals(rows + [dict(rows[0], ts=100, dur=100)],
                                0, 1000)
    assert busy[0] == (30, 200)
    assert sum(b - a for a, b in busy) == 150 + 20 + 30 + 40 + 100 + 60
    gaps = trace.idle_gaps(busy, 0, 1000)
    assert gaps[0] == (0, 30) and gaps[-1] == (980, 1000)
    named = trace.name_gaps(gaps, lanes, MAIN)
    assert named["OvrRCNN.select_proposals"] == pytest.approx(
        (20 + 380) / 1e6)
    assert named["bench.step"] == pytest.approx(100e-6)
    assert max(named, key=named.get) == "OvrRCNN.select_proposals"


def test_trace_context_reads_a_written_trace(tmp_path):
    import json

    class Shapes:
        class_emb = __import__("numpy").zeros((66, 768))

        @staticmethod
        def padded(bucket):
            return (800, 1344)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic()}))

    class R:
        cell = {"workload": {"work": "stt_infer"}}
        traffic = {}
    from benchmark.build import program_cfg, load_cell
    cfg = program_cfg(load_cell("stt_infer_b8")["config"])
    rec = {"trace_path": str(path), "window_buckets": ["landscape"],
           "shapes": {"cfg": cfg, "traffic": Shapes, "batch": 8}}
    ctx = trace_context(R, rec)
    assert ctx["window_s"] == pytest.approx(1000e-6)
    assert ctx["busy_s"] == pytest.approx(380e-6)
    assert ctx["requests"] == 1
    assert ctx["flops"] == pytest.approx(13.451e12, rel=1e-4)
    assert ctx["breakdown"]["device_ops"][0] == ["sm90_conv_fprop",
                                                 pytest.approx(150e-6)]
    from benchmark.run import reader
    assert reader("idle_share.infer")(ctx) == pytest.approx(62.0)
    assert reader("roi_align_roofline.infer")(ctx) > 0
    assert reader("mmss_ms.train")(ctx) is None  # nothing to read
