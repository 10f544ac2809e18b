"""The twin of ``tools/profile_step.py`` (locov_torch/tools/profile_step.py).

- Its exclusive-time rule gives JAX's ``parse_trace`` self times on the
  same nested events (a synthetic trace in JAX's format).
- Its parser places each kernel of a synthetic trace in torch.profiler's
  Chrome format (the card's: kernels joined to their launches by
  correlation id, autograd's own thread) in the bucket its launch
  context names; the buckets sum to the totals.
- ``main --device cpu --steps 1`` on the tiny LSM and STT models of
  tests/torch_parity.py prints a table whose buckets sum to the total.
- ``profile`` + ``stage_line``, moved out of chip_smoke.py's
  ``profile_run``, emit the keys its ``*_profile`` lines had.
"""
import gzip
import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from locov_torch.config import config_path, get_cfg
from locov_torch.models import build_meta_arch
from locov_torch.ops import kernel_lib
from locov_torch.structures.batches import (DetectionBatch, GtBatch,
                                            ImageBatch, TextBatch)
from locov_torch.tools import profile_step
from locov_torch.utils.weights import seeded_init_
from torch_parity import (lsm_batch, tiny_cfg, tiny_lsm_arrays, tiny_lsm_cfg,
                          two_threads)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of chip_smoke.py's *_profile lines before profile_run moved
PROFILE_KEYS = {"phase", "wall_ms", "device_busy_ms", "device_idle_share",
                "device_idle_share_unprofiled", "kernel_launches", "stages",
                "unattributed_kernels_ms", "top_kernels_ms"}


def _jax_parse_trace():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_profile_step", os.path.join(REPO, "tools",
                                              "profile_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_trace


def _nested(rng, ts, dur, depth, out):
    """Random nested intervals inside [ts, ts + dur): children that share
    their parent's start or end, gaps, zero durations."""
    t = ts
    while depth and t < ts + dur and len(out) < 300:
        start = t + int(rng.choice([0, 0, 1, 3]))
        length = int(rng.randint(0, max(ts + dur - start, 0) + 1))
        if start + length > ts + dur:
            break
        out.append({"name": f"op{len(out)}", "ts": float(start),
                    "dur": float(length)})
        _nested(rng, start, length, depth - 1, out)
        t = start + length
    return out


def test_exclusive_times_match_jax_parse_trace(tmp_path):
    rng = np.random.RandomState(0)
    rows = _nested(rng, 0, 2000, 5, [])
    assert len(rows) > 50
    meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
             "args": {"name": "XLA Ops"}}]
    events = meta + [{"ph": "X", "pid": 1, "tid": 2, **r,
                      "args": {"source": "", "tf_op": ""}} for r in rows]
    path = tmp_path / "plugins" / "profile" / "run"
    path.mkdir(parents=True)
    with gzip.open(path / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    want = {r["name"]: r["dur"] for r in _jax_parse_trace()(str(tmp_path))}
    got = [dict(r) for r in rows]
    profile_step.exclusive_times(got)
    assert {r["name"]: r["self"] for r in got} == want
    # the rule did subtract nested time somewhere
    assert sum(want.values()) < sum(r["dur"] for r in rows)


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


def _card_trace(path):
    """A step as torch.profiler's Chrome trace of the card has it: the
    main thread (pid 10, tid 10), autograd's thread (tid 11), the
    stream (pid 0, tid 7); kernels joined to their launches by
    ``correlation``."""
    main, bwd = (10, 10), (10, 11)
    ev = [
        _x("user_annotation", "DistillProposalMMSSRCNN.backbone", *main,
           0, 100),
        _x("cpu_op", "aten::convolution", *main, 10, 40),
        _x("cuda_runtime", "cudaLaunchKernel", *main, 20, 5, correlation=1),
        _x("user_annotation", "DistillProposalMMSSRCNN.roi_features",
           *main, 100, 100),
        _x("cpu_op", "locov::roi_align", *main, 110, 40),
        _x("cuda_runtime", "cudaLaunchKernel", *main, 120, 5,
           correlation=2),
        _x("cpu_op", "aten::add", *main, 160, 10),
        _x("cuda_driver", "cuLaunchKernelEx", *main, 165, 2, correlation=3),
        _x("user_annotation", "train_step.backward", *main, 200, 200),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ConvolutionBackward0", *bwd, 210, 50),
        _x("cuda_runtime", "cudaLaunchKernel", *bwd, 220, 5, correlation=4),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "GeneratedBackwardFor_locov_roi_align_default", *bwd, 270, 40),
        _x("cpu_op", "locov::roi_align_bwd", *bwd, 275, 30),
        _x("cuda_runtime", "cudaLaunchKernel", *bwd, 280, 5, correlation=5),
        _x("user_annotation", "train_step.optimizer", *main, 400, 50),
        _x("cpu_op", "aten::_foreach_add_", *main, 405, 40),
        _x("cuda_runtime", "cudaLaunchKernel", *main, 410, 5, correlation=6),
        _x("cuda_runtime", "cudaMemsetAsync", *main, 460, 5, correlation=7),
        # the device: one stream
        _x("kernel", "cutlass_fprop_kernel", 0, 7, 30, 8.0, correlation=1),
        _x("kernel", "void (anonymous namespace)::roi_align_fwd_kernel"
           "<__nv_bfloat16, 16>(__nv_bfloat16 const*)", 0, 7, 130, 2.0,
           correlation=2),
        _x("kernel", "elementwise_kernel_add", 0, 7, 170, 1.0,
           correlation=3),
        _x("kernel", "cutlass_wgrad_kernel", 0, 7, 230, 6.0, correlation=4),
        _x("kernel", "void (anonymous namespace)::roi_align_bwd_kernel"
           "<float>(float const*)", 0, 7, 290, 3.0, correlation=5),
        _x("kernel", "multi_tensor_apply_kernel", 0, 7, 420, 0.5,
           correlation=6),
        _x("gpu_memset", "Memset (Device)", 0, 7, 470, 0.25, correlation=7),
        _x("kernel", "orphan_kernel", 0, 7, 499.75, 0.25, correlation=99),
        _x("gpu_user_annotation", "train_step.optimizer", 0, 7, 420, 1.0),
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev + [{"ph": "f", "id": 1, "cat": "ac2g",
                                         "name": "ac2g"}]}, f)


def test_parse_trace_places_card_kernels(tmp_path):
    _card_trace(tmp_path / "step.pt.trace.json.gz")
    rows, ranges, wall = profile_step.parse_trace(
        profile_step.trace_file(str(tmp_path)))
    assert len(rows) == 8 and wall == 500.0
    res = profile_step.table(rows, ranges, wall, steps=1)
    ms = {k: v["ms"] * 1e3 for k, v in res["buckets"].items()}
    assert ms == {"backbone": 8.0, "roi_align": 5.0, "res5": 1.0,
                  "backward (unattributed)": 6.0, "optimizer": 0.5,
                  "other": 0.5}
    host = {k: v["host_ms"] * 1e3 for k, v in res["buckets"].items()}
    assert host == {"backbone": 100.0, "roi_align": 0.0, "res5": 100.0,
                    "backward (unattributed)": 200.0, "optimizer": 50.0,
                    "other": 50.0}
    assert res["busy_ms"] * 1e3 == sum(ms.values()) == 21.0
    assert res["hand_kernels"] == {"roi_align_bwd_kernel": {"roi_align": 1},
                                   "roi_align_fwd_kernel": {"roi_align": 1}}
    assert res["buckets"]["backbone"]["heaviest"] == "cutlass_fprop_kernel"
    by_stage = profile_step.table(rows, ranges, wall, 1, by="stage")
    assert by_stage["buckets"]["DistillProposalMMSSRCNN.roi_features"][
        "ms"] * 1e3 == 3.0
    assert by_stage["buckets"]["(none)"]["ms"] * 1e3 == 9.5


@pytest.mark.parametrize("fn", kernel_lib.DEVICE_FUNCTIONS)
def test_hand_kernel_names_every_device_function_of_the_table(fn):
    """A profiler's demangled name of each hand kernel's device function
    (templated, in the sources' anonymous namespace) is counted under
    that function: ``HAND_KERNELS`` is the table's list."""
    name = (f"void (anonymous namespace)::{fn}<96, (bool)1>"
            f"(__nv_bfloat16 const*, float*, int)")
    assert profile_step.hand_kernel(name) == fn
    assert profile_step.hand_kernel(fn + "_other(int)") == ""


def _tiny_lsm(device):
    cfg = tiny_lsm_cfg(get_cfg, config_path)
    model = seeded_init_(build_meta_arch(cfg, device=device), 0)
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    class_emb = torch.from_numpy(arrays.pop("class_emb"))
    return cfg, model, lsm_batch(arrays, ImageBatch, GtBatch, TextBatch,
                                 DetectionBatch, torch.from_numpy), class_emb


def _tiny_stt(device):
    cfg = tiny_cfg(get_cfg, **{"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]})
    model = seeded_init_(build_meta_arch(cfg, device=device), 0)
    rng = np.random.RandomState(0)
    batch = DetectionBatch(images=ImageBatch(
        image=torch.from_numpy((rng.rand(2, 64, 96, 3) * 255).astype(
            np.float32)),
        hw=torch.tensor([[64, 96], [48, 80]], dtype=torch.int32),
        orig_hw=torch.tensor([[128, 192], [96, 160]], dtype=torch.int32)))
    class_emb = torch.from_numpy((rng.randn(6, 8) * 0.1).astype(np.float32))
    return cfg, model, batch, class_emb


@pytest.mark.parametrize("mode", ["lsm_train", "stt_eval"])
def test_main_on_the_cpu_sums_its_buckets(monkeypatch, capsys, tmp_path,
                                          mode):
    monkeypatch.setattr(profile_step, "build_full", _tiny_lsm)
    monkeypatch.setattr(profile_step, "build_stt_eval", _tiny_stt)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    line = profile_step.main(["--device", "cpu", "--steps", "1",
                              "--mode", mode])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert out[0].split()[:4] == ["bucket", "ms/step", "%", "host"]
    assert out[-2].startswith("TOTAL (cpu operators)")
    assert line["device"] == "cpu" and line["mode"] == mode
    assert line["rows"] == "cpu operators"
    assert line["trace"].startswith(str(tmp_path))
    buckets = line["buckets"]
    assert sum(b["ms"] for b in buckets.values()) == pytest.approx(
        line["busy_ms"], rel=1e-9)
    assert sum(b["host_ms"] for b in buckets.values()) == pytest.approx(
        line["wall_ms"], rel=1e-9)
    assert 0 < line["busy_ms"] < line["wall_ms"]
    # the profiler's warm-up step is not in the trace: one step is
    _, ranges, _ = profile_step.parse_trace(
        profile_step.trace_file(line["trace"]))
    assert [r["name"].split(".")[1] for r in ranges].count("backbone") == 1
    want = {"backbone", "rpn+nms", "res5", "roi_align"}
    if mode == "lsm_train":
        want |= {"mmss_heads", "optimizer", "backward (unattributed)"}
    assert want <= {k for k, b in buckets.items() if b["ms"] > 0}
    # the written trace parses again, by kernel, to the same total
    again = profile_step.main(["--device", "cpu", "--steps", "1",
                               "--trace-dir", line["trace"], "--by",
                               "kernel"])
    assert again["busy_ms"] == pytest.approx(line["busy_ms"], rel=1e-9)
    assert all(b["host_ms"] is None for b in again["buckets"].values())


def test_stage_line_keeps_chip_smoke_profile_keys():
    _, model, batch, class_emb = _tiny_stt("cpu")
    prof, wall_ms = profile_step.profile(
        lambda: model.inference(batch, class_emb), torch.device("cpu"))
    line = profile_step.stage_line("main_path_profile", prof, wall_ms, 1.0)
    assert set(line) == PROFILE_KEYS
    assert line["phase"] == "main_path_profile"
    assert {"backbone", "rpn_head", "select_proposals", "roi_features",
            "predict", "fast_rcnn_inference"} <= set(line["stages"])
    for st in line["stages"].values():
        assert set(st) == {"host_ms", "device_kernels_ms"}
        assert st["host_ms"] > 0
    assert line["device_busy_ms"] == 0.0 and line["kernel_launches"] == 0
