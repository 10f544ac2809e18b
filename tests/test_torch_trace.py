"""The port's spans (``locov_torch/utils/trace.py``).

- Under a CPU profiler, ``nms_mask_batched`` emits one ``wait.nms_*``
  span for each host read of the card that it makes, counted on a plain
  re-run of the same input (``torch.equal`` and ``Tensor.__bool__``
  counted as they are called).
- With no profiler running, ``wait`` opens no ``record_function``.
- The stage ranges of one tiny LSM step and one STT call are the names
  the models and steps had before ``stage`` replaced their helpers, plus
  ``train_step.losses``; every backward node of the step traces back to
  a stage range (the join of ``tools/profile_step.py``).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from locov_torch.engine.solver import build_optimizer
from locov_torch.ops import nms
from locov_torch.parallel.mesh import make_eval_step, make_train_step
from locov_torch.tools import profile_step
from locov_torch.utils import trace
from test_torch_profile_step import _tiny_lsm, _tiny_stt
from torch_parity import two_threads  # noqa: F401 (autouse)

STAGE_PREFIXES = ("OvrRCNN.", "DistillProposalMMSSRCNN.", "MMSSGridModel.",
                  "train_step.", "eval.")
# the ranges of the tiny LSM step and STT call before ``utils/trace.py``
BEFORE = {
    "DistillProposalMMSSRCNN." + s for s in (
        "backbone", "box_mmss", "distill", "grid_features", "grid_mmss",
        "label_and_sample", "language", "predict", "preprocess",
        "roi_features", "rpn_head", "rpn_losses", "select_proposals")} | {
    "OvrRCNN." + s for s in (
        "backbone", "fast_rcnn_inference", "predict", "preprocess",
        "roi_features", "rpn_head", "select_proposals")} | {
    "train_step.backward", "train_step.optimizer"}


def _boxes(seed, b=2, m=900):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0.0, 300.0, (b, m, 2))
    wh = rng.uniform(8.0, 60.0, (b, m, 2))
    boxes = torch.from_numpy(np.concatenate([lo, lo + wh], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.rand(b, m).astype(np.float32))
    valid = torch.from_numpy(rng.rand(b, m) > 0.05)
    return boxes, scores, valid


@pytest.mark.parametrize("stop_after", [0, 40, 300])
def test_nms_emits_a_wait_span_per_host_read(monkeypatch, stop_after):
    boxes, scores, valid = _boxes(stop_after)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = nms.nms_mask_batched(boxes, scores, valid, 0.5, stop_after)
    names = [e.name for e in prof.events()]
    spans = {s: names.count(f"wait.nms_{s}") for s in ("converge", "tile")}

    reads = {"converge": 0, "tile": 0}
    equal, to_bool = torch.equal, torch.Tensor.__bool__

    def counted_equal(a, b):
        reads["converge"] += 1
        return equal(a, b)

    def counted_bool(x):
        reads["tile"] += 1
        return to_bool(x)
    monkeypatch.setattr(torch, "equal", counted_equal)
    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    got = nms.nms_mask_batched(boxes, scores, valid, 0.5, stop_after)
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert spans == reads
    assert reads["converge"] > 0
    assert (reads["tile"] > 0) == (stop_after > 0)


def test_wait_opens_no_range_without_a_profiler(monkeypatch):
    opened = []

    def spy(name):
        opened.append(name)
        return torch.profiler.record_function(name)
    monkeypatch.setattr(trace, "record_function", spy)
    assert not torch.autograd._profiler_enabled()
    with trace.wait("nms_tile"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.wait("nms_tile"):
            pass
    assert opened == ["wait.nms_tile"]
    assert trace.stage("OvrRCNN", "backbone").name == "OvrRCNN.backbone"


def _step_events():
    """The trace events of one tiny LSM step and one tiny STT call."""
    events = []
    cfg, model, batch, class_emb = _tiny_lsm("cpu")
    step = make_train_step(model, *build_optimizer(cfg, model))
    gen = torch.Generator().manual_seed(0)
    step(batch, class_emb, gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, class_emb, gen)
    events.append(prof.events())
    _, model, batch, class_emb = _tiny_stt("cpu")
    call = make_eval_step(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(batch, class_emb)
    events.append(prof.events())
    return events


def test_stage_ranges_are_the_names_before_plus_losses():
    names = {e.name for evs in _step_events() for e in evs
             if e.name.startswith(STAGE_PREFIXES)}
    assert names == BEFORE | {"train_step.losses"}


def test_every_backward_node_traces_to_a_stage(tmp_path):
    cfg, model, batch, class_emb = _tiny_lsm("cpu")
    step = make_train_step(model, *build_optimizer(cfg, model))
    gen = torch.Generator().manual_seed(0)
    step(batch, class_emb, gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, class_emb, gen)
    path = str(tmp_path / "step.json")
    prof.export_chrome_trace(path)
    events = profile_step.load_events(path)
    stages = profile_step.node_stages(events)
    numbered = [v for v in stages.values() if v != profile_step.PARAMETERS]
    assert len(numbered) > 500
    assert all(numbered), sorted(set(numbered))
    assert "train_step.losses" in numbered
    rows, _, _ = profile_step.parse_events(events)
    split = profile_step.backward_split(events, rows, steps=1)
    assert split["mapped"] == split["nodes"] == len(numbered)
    backward = sum(r["self"] for r in rows
                   if profile_step.classify(r) == profile_step.BACKWARD)
    assert sum(split["buckets"].values()) == pytest.approx(backward / 1e3)
    assert {"trunk", "res5", "mmss", "parameters"} <= set(split["buckets"])
