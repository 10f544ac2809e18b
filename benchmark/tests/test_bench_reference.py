"""The plain reference against the program at a tiny size on the CPU:
the same seeded weights in both, and a whole run of each cell (the
program's loop, then the reference's check) whose compared numbers are
0, since in float32 on the CPU both run the same plain operations."""
import pytest
import torch

from benchmark import build
from benchmark.tests.tiny import CELLS, cpu_run, tiny_cell


@pytest.mark.parametrize("cell", CELLS)
def test_one_state_dict_for_both_sides(cell):
    from benchmark.reference.locov_ref.models import \
        build_meta_arch as build_reference
    from locov_torch.models import build_meta_arch
    conf = tiny_cell(cell)["config"]
    prog = build_meta_arch(build.program_cfg(conf), device="cpu")
    ref = build_reference(build.reference_cfg(conf), device="cpu")
    a = build.make_weights(prog, 5, "cpu", True)
    b = build.make_weights(ref, 5, "cpu", True)
    assert list(a) == list(b) == list(prog.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["backbone.res2.0.conv3_norm.weight"][0]) == \
        pytest.approx(0.2)
    prog.load_state_dict(a)
    ref.load_state_dict(b)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_program_and_reference_agree(cell, trace):
    res = cpu_run(cell, seed=2 ** 31 + 3, trace=trace)
    assert res["correct"] is True and res["failed"] == 0
    for name, v in res["checked"].items():  # a ratio of two zeros is 1
        assert v["value"] == (1.0 if name.endswith("_ratio") else 0.0)
    assert list(res["checked"]) == list(build.load_cell(cell)["limits"])
    metrics = res["metrics"]
    if trace:  # no device on the CPU: the device's metrics stay silent
        assert not any(k.startswith(("idle_share", "mfu", "roi_align"))
                       for k in metrics)
        assert any(k.startswith("rpn_nms_host_ms") for k in metrics)
    else:
        assert "setup_s" in metrics and "peak_mem_gib" in metrics
        assert res["attempted"] > 0
