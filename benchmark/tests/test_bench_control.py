"""The control of each cell comes out not correct, at a size a test run
holds: the reference with its products in float8 e4m3 in the training
step's place, and the program's own int8 path in the inference cell
(``control.py``; on the card these readings set the limits' upper
ends). An inference configuration with no int8 path of its own (no
``control_settings``) takes the reference's detector in fp8 instead."""
import pytest
import torch

from benchmark import check, control
from benchmark.reference.fp8 import Fp8Products, e4m3
from benchmark.run import Run
from benchmark.tests.tiny import CELLS, tiny_cell


def test_e4m3_rounds_products_and_passes_the_gradient():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(32, 32, generator=gen).requires_grad_()
    b = torch.randn(32, 32, generator=gen)
    with Fp8Products():
        y = a @ b
    exact = a.detach() @ b
    err = float((y.detach() - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.1
    y.sum().backward()  # through the rounded b, straight through a's
    assert torch.allclose(a.grad, e4m3(b).sum(1).expand(32, 32),
                          atol=1e-5)
    q = e4m3(torch.tensor([448.0, 1.0, 0.3]))
    assert q.tolist() == [448.0, 1.0, 0.3125]  # e4m3: 3 mantissa bits


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    """At this size the program (float32, the plain versions) reads 0 on
    every gap, and 1 on every ratio to the plain computation (two zeros);
    the control reads above it on at least one, so a limit set between
    the two readings fails it."""
    c = tiny_cell(cell)
    infer = c["traffic"]["loop"] == "infer"
    prog = control.readings(Run(c, 17, 0.3, False, torch.device("cpu")),
                            "program")
    ctrl = control.readings(Run(c, 17, 0.3, False, torch.device("cpu"),
                                control=infer), "control")
    limits = {k: (1.0 if k.endswith("_ratio") else 0.0) + 1e-9
              for k in c["limits"]}
    assert all(prog[k] < limits[k] for k in c["limits"]), prog
    assert not check.verdict(ctrl, limits), ctrl
    assert check.verdict(prog, limits)


def test_an_inference_control_without_int8():
    """``stt`` without its ``control_settings``: the reference's detector
    with its products in fp8 answers the sampled calls, and reads above
    the program on both ratios."""
    c = tiny_cell("stt_infer_b8")
    del c["config"]["control_settings"]
    cpu = torch.device("cpu")
    prog = control.readings(Run(c, 19, 0.3, False, cpu), "program")
    ctrl = control.readings(Run(c, 19, 0.3, False, cpu, control=True),
                            "control")
    limits = {k: (1.0 if k.endswith("_ratio") else 0.0) + 1e-9
              for k in c["limits"]}
    assert check.verdict(prog, limits), prog
    assert ctrl["rpn_mse_ratio"] > limits["rpn_mse_ratio"], ctrl
    assert ctrl["det_mse_ratio"] > limits["det_mse_ratio"], ctrl
    assert ctrl["notes"]["detections"] > 0
