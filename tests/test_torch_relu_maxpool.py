"""PyTorch port vs JAX: fused ReLU + 3x3/2 max-pool of the stem.

Tolerance: none. Max is exact, so the port's plain version (what the
wrapper runs on a CPU tensor) must equal the Pallas kernel, run in
interpret mode, bit for bit, on the heavy-tie cases of
tests/test_pallas_pool.py, and give NaN where it does; on shapes the Pallas kernel does not take
(odd H or W) it must equal XLA's relu -> max_pool. The CUDA kernel is
held against the plain version on the card by chip_smoke.py and by
tests/test_torch_kernels_gpu.py.

The backward's algorithm (``relu_maxpool_bwd_two_pass``: each window's
tap code, then the gather in row-major window order, masked) must equal
the plain backward bit for bit in float32, on every case and on odd
shapes; in bfloat16 it must equal the plain backward computed in
float32 and rounded once (the plain backward on the CPU sums in
bfloat16). It must equal the Pallas backward (interpret mode, at the
shapes it takes) bit for bit where dy holds multiples of 1/16, whose
float32 sums are exact in the Pallas kernel's order as in ours."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from locov_tpu.ops.pallas_pool import _bwd_impl as pallas_bwd
from locov_tpu.ops.pallas_pool import relu_maxpool as pallas_relu_maxpool
from locov_torch.ops import kernel_lib
from locov_torch.ops.relu_maxpool import (NO_TAP, relu_maxpool,
                                          relu_maxpool_bwd_plain,
                                          relu_maxpool_bwd_two_pass,
                                          relu_maxpool_cuda,
                                          relu_maxpool_plain, tap_codes)
from locov_torch.tools import bench_pool_bwd
from torch_parity import n, t


def _cases(rng):
    smooth = rng.randn(2, 32, 20, 8).astype(np.float32)
    # heavy ties: few distinct values, many exact repeats
    tied = rng.randint(-2, 3, size=(2, 48, 12, 8)).astype(np.float32)
    # bf16-quantized: adjacent near values collapse to equal bf16
    quant = np.asarray(
        jnp.asarray(rng.randn(1, 16, 64, 16).astype(np.float32) * 1e-2)
        .astype(jnp.bfloat16).astype(jnp.float32))
    # NaNs (and negative zeros) among heavy ties: a window holding a NaN
    # gives NaN, as jnp.maximum does
    nan = rng.randint(-2, 3, size=(2, 32, 12, 8)).astype(np.float32)
    nan[rng.rand(*nan.shape) < 0.02] = np.nan
    nan[rng.rand(*nan.shape) < 0.1] = -0.0
    return {"smooth": smooth, "tied": tied, "quant": quant, "nan": nan}


@pytest.mark.parametrize("name", ["smooth", "tied", "quant", "nan"])
def test_bit_exact_vs_pallas_interpret(rng, name):
    x = _cases(rng)[name]
    got = relu_maxpool(t(x))
    want = pallas_relu_maxpool(jnp.asarray(x), True)
    assert got.shape == want.shape
    if name == "nan":
        assert np.isnan(n(want)).any()
    np.testing.assert_array_equal(n(got), n(want))  # NaN where NaN


def test_bf16_bit_exact_vs_pallas_interpret(rng):
    x = rng.randint(-2, 3, size=(2, 32, 24, 8)).astype(np.float32) + \
        rng.randn(2, 32, 24, 8).astype(np.float32) * 0.01
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = relu_maxpool(xt)
    assert got.dtype == torch.bfloat16
    want = pallas_relu_maxpool(xj, True)
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(1, 7, 9, 3), (2, 15, 16, 5),
                                   (1, 1, 1, 4)])
def test_any_shape_matches_xla(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    want = nn.max_pool(nn.relu(jnp.asarray(x)), (3, 3), strides=(2, 2),
                       padding=((1, 1), (1, 1)))
    np.testing.assert_array_equal(n(relu_maxpool_plain(t(x))), n(want))


def test_wrapper_is_plain_on_cpu_and_launches_nothing(rng):
    x = t(rng.randn(1, 8, 8, 4).astype(np.float32))
    before = kernel_lib.LAUNCHES["relu_maxpool"]
    np.testing.assert_array_equal(n(relu_maxpool(x)),
                                  n(relu_maxpool_plain(x)))
    assert kernel_lib.LAUNCHES["relu_maxpool"] == before
    with pytest.raises(ValueError, match="CUDA"):
        relu_maxpool_cuda(x)



def _dy(rng, x, sixteenths=False):
    shape = (x.shape[0], (x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2,
             x.shape[3])
    dy = rng.randn(*shape).astype(np.float32)
    return np.round(dy * 16) / 16 if sixteenths else dy


def _bits(a):
    return n(a).view(np.int32)


@pytest.mark.parametrize("name", ["smooth", "tied", "quant", "nan"])
def test_two_pass_backward_bit_exact_vs_plain(rng, name):
    x = _cases(rng)[name]
    dy = _dy(rng, x)
    got = relu_maxpool_bwd_two_pass(t(x), t(dy))
    np.testing.assert_array_equal(
        _bits(got), _bits(relu_maxpool_bwd_plain(t(x), t(dy))))


@pytest.mark.parametrize("shape", [(1, 7, 9, 3), (2, 15, 16, 5),
                                   (1, 1, 1, 4), (3, 33, 47, 24)])
def test_two_pass_backward_bit_exact_at_odd_shapes(rng, shape):
    x = rng.randint(-2, 3, size=shape).astype(np.float32)
    u = rng.rand(*shape)
    x[u < 0.02] = np.nan
    x[(u >= 0.02) & (u < 0.12)] = -0.0
    dy = _dy(rng, x)
    got = relu_maxpool_bwd_two_pass(t(x), t(dy))
    np.testing.assert_array_equal(
        _bits(got), _bits(relu_maxpool_bwd_plain(t(x), t(dy))))


@pytest.mark.parametrize("name", ["smooth", "tied", "quant", "nan"])
def test_two_pass_backward_bit_exact_vs_pallas_interpret(rng, name):
    x = _cases(rng)[name]
    dy = _dy(rng, x, sixteenths=True)
    want = np.asarray(pallas_bwd(jnp.asarray(x), jnp.asarray(dy), True))
    got = n(relu_maxpool_bwd_two_pass(t(x), t(dy)))
    assert not np.isnan(got).any() and (got[np.isnan(x)] == 0).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_two_pass_backward_bf16_rounds_the_f32_sum_once(rng):
    x = rng.randint(-2, 3, size=(2, 32, 24, 8)).astype(np.float32)
    dy = _dy(rng, x)
    xb, dyb = t(x).to(torch.bfloat16), t(dy).to(torch.bfloat16)
    got = relu_maxpool_bwd_two_pass(xb, dyb)
    assert got.dtype == torch.bfloat16
    want = relu_maxpool_bwd_plain(xb.float(), dyb.float()).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the Pallas backward in bfloat16 (f32 sums, one rounding), with dy
    # in eighths below 2, whose sums of four windows are exact in bf16
    d8 = np.clip(np.round(dy * 8) / 8, -1.875, 1.875)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pal = pallas_bwd(xj, jnp.asarray(d8).astype(jnp.bfloat16), True)
    got = relu_maxpool_bwd_two_pass(xb, t(d8).to(torch.bfloat16))
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(pal.astype(jnp.float32)))


def test_tap_codes_take_the_first_max_and_no_tap_at_nan():
    # one window row, two windows: [a tie of 1s at taps 4 and 5, the
    # first wins | a NaN tap]; -0, 0 and relu(-3) tie at the first tap
    # of a zero window
    x = torch.tensor([[[[1.0], [1.0], [1.0], [float("nan")]],
                       [[0.0], [-0.0], [0.5], [2.0]]]])
    assert tap_codes(x).flatten().tolist() == [4, NO_TAP]
    z = torch.tensor([[[[-0.0], [0.0]], [[-3.0], [0.0]]]])
    assert tap_codes(z).flatten().tolist() == [4]


def test_pool_bwd_bench_twin_runs_on_cpu(capsys):
    line = bench_pool_bwd.main(["--device", "cpu", "--n", "1", "--h", "9",
                                "--w", "12", "--c", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["device"] == "cpu" and line["backward"] == "plain"
    for dt in ("float32", "bfloat16"):
        assert line[dt]["plain_ms"] > 0 and line[dt]["bound_ms"] > 0
