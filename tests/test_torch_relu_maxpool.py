"""PyTorch port vs JAX: fused ReLU + 3x3/2 max-pool of the stem.

Tolerance: none. Max is exact, so the port's plain version (what the
wrapper runs on a CPU tensor) must equal the Pallas kernel, run in
interpret mode, bit for bit, on the heavy-tie cases of
tests/test_pallas_pool.py, and give NaN where it does; on shapes the Pallas kernel does not take
(odd H or W) it must equal XLA's relu -> max_pool. The CUDA kernel is
held against the plain version on the card by chip_smoke.py and by
tests/test_torch_kernels_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from locov_tpu.ops.pallas_pool import relu_maxpool as pallas_relu_maxpool
from locov_torch.ops import kernel_lib
from locov_torch.ops.relu_maxpool import (relu_maxpool, relu_maxpool_cuda,
                                          relu_maxpool_plain)
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

