"""PyTorch port vs JAX: the stem conv + BN shift (K5) and its gradient.

Forward: the port's ``stem_conv_bn`` on a CPU tensor (its plain
version: float32 conv of the bfloat16-rounded x and w, + shift, one
rounding) against the Pallas kernel in interpret mode, for every
variant (the JAX function's four TPU layouts; the port has one
kernel), at the shapes of tests/test_pallas_stem.py. Both contract the
same 147 products of bfloat16 values in float32, in other orders, so
each output is within one bfloat16 ulp of |want|.

Backward: the plain conv VJP (``_vjp_bwd``), against ``jax.grad`` of
the JAX function with the same cotangent (bfloat16 values, so both
sides see it exactly), within 1e-4 of the largest |gradient| of each
tensor (float32 sums of a conv's VJP in another order).

The kernel's contraction (``stem_conv_bn_packed``: ``_pack_weights`` and
the patch matrix in the kernel's k order) against the plain version and
the Pallas kernel: within one bfloat16 ulp plus 1e-5 * (|x| conv |w| +
|shift|), the float32 sum-order floor of an output close to 0."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import pallas_stem as ps
from locov_torch.ops import kernel_lib
from locov_torch.ops import stem_conv_bn as sc
from locov_torch.ops.stem_conv_bn import (_conv, _pack_weights, smem_bytes,
                                          stem_conv_bn, stem_conv_bn_cuda,
                                          stem_conv_bn_packed,
                                          stem_conv_bn_plain)
from locov_torch.tools import bench_stem
from torch_parity import n, t


def _bf16_ulp(mag):
    """A bfloat16 value in [2^(e-1), 2^e) has 8 significant bits."""
    return np.exp2(np.frexp(mag)[1] - 8.0)


def _inputs(rng, shape, x_dtype=jnp.bfloat16):
    nb, h, w = shape
    x = jnp.asarray(rng.randn(nb, h, w, 3), x_dtype)
    wk = jnp.asarray(rng.randn(7, 7, 3, 64) * 0.1, jnp.float32)
    shift = jnp.asarray(rng.randn(64), jnp.float32)
    return x, wk, shift


def _torch_x(x):
    xt = t(np.asarray(x.astype(jnp.float32)))
    return xt.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else xt


@pytest.mark.parametrize("variant", ["bigdot", "nhwc", "cw", "cw4"])
@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 16, 32), (1, 32, 48)])
def test_stem_conv_bn_matches_pallas_interpret(shape, variant):
    x, wk, shift = _inputs(np.random.RandomState(0), shape)
    want = np.asarray(ps.stem_conv_bn(x, wk, shift, variant, True)
                      .astype(jnp.float32))
    before = kernel_lib.LAUNCHES["stem_conv_bn"]
    got = stem_conv_bn(_torch_x(x), t(np.asarray(wk)), t(np.asarray(shift)))
    assert kernel_lib.LAUNCHES["stem_conv_bn"] == before
    nb, h, w = shape
    assert got.shape == (nb, h // 2, w // 2, 64)
    assert got.dtype == torch.bfloat16
    err = np.abs(n(got.float()) - want)
    assert (err <= _bf16_ulp(np.abs(want))).all(), err.max()


def test_float32_x_is_rounded_to_bf16_first():
    x, wk, shift = _inputs(np.random.RandomState(3), (1, 16, 32),
                           jnp.float32)
    want = np.asarray(ps.stem_conv_bn(x, wk, shift, "bigdot", True)
                      .astype(jnp.float32))
    got = n(stem_conv_bn(_torch_x(x), t(np.asarray(wk)),
                         t(np.asarray(shift))).float())
    assert (np.abs(got - want) <= _bf16_ulp(np.abs(want))).all()


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16])
def test_stem_conv_bn_gradients_match_jax(x_dtype):
    rng = np.random.RandomState(2)
    x, wk, shift = _inputs(rng, (2, 16, 20), x_dtype)
    g = np.asarray(jnp.asarray(rng.randn(2, 8, 10, 64), jnp.bfloat16)
                   .astype(jnp.float32))

    def loss(x_, w_, s_):
        out = ps.stem_conv_bn(x_, w_, s_, "bigdot", True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(x, wk, shift)
    xt = _torch_x(x).requires_grad_(True)
    wt = t(np.asarray(wk)).requires_grad_(True)
    st = t(np.asarray(shift)).requires_grad_(True)
    (stem_conv_bn(xt, wt, st).float() * t(g)).sum().backward()
    for got, w_ in zip((xt.grad, wt.grad, st.grad), want):
        assert str(got.dtype) == f"torch.{w_.dtype}"
        got, w_ = n(got.float()), np.asarray(w_.astype(jnp.float32))
        assert np.abs(w_).max() > 0
        assert np.abs(got - w_).max() <= 1e-4 * np.abs(w_).max()


def test_plain_on_cpu_and_refusals():
    x, wk, shift = (t(np.asarray(a.astype(jnp.float32))) for a in
                    _inputs(np.random.RandomState(1), (1, 8, 8)))
    assert torch.equal(stem_conv_bn(x, wk, shift),
                       stem_conv_bn_plain(x, wk, shift))
    with pytest.raises(ValueError, match="CUDA"):
        stem_conv_bn_cuda(x, wk, shift)
    with pytest.raises(ValueError, match="even"):
        stem_conv_bn(x[:, :7], wk, shift)


def test_bench_twin_runs_on_cpu(capsys):
    line = bench_stem.main(["--device", "cpu", "--n", "1", "--h", "16",
                            "--w", "20"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["device"] == "cpu" and line["stem"] == "plain"
    for part in ("fwd", "fwd_bwd"):
        assert line[part]["stem_ms"] > 0 and line[part]["library_ms"] > 0
    assert line["max_rel_err"] < 1e-2  # one bfloat16 rounding apart


def test_pack_weights_puts_each_kernel_row_after_three_zero_slots():
    w = torch.arange(7 * 7 * 3 * 2, dtype=torch.float32).reshape(7, 7, 3, 2)
    wp = _pack_weights(w)
    assert wp.shape == (sc.KP, 2) and wp.dtype == torch.bfloat16
    for ky in range(7):
        seg = wp[ky * sc.KSEG:(ky + 1) * sc.KSEG]
        assert (seg[:sc.LEAD] == 0).all()
        assert torch.equal(seg[sc.LEAD:],
                           w[ky].reshape(21, 2).to(torch.bfloat16))
    assert (wp[7 * sc.KSEG:] == 0).all()


def _floor(x, w, shift):
    """One bfloat16 ulp of |want| plus the float32 sum-order floor."""
    bf = torch.bfloat16
    return 1e-5 * n(_conv(x.to(bf).float().abs(), w.to(bf).float().abs())
                    + shift.abs())


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", [((1, 16, 16), 64), ((2, 22, 38), 32),
                                     ((1, 18, 34), 128)])
def test_packed_matmul_matches_plain(x_dtype, shape, f):
    rng = np.random.RandomState(4)
    x = t(rng.randn(*shape, 3).astype(np.float32)).to(x_dtype)
    w = t((rng.randn(7, 7, 3, f) * 0.1).astype(np.float32))
    shift = t(rng.randn(f).astype(np.float32))
    got = n(stem_conv_bn_packed(x, w, shift).float())
    want = n(stem_conv_bn_plain(x, w, shift).float())
    err = np.abs(got - want)
    assert (err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
            + _floor(x, w, shift)).all(), err.max()


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 16, 32), (1, 32, 48)])
def test_packed_matmul_matches_pallas_interpret(shape):
    x, wk, shift = _inputs(np.random.RandomState(0), shape)
    want = np.asarray(ps.stem_conv_bn(x, wk, shift, "bigdot", True)
                      .astype(jnp.float32))
    xt, wt, st = _torch_x(x), t(np.asarray(wk)), t(np.asarray(shift))
    got = n(stem_conv_bn_packed(xt, wt, st).float())
    err = np.abs(got - want)
    assert (err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
            + _floor(xt, wt, st)).all(), err.max()


def test_packed_matmul_masks_the_lead_slots():
    """The lead slots hold the previous pixel's values; an infinite x
    there must not reach an output it is not a tap of."""
    x = torch.zeros((1, 16, 16, 3))
    x[0, 5, 4, 2] = float("inf")  # a tap of output columns 1 and 2 only
    w = torch.ones((7, 7, 3, 32)) * 0.1
    got = stem_conv_bn_packed(x, w, torch.zeros(32)).float()
    want = stem_conv_bn_plain(x, w, torch.zeros(32)).float()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert not torch.isnan(got).any() and torch.isinf(got).any()


def _cu_constants():
    path = os.path.join(os.path.dirname(sc.__file__), os.pardir, "csrc",
                        "stem_conv_bn.cu")
    with open(path) as f:
        src = f.read()
    consts = dict((k, v) for k, v in re.findall(
        r"constexpr int (\w+) = ([^;]+);", src))
    env = {}
    for k, v in consts.items():
        try:  # each refers to earlier ones; a kernel's own (of F) skipped
            env[k] = eval(v, {}, dict(env))
        except NameError:
            pass
    return src, env


def test_smem_bytes_and_k_order_are_the_kernels():
    src, c = _cu_constants()
    assert (c["TR"], c["TC"], c["STAGES"], c["KSEG"]) == \
        (sc.TR, sc.TC, sc.STAGES, sc.KSEG)
    assert 16 * c["KSTEPS"] == sc.KP >= 7 * sc.KSEG
    assert "__shared__ __align__(16) TX patch[STAGES][PR * PW];" in src
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        assert smem_bytes(dtype) == c["STAGES"] * c["PR"] * c["PW"] * size
        assert smem_bytes(dtype) <= 48 * 1024  # static shared memory


def test_packed_weights_are_repacked_after_an_in_place_write():
    w = torch.randn((7, 7, 3, 32))
    a = sc._packed(w)
    assert torch.equal(a, _pack_weights(w)) and sc._packed(w) is a
    w.mul_(2.0)
    b = sc._packed(w)
    assert b is not a and torch.equal(b, _pack_weights(w))
    other = w.clone()
    assert sc._packed(other) is not b
    assert torch.equal(sc._packed(other), b)
