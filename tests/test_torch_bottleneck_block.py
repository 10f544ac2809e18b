"""PyTorch port vs JAX: the fused bottleneck block (K4).

The port's ``bottleneck_block`` on a CPU tensor runs its plain version,
which has the Pallas kernel's rounding points; it is held against the
Pallas kernel in interpret mode at float32, rtol = atol = 2e-4 (the
tolerance of tests/test_pallas_block.py: float32 sums of 128 + 576 + 64
products in another order, through two relus). ``bottleneck_block_ref``
(three ``F.conv2d``) is held against ``bottleneck_block_xla`` at 1e-5,
and on shapes the Pallas kernel refuses (H not a multiple of 10, W not
of 8) the plain version against ``bottleneck_block_xla`` at 2e-4. The
CUDA kernel is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops.pallas_block import BH
from locov_tpu.ops.pallas_block import bottleneck_block as pallas_block
from locov_tpu.ops.pallas_block import bottleneck_block_xla
from locov_torch.ops import kernel_lib
from locov_torch.ops.bottleneck_block import (bottleneck_block,
                                              bottleneck_block_cuda,
                                              bottleneck_block_plain,
                                              bottleneck_block_ref)
from locov_torch.tools import bench_block
from torch_parity import n, t


def _inputs(rng, h, w, c, m, batch=2):
    """x and (w1, b1, w2, b2, w3, b3) at the scales of the JAX tests."""
    f32 = np.float32
    return [rng.randn(batch, h, w, c).astype(f32),
            (rng.randn(c, m) * 0.05).astype(f32),
            (rng.randn(m) * 0.1).astype(f32),
            (rng.randn(3, 3, m, m) * 0.05).astype(f32),
            (rng.randn(m) * 0.1).astype(f32),
            (rng.randn(m, c) * 0.05).astype(f32),
            (rng.randn(c) * 0.1).astype(f32)]


@pytest.mark.parametrize("h,w,c,m", [(BH, 16, 128, 64),
                                     (2 * BH, 24, 128, 64)])
def test_block_matches_pallas_interpret(rng, h, w, c, m):
    args = _inputs(rng, h, w, c, m)
    want = pallas_block(*(jnp.asarray(a) for a in args), interpret=True)
    before = kernel_lib.LAUNCHES["bottleneck_block"]
    got = bottleneck_block(*(t(a) for a in args))
    assert kernel_lib.LAUNCHES["bottleneck_block"] == before
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,w", [(BH, 16), (7, 9), (1, 5)])
def test_ref_matches_xla(rng, h, w):
    args = _inputs(rng, h, w, 128, 64)
    want = bottleneck_block_xla(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(bottleneck_block_ref(*(t(a) for a in args))),
                               n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,c,m", [(7, 9, 128, 64), (1, 5, 64, 64),
                                     (3, 11, 128, 128)])
def test_shapes_pallas_refuses_match_xla(rng, h, w, c, m):
    """H, W that the TPU kernel's VMEM tiling refuses (H % 10, W % 8)."""
    args = _inputs(rng, h, w, c, m)
    want = bottleneck_block_xla(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(bottleneck_block(*(t(a) for a in args))),
                               n(want), rtol=2e-4, atol=2e-4)


def test_t1_is_zero_padded(rng):
    """conv2 pads t1 with zeros, not with relu(b1): with a large b1 the
    border pixels would differ by relu(b1) through W2."""
    args = _inputs(rng, 4, 5, 64, 64)
    args[2] = np.full_like(args[2], 3.0)
    got = n(bottleneck_block_plain(*(t(a) for a in args)))
    want = n(bottleneck_block_xla(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_rounds_t1_and_t2_once(rng):
    """bfloat16: the plain version equals its own float32 arithmetic with
    t1, t2 and the output each rounded once to bfloat16."""
    args = _inputs(rng, 5, 6, 64, 64)
    bf = torch.bfloat16
    x, w1, b1, w2, b2, w3, b3 = (t(a) for a in args)
    xb = x.to(bf)
    got = bottleneck_block_plain(xb, w1, b1, w2, b2, w3, b3)
    assert got.dtype == bf
    w1f, w2f, w3f = (v.to(bf).float() for v in (w1, w2, w3))
    t1 = torch.relu(xb.float() @ w1f + b1).to(bf).float()
    a2 = torch.nn.functional.conv2d(t1.permute(0, 3, 1, 2),
                                    w2f.permute(3, 2, 0, 1), padding=1)
    t2 = torch.relu(a2.permute(0, 2, 3, 1) + b2).to(bf).float()
    want = torch.relu(t2 @ w3f + b3 + xb.float()).to(bf)
    assert torch.equal(got, want)


def test_block_raises_under_grad(rng):
    args = [t(a) for a in _inputs(rng, 2, 3, 64, 64)]
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        bottleneck_block(*args)
    with torch.no_grad():
        assert bottleneck_block(*args).shape == args[0].shape


def test_cuda_wrapper_refuses_cpu_and_bad_widths(rng):
    args = [t(a) for a in _inputs(rng, 2, 3, 64, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck_block_cuda(*args)
    bad = [t(a) for a in _inputs(rng, 2, 3, 64, 32)]
    with pytest.raises(ValueError, match="expected"):
        bottleneck_block_plain(bad[0], bad[1][:, :16], *bad[2:])


@pytest.mark.parametrize("check_only", [False, True])
def test_bench_twin_runs_on_cpu(capsys, check_only):
    argv = ["--device", "cpu", "--n", "1", "--h", "5", "--w", "7", "--c",
            "64", "--m", "64"] + (["--check-only"] if check_only else [])
    line = bench_block.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["device"] == "cpu" and line["timer"] == "host_clock"
    rel = line["value"] if check_only else line["max_rel_err"]
    assert 0 <= rel < 2e-2  # bfloat16, t1 and t2 rounded at other places
    if not check_only:
        assert line["block"] == "plain" and line["block_ms"] > 0
