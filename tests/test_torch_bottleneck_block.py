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
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops.pallas_block import BH
from locov_tpu.ops.pallas_block import bottleneck_block as pallas_block
from locov_tpu.ops.pallas_block import bottleneck_block_xla
from locov_torch.ops import bottleneck_block as bb
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


def _cu_source():
    path = os.path.join(os.path.dirname(bb.__file__), os.pardir, "csrc",
                        "bottleneck_block.cu")
    with open(path) as f:
        return f.read()


def _c_expr(v):
    """A C constant expression as Python: integer division, and one
    ``a ? b : c``."""
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", v, re.S)
    if m:
        v = "(%s) if (%s) else (%s)" % (m.group(2), m.group(1), m.group(3))
    return v.replace("/", "//")


def _cu_layout(src, struct, m):
    """The ``static constexpr int`` members of ``struct`` in the source,
    evaluated in order at width ``m`` over the file's own constants."""
    env = {"cmax": max}
    for k, v in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        env[k] = eval(_c_expr(v), {}, dict(env))
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    env["M"] = m
    for k, v in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        env[k] = eval(_c_expr(v), {}, dict(env))
    return env


def test_smem_bytes_are_the_kernels():
    """The wrapper's count of a block's shared memory is the source's
    (``Bf16Layout``, ``F32Layout``), fits the blocks an SM the kernel is
    built for, and the tiling and layout constants are the kernel's."""
    src = _cu_source()
    c = _cu_layout(src, "Bf16Layout", 64)
    assert (c["TR"], c["TC"], c["NH"], c["NHP"], c["NO"], c["NB"]) == \
        (bb.TR, bb.TC, bb.NH, bb.NHP, bb.NO, bb.NB)
    assert c["NH"] == (bb.TR + 2) * (bb.TC + 2) <= bb.NHP
    for m in (64, 128):
        c = _cu_layout(src, "Bf16Layout", m)
        assert {k: c[k] for k in bb.BF16_LAYOUT[m]} == bb.BF16_LAYOUT[m]
        assert c["STAGES"] >= 2  # loads overlap products
        # 228 KB an SM, less 1 KB a block
        assert c["MINB"] * (c["BYTES"] + 1024) <= 233472
        for struct, dtype in (("Bf16Layout", torch.bfloat16),
                              ("F32Layout", torch.float32)):
            c = _cu_layout(src, struct, m)
            assert bb.smem_bytes(dtype, m) == c["BYTES"] <= 232448
    assert bb.smem_bytes(torch.bfloat16, 64) == 99648
    assert bb.smem_bytes(torch.bfloat16, 128) == 184128
    assert "__launch_bounds__(THREADS, Bf16Layout<M>::MINB)" in src


def test_trunk_block_folds_into_the_kernel_arguments():
    """bench_block's trunk block and its folded arguments compute the
    same block: the plain version on the folded weights against the
    trunk's ``BottleneckBlock`` in bfloat16 (the trunk adds each shift in
    bfloat16 after the conv rounds, the plain version in float32 before
    it rounds: a few bfloat16 ulps)."""
    gen = torch.Generator().manual_seed(0)
    block, wargs = bench_block.trunk_block(128, 64, gen)
    assert [tuple(a.shape) for a in wargs] == [
        (128, 64), (64,), (3, 3, 64, 64), (64,), (64, 128), (128,)]
    x = torch.randn((2, 5, 7, 128), generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        want = block(x).float()
        got = bottleneck_block(x, *wargs).float()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max())


def test_ablation_cuts_apply_to_the_source(tmp_path, monkeypatch):
    """Each cut of tools/ablate_block.py names text that the kernel's
    source (or its header) holds, so a copy with it cut can be built."""
    from locov_torch.tools import ablate_block
    monkeypatch.setattr(kernel_lib, "BUILD_DIR",
                        str(tmp_path / "build" / "kernels"))
    for name in [*ablate_block.CUTS, *ablate_block.LAYOUTS,
                 "conv1+conv2+conv3", "loads+stores"]:
        subs = ablate_block.variant_subs(name)
        src = ablate_block.write_variant(name, subs)
        assert src.startswith(str(tmp_path))
        if subs[0][0] == ablate_block.SRC and name in ablate_block.CUTS:
            with open(src) as f:
                text = f.read()
            assert subs[0][2] in text and subs[0][1] not in text
    for name, values in ablate_block.LAYOUTS.items():
        c = _cu_layout(_read(ablate_block.variant_dir(name)), "Bf16Layout",
                       64)
        assert tuple(c[k] for k in ablate_block.LAYOUT_KEYS) == values
        assert c["MINB"] * (c["BYTES"] + 1024) <= 233472  # 228 KB an SM
        assert c["STAGES"] >= 2


def _read(d):
    with open(os.path.join(d, "bottleneck_block.cu")) as f:
        return f.read()
