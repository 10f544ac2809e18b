"""PyTorch port vs JAX: inference ROIAlign.

The port's plain separable version (what ``roi_align_fused`` runs on a
CPU tensor) is held against both JAX functions on the path,
``roi_align_batched`` (XLA, precision "highest") and
``roi_align_pallas_fused`` run in Pallas interpret mode, at sampling
ratio 2 and 0 (adaptive), with large, tiny, degenerate, out-of-image
boxes and boxes above the 8-sample adaptive cap.

Tolerance: atol 1e-5 * max|F|. Each output is a convex combination of
features (weights >= 0, summing to <= 1) accumulated in float32 in a
different order on each side, so the error is a few float32 ulps of
max|F|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import roi_align as jroi
from locov_tpu.ops.pallas_roi_align import roi_align_pallas_fused
from locov_torch.ops import kernel_lib
from locov_torch.ops import roi_align as troi
from locov_torch.tools import bench_roi_bwd
from torch_parity import n, t

STRIDE = 16.0


def _features(rng, b=2, h=16, w=24, c=128):
    return (rng.randn(b, h, w, c) * 3.0).astype(np.float32)


def _boxes(rng, b=2, h=16, w=24):
    img_h, img_w = h * STRIDE, w * STRIDE
    special = np.array([
        [0, 0, img_w, img_h],                    # whole image
        [10.0, 12.0, 13.0, 14.0],                # tiny (sub-cell)
        [50.0, 40.0, 50.0, 90.0],                # zero width: degenerate
        [80.0, 60.0, 70.0, 50.0],                # inverted: degenerate
        [-100.0, -80.0, 30.0, 20.0],             # partly outside
        [img_w + 20, img_h + 30, img_w + 90, img_h + 99],  # outside
        [-2000.0, -50.0, 2000.0, img_h + 40],   # wider than the 8 cap
        [5.5, 7.25, 300.75, 240.5],              # fractional edges
    ], np.float32)
    k = 12
    lo = rng.uniform(-40, max(img_w, img_h), (b, k, 2))
    wh = rng.uniform(1.0, 300.0, (b, k, 2))
    rand = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    return np.concatenate(
        [np.broadcast_to(special, (b,) + special.shape), rand], 1).copy()


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_plain_matches_roi_align_batched(rng, sampling_ratio):
    f, bx = _features(rng), _boxes(rng)
    got = troi.roi_align_fused(t(f), t(bx), 1 / STRIDE, 14, sampling_ratio)
    want = jroi.roi_align_batched(jnp.asarray(f), jnp.asarray(bx),
                                  1 / STRIDE, 14, sampling_ratio)
    assert got.shape == (2, bx.shape[1], 14, 14, 128)
    np.testing.assert_allclose(n(got), n(want), rtol=0,
                               atol=1e-5 * np.abs(f).max())


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_plain_matches_pallas_fused_interpret(rng, sampling_ratio):
    f, bx = _features(rng, c=64), _boxes(rng)
    got = troi.roi_align_batched(t(f), t(bx), 1 / STRIDE, 7,
                                 sampling_ratio)
    want = roi_align_pallas_fused(jnp.asarray(f), jnp.asarray(bx),
                                  1 / STRIDE, 7, sampling_ratio,
                                  interpret=True)
    np.testing.assert_allclose(n(got), n(want), rtol=0,
                               atol=1e-5 * np.abs(f).max())


def test_degenerate_boxes_give_exact_zero(rng):
    f, bx = _features(rng), _boxes(rng)
    out = n(troi.roi_align_batched(t(f), t(bx), 1 / STRIDE, 14, 0))
    assert (out[:, 2:4] == 0).all()
    assert (out[:, 5] == 0).all()      # wholly outside the image
    assert np.abs(out[:, 0]).max() > 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_interp_matrices_match_jax(rng, adaptive):
    lo = rng.uniform(-5, 20, 9).astype(np.float32)
    size = rng.uniform(-1, 200, 9).astype(np.float32)
    if adaptive:
        tc, tw = troi._adaptive_coords(t(lo), t(size), 14)
        jc, jw = jroi._adaptive_coords(jnp.asarray(lo), jnp.asarray(size), 14)
        np.testing.assert_allclose(n(tw), n(jw), atol=1e-7)
        got = troi._interp_matrix(tc, 24, tw)
        want = jroi._interp_matrix(jc, 24, jw)
    else:
        got = troi._interp_matrix(troi._sample_coords(t(lo), t(size), 14, 2),
                                  24)
        want = jroi._interp_matrix(
            jroi._sample_coords(jnp.asarray(lo), jnp.asarray(size), 14, 2),
            24)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


def test_chunking_does_not_change_the_result(rng, monkeypatch):
    f, bx = _features(rng, c=16), _boxes(rng)
    monkeypatch.setattr(troi, "_CHUNK", 1000)
    whole = troi.roi_align_batched(t(f), t(bx), 1 / STRIDE, 14, 0)
    monkeypatch.setattr(troi, "_CHUNK", 7)
    chunked = troi.roi_align_batched(t(f), t(bx), 1 / STRIDE, 14, 0)
    np.testing.assert_allclose(n(chunked), n(whole), rtol=0, atol=1e-6)


def test_wrapper_is_plain_on_cpu_and_checks_cuda_inputs(rng):
    f, bx = t(_features(rng, c=8)), t(_boxes(rng))
    before = kernel_lib.LAUNCHES["roi_align_fused"]
    out = troi.roi_align_fused(f.to(torch.bfloat16), bx, 1 / STRIDE, 14, 0)
    assert out.dtype == torch.bfloat16
    assert kernel_lib.LAUNCHES["roi_align_fused"] == before
    with pytest.raises(ValueError, match="CUDA"):
        troi.roi_align_cuda(f, bx, 1 / STRIDE)


# The feature gradient's CUDA kernel cannot run here; its launch plan is
# plain Python and is checked at every shape the port gives it: the
# detector's features at 800 x 1344 (50 x 84), the tests' 25 x 42 and
# 16 x 24, heights that leave a part band (7, 1), c 12 to 1024.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(50, 84), (25, 42), (16, 24), (7, 84),
                                 (1, 84)])
@pytest.mark.parametrize("c", [12, 64, 256, 1024])
def test_bwd_plan_fits_a_block(h, w, c, dtype):
    plan = troi._bwd_plan(h, w, c, dtype)
    assert 1 <= plan["band_rows"] <= max(1, min(4, h))
    assert plan["band_rows"] in (1, 2, 4)
    assert plan["channel_tile"] % 8 == 0 and plan["channel_tile"] <= 128
    assert plan["smem_bytes"] == troi._bwd_smem(
        plan["band_rows"], w, plan["channel_tile"], 14)
    assert plan["smem_bytes"] <= 232448
    assert plan["threads"] == 256


@pytest.mark.parametrize("dtype,rows,tile", [(torch.float32, 4, 64),
                                             (torch.bfloat16, 2, 128)])
def test_bwd_plan_main_shape_keeps_two_blocks_an_sm(dtype, rows, tile):
    plan = troi._bwd_plan(50, 84, 1024, dtype)
    assert (plan["band_rows"], plan["channel_tile"]) == (rows, tile)
    assert 2 * (plan["smem_bytes"] + 1024) <= 233472


def test_bwd_plan_refuses_a_width_that_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        troi._bwd_plan(50, 4000, 1024, torch.float32)
    with pytest.raises(TypeError):
        troi._bwd_plan(50, 84, 1024, torch.float16)


def test_bench_boxes_lie_in_the_image_and_the_bench_needs_the_card(
        monkeypatch):
    gen = torch.Generator().manual_seed(0)
    bx = bench_roi_bwd.train_boxes(gen, b=2, n=64, n_gt=4)
    assert bx.shape == (2, 64, 4) and bx.dtype == torch.float32
    assert bool((bx[..., 2:] > bx[..., :2]).all())
    assert bool((bx[..., :2] >= 0).all())
    assert bool((bx[..., 2] <= 1344 + 1e-3).all())
    assert bool((bx[..., 3] <= 800 + 1e-3).all())
    # gt-sized boxes last: sides 32 to 400 px
    sides = bx[:, -4:, 2:] - bx[:, -4:, :2]
    assert bool(((sides >= 32 - 1e-3) & (sides <= 400 + 1e-3)).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_roi_bwd.main([])


# The forward kernel cannot run here either; its launch plan is checked
# at every shape the port gives it: the detector's features (50 x 84),
# the tests' (25 x 42, 16 x 24, heights 7 and 1), the tiny models' 4 x 4,
# channel counts 8 to 1024, pooled 7, 14 and 32, aligned or not.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(50, 84), (25, 42), (16, 24), (7, 84),
                                 (1, 84), (4, 4)])
@pytest.mark.parametrize("c", [8, 12, 64, 256, 1024])
@pytest.mark.parametrize("pooled,align", [(14, 32), (14, 16), (14, 2),
                                          (7, 32), (32, 32)])
def test_fwd_plan_fits_a_block(h, w, c, dtype, pooled, align):
    plan = troi._fwd_plan(h, w, c, dtype, pooled, align)
    vec, tile = plan["vec"], plan["channel_tile"]
    size = torch.finfo(dtype).bits // 8
    # the widest vector, 32 or 16 bytes, the channels and the address allow
    want = 1
    for nbytes in (16, 32):
        if align >= nbytes and c % (nbytes // size) == 0:
            want = nbytes // size
    assert vec == want
    assert tile % 8 == 0 and tile % vec == 0 and tile // vec <= 128
    assert tile < c + 8  # no tile wider than the channels need
    assert plan["threads"] % 32 == 0
    assert min(tile // vec, 32) <= plan["threads"] <= 256
    assert 1 <= plan["rows"] <= pooled
    assert plan["smem_bytes"] == troi._fwd_smem(h, w, plan["rows"], pooled)
    assert plan["smem_bytes"] <= 48 * 1024


def test_fwd_plan_main_shape():
    # 32-byte vectors, the fastest of the plans timed on the H100
    for dtype, vec, threads in ((torch.bfloat16, 16, 64),
                                (torch.float32, 8, 128)):
        plan = troi._fwd_plan(50, 84, 1024, dtype)
        assert (plan["vec"], plan["channel_tile"], plan["threads"],
                plan["rows"]) == (vec, 1024, threads, 2)
        assert plan["smem_bytes"] == 4 * (14 * 84 + plan["rows"] * 50 +
                                          2 * (14 + plan["rows"]))


def test_fwd_plan_refuses_what_cannot_fit():
    # Kx over 5000 columns at pooled 14 exceeds a block's memory
    with pytest.raises(ValueError, match="shared memory"):
        troi._fwd_plan(50, 5000, 1024, torch.float32)
    with pytest.raises(TypeError):
        troi._fwd_plan(50, 84, 1024, torch.float16)


def _c_smem_formula(name):
    """The body of ``size_t <name>(...)`` in csrc/roi_align.cu as a
    Python function of its arguments (casts dropped)."""
    import os
    import re
    src = open(os.path.join(kernel_lib.CSRC, "roi_align.cu")).read()
    m = re.search(r"size_t " + name + r"\(([^)]*)\)\s*\{\s*return(.*?);\s*\}",
                  src, re.S)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = re.sub(r"\(size_t\)", "", m.group(2))
    return eval(f"lambda {', '.join(args)}: {body}")  # noqa: S307


@pytest.mark.parametrize("h,w,rows,pooled", [(50, 84, 2, 14), (7, 42, 7, 7),
                                              (1, 84, 1, 32), (4, 4, 14, 14)])
def test_fwd_smem_is_the_c_entrys_count(h, w, rows, pooled):
    fwd = _c_smem_formula("fwd_smem_bytes")
    assert troi._fwd_smem(h, w, rows, pooled) == fwd(h, w, rows, pooled)
    plan = troi._fwd_launch_plan(h, w, 64, 8, pooled, rows)
    assert plan["smem_bytes"] == fwd(h, w, rows, pooled)


def test_fwd_bench_boxes_and_the_bench_needs_the_card(monkeypatch):
    from locov_torch.tools import bench_roi_fwd
    gen = torch.Generator().manual_seed(0)
    bx = bench_roi_fwd.proposal_boxes(gen, 2, 200)
    assert bx.shape == (2, 200, 4) and bx.dtype == torch.float32
    sides = bx[..., 2:] - bx[..., :2]
    assert bool((sides >= 8 - 1e-3).all())
    assert bool((bx[..., :2] >= 0).all())
    assert bool((bx[..., 2] <= 1344 + 1e-3).all())
    assert bool((bx[..., 3] <= 800 + 1e-3).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_roi_fwd.main([])
