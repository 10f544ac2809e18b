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

