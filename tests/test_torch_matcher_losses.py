"""PyTorch port vs JAX: the IoU matcher, the label subsampler, box
encoding (``get_deltas``) and the loss primitives.

Tolerances: matcher indices and labels, and the sampled indices, are
identical (the same float32 inputs, and JAX's own uniform draws handed
to the port's sampler); box deltas rtol 1e-6 (a handful of float32
operations in the same order); losses rtol 1e-6 (the same, plus a
logsumexp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import losses as jl
from locov_tpu.ops import matcher as jm
from locov_tpu.structures import boxes as jb
from locov_torch.ops import losses as tl
from locov_torch.ops import matcher as tm
from locov_torch.structures import boxes as tb
from torch_parity import n, t

RPN = ((0.3, 0.7), (0, -1, 1))
ROI = ((0.5,), (0, 1))


def _quality(rng, b, m, nn):
    q = rng.rand(b, m, nn).astype(np.float32)
    q[:, :, 10:15] = q[:, :1, 10:11]      # ties across gt rows
    q[:, 2, 20] = q[:, 2, 21] = 0.97      # a gt's best quality, twice
    q[:, 1, 30], q[:, 1, 31] = 0.3, 0.7   # exactly on the thresholds
    q[:, 4, 40:] = 0.0                    # zero quality
    return q


@pytest.mark.parametrize("spec", [RPN, ROI])
@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("gt", ["mixed", "none"])
def test_match_matches_jax(rng, spec, low_quality, gt):
    q = _quality(rng, 3, 6, 50)
    mask = np.array([[1, 1, 1, 0, 1, 0], [1, 0, 0, 0, 0, 0],
                     [0, 1, 1, 1, 1, 1]], bool)
    if gt == "none":
        mask[:] = False
    got_idx, got_lab = tm.match(t(q), t(mask), *spec, low_quality)
    assert got_lab.dtype == torch.int8
    for i in range(3):  # the port is batched, JAX per image
        want_idx, want_lab = jm.match(jnp.asarray(q[i]), jnp.asarray(mask[i]),
                                      *spec, low_quality)
        np.testing.assert_array_equal(n(got_idx[i]), n(want_idx))
        np.testing.assert_array_equal(n(got_lab[i]), n(want_lab))


def _uniforms(seed, n_):
    kp, kn = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(kp, (n_,))),
            np.asarray(jax.random.uniform(kn, (n_,))))


@pytest.mark.parametrize("n_,num,frac", [(300, 64, 0.25), (300, 256, 0.5),
                                         (300, 64, 1.0), (40, 64, 0.5)])
def test_subsample_labels_matches_jax(rng, n_, num, frac):
    b = 3
    labels = rng.randint(-1, 2, (b, n_)).astype(np.int32)
    labels[1] = np.where(labels[1] == 1, 0, labels[1])  # no positives
    labels[2, : n_ // 2] = -1
    draws = [_uniforms(i, n_) for i in range(b)]
    u_pos = t(np.stack([d[0] for d in draws]))
    u_neg = t(np.stack([d[1] for d in draws]))
    idx, pos, valid = tm.subsample_labels(t(labels), num, frac, u_pos, u_neg)
    for i in range(b):
        w_idx, w_pos, w_valid = jm.subsample_labels(
            jnp.asarray(labels[i]), num, frac, jax.random.PRNGKey(i))
        np.testing.assert_array_equal(n(idx[i]), n(w_idx))
        np.testing.assert_array_equal(n(pos[i]), n(w_pos))
        np.testing.assert_array_equal(n(valid[i]), n(w_valid))


@pytest.mark.parametrize("weights", [(10.0, 10.0, 5.0, 5.0),
                                     (1.0, 1.0, 1.0, 1.0)])
def test_get_deltas_matches_jax_and_inverts_apply(rng, weights):
    lo = rng.uniform(-50, 600, (40, 2))
    src = np.concatenate([lo, lo + rng.uniform(1, 300, (40, 2))], -1)
    lo = rng.uniform(-50, 600, (40, 2))
    tgt = np.concatenate([lo, lo + rng.uniform(1, 300, (40, 2))], -1)
    src[:3] = 0.0  # zero-sized padding boxes
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    got = tb.get_deltas(t(src), t(tgt), weights)
    want = jb.get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    back = tb.apply_deltas(got[3:], t(src[3:]), weights)
    np.testing.assert_allclose(n(back), tgt[3:], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1_and_giou_match_jax(rng, beta):
    a = rng.randn(50, 4).astype(np.float32)
    b = rng.randn(50, 4).astype(np.float32)
    np.testing.assert_allclose(n(tl.smooth_l1(t(a), t(b), beta)),
                               n(jl.smooth_l1(jnp.asarray(a), jnp.asarray(b),
                                              beta)), rtol=1e-6, atol=1e-7)
    lo = rng.uniform(0, 50, (50, 2))
    p = np.concatenate([lo, lo + rng.uniform(-2, 40, (50, 2))], -1)
    q = np.concatenate([lo + 3, lo + rng.uniform(1, 40, (50, 2))], -1)
    p, q = p.astype(np.float32), q.astype(np.float32)
    np.testing.assert_allclose(n(tl.giou(t(p), t(q))),
                               n(jl.giou(jnp.asarray(p), jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("labels_kind", ["some_ignored", "all_ignored"])
def test_cross_entropy_matches_jax_and_is_empty_safe(rng, labels_kind):
    logits = (rng.randn(30, 7) * 3).astype(np.float32)
    labels = rng.randint(-1, 7, 30).astype(np.int64)
    if labels_kind == "all_ignored":
        labels[:] = -1
    ce, valid = tl.softmax_cross_entropy(t(logits), t(labels))
    jce, jvalid = jl.softmax_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels))
    np.testing.assert_allclose(n(ce), n(jce), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(valid), n(jvalid))
    got = tl.mean_cross_entropy(t(logits), t(labels))
    want = jl.mean_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if labels_kind == "all_ignored":
        assert float(got) == 0.0


def test_loss_kinks_take_jax_gradients():
    """|x| has gradient 1 at 0 and max(x, 0) gradient 1/2 there, as in
    JAX (an L1 box delta of exactly 0 occurs for an anchor centred on
    its gt)."""
    x = torch.zeros(3, requires_grad=True)
    (tl.smooth_l1(x, torch.zeros(3), 0.0).sum() + tl.max0(x).sum()).backward()
    want = jax.grad(lambda v: (jl.smooth_l1(v, jnp.zeros(3), 0.0)
                               + jnp.maximum(v, 0.0)).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(n(x.grad), n(want))
