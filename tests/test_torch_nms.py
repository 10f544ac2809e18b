"""PyTorch port vs JAX: exact greedy NMS.

Tolerance: none. Keep masks must be identical to the JAX package's and
to a brute-force greedy NMS (also to ``tests/test_golden_torch.py``'s
torchvision-style one, where there are no classes), on negative
coordinates, many classes,
``stop_after`` (including the compacted survivor buffer, which needs
more than two tiles) and score ties."""
import jax.numpy as jnp
import numpy as np
import pytest

from locov_tpu.ops import nms as jnms
from locov_torch.ops import nms as tnms
from test_golden_torch import _greedy_nms as golden_greedy_nms
from torch_parity import n, t


def _greedy_keep(boxes, scores, valid, thr, classes=None):
    """Brute-force greedy NMS keep mask (stable score order; IoU as the
    JAX package computes it)."""
    keep = np.zeros(len(boxes), bool)
    sup = ~valid.copy()
    masked = np.where(valid, scores, np.finfo(np.float32).min)
    for i in np.argsort(-masked, kind="stable"):
        if sup[i]:
            continue
        keep[i] = True
        iou = n(tnms._pairwise_iou_b(t(boxes[None, i:i + 1]),
                                     t(boxes[None])))[0, 0]
        hit = iou > thr
        if classes is not None:
            hit &= classes == classes[i]
        sup |= hit
    return keep


def _case(rng, b, m, neg=False, ties=False, span=400.0):
    lo = rng.uniform(-span / 2 if neg else 0.0, span, (b, m, 2))
    wh = rng.uniform(4.0, 80.0, (b, m, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    if ties:
        scores = rng.randint(0, 6, (b, m)).astype(np.float32) / 5.0
    else:
        scores = rng.rand(b, m).astype(np.float32)
    valid = rng.rand(b, m) > 0.1
    return boxes, scores, valid


CASES = {
    "plain": dict(m=300),
    "negative_coords": dict(m=300, neg=True),
    "score_ties": dict(m=300, ties=True),
    "dense_ties": dict(m=200, ties=True, span=60.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_mask_matches_jax_and_greedy(rng, name):
    boxes, scores, valid = _case(rng, 2, **CASES[name])
    got = n(tnms.nms_mask_batched(t(boxes), t(scores), t(valid), 0.5))
    want = n(jnms.nms_mask_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.5))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], _greedy_keep(boxes[i], scores[i], valid[i], 0.5))
        # the repo's torchvision-style reference, run on the valid boxes
        idx = np.flatnonzero(valid[i])
        ref = np.zeros_like(got[i])
        ref[idx[golden_greedy_nms(boxes[i][idx], scores[i][idx], 0.5)]] = True
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("ncls,neg", [(3, False), (40, True)])
def test_per_class_nms_matches_jax_and_greedy(rng, ncls, neg):
    boxes, scores, valid = _case(rng, 2, 300, neg=neg, span=120.0)
    classes = rng.randint(0, ncls, (2, 300)).astype(np.int32)
    got = n(tnms.batched_nms_mask_batched(t(boxes), t(scores), t(classes),
                                          t(valid), 0.5))
    want = n(jnms.batched_nms_mask_batched(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jnp.asarray(valid), 0.5))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], _greedy_keep(boxes[i], scores[i], valid[i], 0.5,
                                 classes[i]))


@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("stop_after", [10, 100])
def test_stop_after_compacted_matches_jax(rng, classes, stop_after):
    # 900 boxes = 4 tiles of 256: the compacted survivor-buffer path;
    # a clustered image and a sparse one so rows stop at different tiles
    boxes, scores, valid = _case(rng, 2, 900, neg=True, ties=True,
                                 span=300.0)
    boxes[1] *= 4.0
    cls = rng.randint(0, 8, (2, 900)).astype(np.int32) if classes else None
    kw_t = {} if cls is None else {"classes": t(cls)}
    kw_j = {} if cls is None else {"classes": jnp.asarray(cls)}
    got = n(tnms.nms_mask_batched(t(boxes), t(scores), t(valid), 0.6,
                                  stop_after=stop_after, **kw_t))
    want = n(jnms.nms_mask_batched(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), 0.6,
                                   stop_after=stop_after, **kw_j))
    np.testing.assert_array_equal(got, want)
    # the top-stop_after survivors are the exact greedy ones
    for i in range(2):
        ref = _greedy_keep(boxes[i], scores[i], valid[i], 0.6,
                           None if cls is None else cls[i])
        order = np.argsort(-np.where(valid[i], scores[i], -np.inf),
                           kind="stable")
        first = [j for j in order if ref[j]][:stop_after]
        assert got[i][first].all()
        assert got[i].sum() >= min(stop_after, ref.sum())


def test_nms_topk_matches_jax(rng):
    boxes, scores, valid = _case(rng, 3, 700, ties=True)
    got_idx, got_ok = tnms.nms_topk_batched(t(boxes), t(scores), t(valid),
                                            0.7, 50)
    want_idx, want_ok = jnms.nms_topk_batched(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.7, 50)
    np.testing.assert_array_equal(n(got_ok), n(want_ok))
    np.testing.assert_array_equal(n(got_idx)[n(got_ok)],
                                  n(want_idx)[n(want_ok)])


def test_top_k_breaks_ties_like_lax(rng):
    import jax
    x = rng.randint(0, 4, (3, 50)).astype(np.float32)
    tv, ti = tnms.top_k(t(x), 20)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 20)
    np.testing.assert_array_equal(n(tv), n(jv))
    np.testing.assert_array_equal(n(ti), n(ji))
