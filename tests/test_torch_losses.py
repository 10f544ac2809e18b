"""PyTorch port vs JAX: the loss helpers that no model path reads yet
(``locov_torch/ops/losses.py``: ``binary_cross_entropy_with_logits``,
``masked_softmax``, ``masked_log_softmax``) and the ``BoxBatch``
container (``locov_torch/structures/batches.py``), on the same numpy
inputs.

Tolerances: values and gradients rtol 1e-6 with atol 1e-7 (the same
float32 operations in the same order; gradients at the kinks of |x| and
max(x, 0) are JAX's, through ``ops/losses.py:l1`` and ``max0``);
fully-masked rows exactly 0 in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import losses as jlosses
from locov_tpu.structures import batches as jb
from locov_torch.ops import losses as tlosses
from locov_torch.structures import batches as tb
from torch_parity import n, t


def _close(got, want):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_binary_cross_entropy_with_logits_matches_jax(rng, masked):
    x = (rng.randn(4, 6) * 3).astype(np.float32)
    x[0, :3] = 0.0  # the kinks
    y = (rng.rand(4, 6) > 0.5).astype(np.float32)
    m = (rng.rand(4, 6) > 0.3).astype(np.float32) if masked else None

    def jfn(a):
        return jlosses.binary_cross_entropy_with_logits(
            a, jnp.asarray(y), None if m is None else jnp.asarray(m))
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    xx = t(x).requires_grad_(True)
    got = tlosses.binary_cross_entropy_with_logits(
        xx, t(y), None if m is None else t(m))
    _close(got.detach(), want)
    got.backward()
    _close(xx.grad, want_g)


def test_binary_cross_entropy_with_logits_is_empty_safe():
    assert float(jlosses.binary_cross_entropy_with_logits(
        jnp.zeros((0,)), jnp.zeros((0,)))) == 0.0
    assert float(tlosses.binary_cross_entropy_with_logits(
        torch.zeros(0), torch.zeros(0))) == 0.0
    empty = torch.zeros(3)
    assert float(tlosses.binary_cross_entropy_with_logits(
        torch.ones(3), torch.ones(3), empty)) == 0.0


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("fn", ["masked_softmax", "masked_log_softmax"])
def test_masked_softmaxes_match_jax(rng, dim, fn):
    x = rng.randn(5, 6).astype(np.float32)
    mask = rng.rand(5, 6) > 0.4
    mask[2, :] = False  # a row with nothing valid (dim 1)
    mask[:, 4] = False  # a column with nothing valid (dim 0)
    w = rng.randn(5, 6).astype(np.float32)

    def jfn(a):
        return getattr(jlosses, fn)(a, jnp.asarray(mask), dim)
    want = jfn(jnp.asarray(x))
    xx = t(x).requires_grad_(True)
    got = getattr(tlosses, fn)(xx, t(mask), dim)
    _close(got.detach(), want)
    if fn == "masked_softmax":
        empty = ~mask.any(axis=dim, keepdims=True)
        assert (n(got)[np.broadcast_to(empty, mask.shape)] == 0).all()
        want_g = jax.grad(lambda a: (jfn(a) * jnp.asarray(w)).sum())(
            jnp.asarray(x))
        (got * t(w)).sum().backward()
        _close(xx.grad, want_g)


def test_box_batch_is_jaxs():
    assert tb.BoxBatch._fields == jb.BoxBatch._fields == ("boxes", "mask")
    boxes = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    mask = np.array([[True, True, False], [True, False, False]])
    batch = tb.to_torch(tb.BoxBatch(boxes, mask), "cpu")
    assert isinstance(batch, tb.BoxBatch)
    np.testing.assert_array_equal(n(batch.boxes), boxes)
    assert batch.mask.dtype == torch.bool
    rows = tb.take_rows(batch, 1, 2)
    assert rows.boxes.shape == (1, 3, 4) and rows.mask.tolist() == [
        [True, False, False]]
