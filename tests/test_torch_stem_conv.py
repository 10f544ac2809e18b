"""PyTorch port vs JAX: the opt-in weight gradients of
``locov_tpu/ops/stem_conv.py`` (the space-to-depth stem, the one-dot
1x1, the nine-dot 3x3), at the inputs of tests/test_stem_conv.py, float32:
forward and input gradient (the plain convolution's) and the weight
gradient (the JAX formulation) within rtol = atol = 1e-4 (float32 sums
in another order), forward within 1e-5. The port's trunk does not call
them (cuDNN's weight gradients serve it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import stem_conv as jsc
from locov_torch.ops import stem_conv as tsc
from torch_parity import n, t


def _grads(fn, loss, x, w, *extra):
    xt = t(np.asarray(x)).requires_grad_(True)
    wt = t(np.asarray(w)).requires_grad_(True)
    y = fn(xt, wt, *extra)
    loss(y).backward()
    return n(y), n(xt.grad), n(wt.grad)


def _assert_match(fn_t, fn_j, loss_t, loss_j, x, w, *extra):
    y, gx, gw = _grads(fn_t, loss_t, x, w, *extra)
    np.testing.assert_allclose(y, np.asarray(fn_j(x, w, *extra)),
                               rtol=1e-5, atol=1e-5)
    rx, rw = jax.grad(lambda a, b: loss_j(fn_j(a, b, *extra)),
                      (0, 1))(x, w)
    np.testing.assert_allclose(gx, np.asarray(rx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw, np.asarray(rw), rtol=1e-4, atol=1e-4)
    assert np.abs(gw).max() > 0


def test_conv7x7s2_matches_jax():
    kx, kw, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(kx, (2, 16, 20, 3))
    w = jax.random.normal(kw, (7, 7, 3, 8)) * 0.1
    _assert_match(tsc.conv7x7s2, jsc.conv7x7s2,
                  lambda y: (y * torch.cos(y.shape[3] + 0.1 * y)).sum(),
                  lambda y: jnp.sum(y * jnp.cos(y.shape[3] + 0.1 * y)), x, w)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_matches_jax(stride):
    kx, kw = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(kx, (2, 8, 10, 6))
    w = jax.random.normal(kw, (6, 4)) * 0.1
    _assert_match(tsc.conv1x1, jsc.conv1x1, lambda y: torch.sin(y).sum(),
                  lambda y: jnp.sum(jnp.sin(y)), x, w, stride)


def _conv3x3_inputs():
    """tests/test_stem_conv.py's res5-like cases (non-square, C != F)."""
    k, out = jax.random.PRNGKey(2), []
    for shape, cf in (((5, 7, 7, 12), (12, 16)), ((3, 4, 6, 8), (8, 8))):
        kx, kw, k = jax.random.split(k, 3)
        out.append((jax.random.normal(kx, shape),
                    jax.random.normal(kw, (3, 3) + cf) * 0.1))
    return out


@pytest.mark.parametrize("case", [0, 1])
def test_conv3x3_matches_jax(case):
    x, w = _conv3x3_inputs()[case]
    _assert_match(tsc.conv3x3, jsc.conv3x3, lambda y: torch.sin(y).sum(),
                  lambda y: jnp.sum(jnp.sin(y)), x, w)


@pytest.mark.parametrize("op,x_shape,w_shape,stride", [
    ("conv7x7s2", (1, 8, 12, 3), (7, 7, 3, 4), 2),
    ("conv7x7s2", (2, 10, 6, 3), (7, 7, 3, 8), 2),
    ("conv1x1", (1, 7, 9, 5), (5, 3), 1),
    ("conv1x1", (1, 7, 9, 5), (5, 3), 2),
    ("conv3x3", (1, 6, 5, 4), (3, 3, 4, 6), 1),
    ("conv3x3", (2, 1, 9, 4), (3, 3, 4, 4), 1),
])
def test_gradients_equal_autograd_of_the_conv(op, x_shape, w_shape, stride):
    """Shapes the JAX tests leave out (odd widths, H = 1, stride-2 1x1):
    output and both gradients equal autograd of ``F.conv2d`` within 1e-5
    of the largest value (float32 sums in another order)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(x_shape, generator=gen)
    w = torch.randn(w_shape, generator=gen) * 0.1
    args = (stride,) if op == "conv1x1" else ()
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = getattr(tsc, op)(xa, wa, *args)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    hwio = wb[None, None] if op == "conv1x1" else wb
    want = torch.nn.functional.conv2d(
        xb.permute(0, 3, 1, 2), hwio.permute(3, 2, 0, 1), stride=stride,
        padding=hwio.shape[0] // 2).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    cot = torch.randn(want.shape, generator=gen)
    got.backward(cot)
    want.backward(cot)
    for a, b in ((got, want), (xa.grad, xb.grad), (wa.grad, wb.grad)):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-5 * scale
