"""The port's float32 convolution helper (``locov_torch/ops/conv.py``).

On the card it turns cuDNN's TF32 off for float32 inputs, forward and
backward, and restores the flag; here, on the CPU, the checks are that
it computes exactly what ``F.conv2d`` and its autograd compute (the same
ATen ops: equal bits), that the flag is off while its convolutions run,
and that it leaves cuDNN's ``benchmark``, ``deterministic`` and
``allow_tf32`` as it found them. The card's side is
``tests/test_torch_kernels_gpu.py::
test_tiny_f32_model_on_the_card_at_pytorch_tf32_defaults``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from locov_torch.ops import conv


def _inputs(rng, bias):
    x = torch.from_numpy(rng.randn(2, 5, 9, 11).astype(np.float32))
    w = torch.from_numpy(rng.randn(7, 5, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(7).astype(np.float32)) if bias else None
    return [t.requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 3)])
def test_conv2d_computes_what_f_conv2d_computes(rng, bias, stride, padding):
    args = _inputs(rng, bias)
    b = args[2] if bias else None
    got = conv.conv2d(args[0], args[1], b, stride, padding)
    want = F.conv2d(args[0], args[1], b, stride, padding)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    for a, c in zip(torch.autograd.grad(got, args, g),
                    torch.autograd.grad(want, args, g)):
        assert torch.equal(a, c)


def test_conv2d_gradient_of_the_input_alone(rng):
    x, w = _inputs(rng, False)
    y = conv.conv2d(x, w.detach(), None, 1, 1)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    (want,) = torch.autograd.grad(F.conv2d(x, w.detach(), None, 1, 1), x,
                                  torch.ones_like(y))
    assert torch.equal(dx, want)


@pytest.mark.parametrize("tf32,benchmark,deterministic",
                         [(True, False, False), (True, True, True),
                          (False, True, False)])
def test_conv2d_scopes_tf32_off_and_restores_the_flags(
        rng, monkeypatch, tf32, benchmark, deterministic):
    cudnn = torch.backends.cudnn
    seen = []

    def spy(*a, **k):
        seen.append(cudnn.allow_tf32)
        return real(*a, **k)
    real = F.conv2d
    monkeypatch.setattr(F, "conv2d", spy)
    before = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    try:
        cudnn.allow_tf32 = tf32
        cudnn.benchmark = benchmark
        cudnn.deterministic = deterministic
        x, w = _inputs(rng, False)
        y = conv.conv2d(x, w)
        y.sum().backward()
        # bfloat16 goes to F.conv2d as it is, flags untouched
        conv.conv2d(x.detach().bfloat16(), w.detach().bfloat16())
        after = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    finally:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = before
    assert seen == [False, tf32]
    assert after == (tf32, benchmark, deterministic)
    assert x.grad is not None and w.grad is not None


def test_cudnn_f32_restores_the_flag_on_error():
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="boom"):
            with conv.cudnn_f32(torch.float32):
                assert not cudnn.allow_tf32
                raise RuntimeError("boom")
        assert cudnn.allow_tf32
        with conv.cudnn_f32(torch.bfloat16):
            assert cudnn.allow_tf32
    finally:
        cudnn.allow_tf32 = before
