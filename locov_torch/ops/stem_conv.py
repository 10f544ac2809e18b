"""Convolutions with the JAX package's opt-in weight gradients, NHWC.

Counterpart of ``locov_tpu/ops/stem_conv.py``: ``conv7x7s2`` (the stem),
``conv1x1`` and ``conv3x3`` (stride 1, pad 1), each an autograd Function
whose forward and input gradient are the plain convolution's (cuDNN on
the card) and whose weight gradient is the JAX formulation, in float32
sums of products of the input dtype:

- the stem: the 7x7/s2 conv on 3 channels is a 4x4/s1 conv on the 2x2
  space-to-depth repack of the pad-3 input (12 channels, the kernel
  zero-padded to 8x8); dW is the contraction of each of its 16 taps'
  shifted slices with the cotangent, unpacked onto the 7x7 kernel (the
  entries of the 8th row and column, gradients of the zero padding, are
  dropped);
- 1x1: one dot of the (strided) input with the cotangent;
- 3x3: nine dots of the shifted slices of the zero-padded input with the
  cotangent.

Layouts are the JAX functions': x [N, H, W, C], w HWIO ([C, F] for the
1x1). The JAX trunk takes them behind env switches that its own notes
mark as measured dead ends on the TPU; the port's trunk does not take
them, and keeps cuDNN's weight gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import conv2d, cudnn_f32


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k]^T @ b [m, f] with float32 products and sums
    (``preferred_element_type=float32``)."""
    return a.float().t() @ b.float()


def _conv(x, w, stride, padding):
    """NHWC x, HWIO w -> NHWC (full float32 for float32 x)."""
    return _nhwc(conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride,
                        padding=padding))


def _dx(x, w, g, stride, padding):
    """The input gradient of ``_conv`` (the plain convolution's)."""
    with cudnn_f32(x.dtype):
        dx = torch.nn.grad.conv2d_input(_nchw(x).shape,
                                        w.permute(3, 2, 0, 1), _nchw(g),
                                        stride=stride, padding=padding)
    return _nhwc(dx)


class _Conv7x7s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w, 2, 3)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n, h, wid, c = x.shape
        f = w.shape[3]
        dx = _dx(x, w, g, 2, 3)
        # space-to-depth of the pad-3 input: [N, (H+6)/2, (W+6)/2, 4c],
        # channel (2 b + b') c + ch for input pixel (2 i + b, 2 j + b')
        xp = F.pad(x, (0, 0, 3, 3, 3, 3))
        h2, w2 = (h + 6) // 2, (wid + 6) // 2
        xs = xp.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
        xs = xs.reshape(n, h2, w2, 4 * c)
        ho, wo = h // 2, wid // 2
        gm = g.reshape(-1, f)
        # tap (a, a') of the 4x4 conv: [4c, F] each
        taps = torch.stack([
            _dot_f32(xs[:, a:a + ho, b:b + wo].reshape(-1, 4 * c), gm)
            for a in range(4) for b in range(4)])
        # [a, a', b, b', ch, f] -> kernel tap (2 a + b, 2 a' + b')
        dw = taps.reshape(4, 4, 2, 2, c, f).permute(0, 2, 1, 3, 4, 5)
        dw = dw.reshape(8, 8, c, f)[:7, :7]
        return dx, dw.to(w.dtype)


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w2d, stride):
        ctx.save_for_backward(x, w2d)
        ctx.stride = stride
        return _conv(x, w2d[None, None], stride, 0)

    @staticmethod
    def backward(ctx, g):
        x, w2d = ctx.saved_tensors
        s = ctx.stride
        dx = _dx(x, w2d[None, None], g, s, 0)
        xs = x[:, ::s, ::s] if s > 1 else x
        c, f = w2d.shape
        dw = _dot_f32(xs.reshape(-1, c), g.reshape(-1, f))
        return dx, dw.to(w2d.dtype), None


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w, 1, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n, h, wd, c = x.shape
        f = w.shape[3]
        dx = _dx(x, w, g, 1, 1)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        gm = g.reshape(-1, f)
        taps = [_dot_f32(xp[:, ky:ky + h, kx:kx + wd].reshape(-1, c), gm)
                for ky in range(3) for kx in range(3)]
        dw = torch.stack(taps).reshape(3, 3, c, f)
        return dx, dw.to(w.dtype)


def conv7x7s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C] (H, W even), w [7, 7, C, F] -> the 7x7/s2/pad-3
    conv, with the space-to-depth weight gradient."""
    return _Conv7x7s2.apply(x, w)


def conv1x1(x: torch.Tensor, w2d: torch.Tensor,
            stride: int = 1) -> torch.Tensor:
    """x [N, H, W, C], w2d [C, F] -> the 1x1 conv, with the one-dot weight
    gradient."""
    return _Conv1x1.apply(x, w2d, stride)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C], w [3, 3, C, F] -> the 3x3/s1/pad-1 conv, with the
    nine-dot weight gradient."""
    return _Conv3x3.apply(x, w)
