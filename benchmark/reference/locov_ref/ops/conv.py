"""2-D convolution in full float32 on the card.

PyTorch lets cuDNN compute a float32 convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits; the JAX package computes its float32 convolutions in
float32. ``conv2d`` is ``F.conv2d`` with cuDNN's TF32 turned off for the
call when the input is float32, forward and backward, whatever the
process's flags say, and restored after: only ``allow_tf32`` is touched,
through the same legacy flag the callers may set (mixing it with the
newer ``fp32_precision`` settings in one process can raise). Inputs of
other dtypes go to ``F.conv2d`` as they are.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def cudnn_f32(dtype: torch.dtype):
    """cuDNN's TF32 off while the body runs, when ``dtype`` is float32;
    the flag is restored on exit."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class _Conv2dF32(torch.autograd.Function):
    """F.conv2d of float32 tensors whose backward also runs with TF32
    off: autograd's own convolution backward reads the flag when it
    runs, outside the forward's scope."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (None if bias is None else list(bias.shape), stride,
                    padding)
        with cudnn_f32(x.dtype):
            return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        bias_sizes, stride, padding = ctx.conf
        mask = list(ctx.needs_input_grad[:3])
        mask[2] = mask[2] and bias_sizes is not None
        with cudnn_f32(x.dtype):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, bias_sizes, [stride] * 2, [padding] * 2,
                [1, 1], False, [0, 0], 1, mask)
        return dx, dw, db, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding)`` (NCHW, OIHW), in
    full float32 when x is float32."""
    if x.dtype != torch.float32:
        return F.conv2d(x, weight, bias, stride, padding)
    return _Conv2dF32.apply(x, weight, bias, stride, padding)
