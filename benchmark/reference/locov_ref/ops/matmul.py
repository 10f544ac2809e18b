"""Matrix products in full float32 on the card.

The JAX package asks for ``Precision.HIGHEST`` where a float32 product
feeds a temperature-scaled softmax (the grounding head's
``v2l_projection`` and its word-region similarity): there, rounding to
TF32 (about three decimal digits) would show in the losses. PyTorch runs
a float32 matmul in TF32 when ``torch.backends.cuda.matmul.allow_tf32``
is True, so ``matmul_f32`` turns that flag off for the product and for
its backward, whatever the process has set, and restores it after, as
``ops/conv.py`` does for cuDNN. Only the legacy ``allow_tf32`` flag is
touched (mixing it with the newer ``fp32_precision`` settings in one
process can raise). On the CPU the flag has no effect.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cublas_f32():
    """cuBLAS's TF32 off while the body runs; the flag is restored on
    exit."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev


class _MatmulF32(torch.autograd.Function):
    """a @ b whose backward products also run with TF32 off: autograd
    runs them outside the forward's scope."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with cublas_f32():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        with cublas_f32():
            if ctx.needs_input_grad[0]:
                da = g @ b.transpose(-1, -2)
            if ctx.needs_input_grad[1]:
                db = a.transpose(-1, -2) @ g
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two float32 matrices [M, K] x [K, N], in full
    float32 forward and backward."""
    if a.dtype != torch.float32 or b.dtype != torch.float32 or \
            a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul_f32 takes two float32 matrices, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} "
                         f"{tuple(b.shape)}")
    return _MatmulF32.apply(a, b)


def linear_f32(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` ([..., in] -> [..., out]) in full
    float32: the product is rounded once, then the bias is added, as
    Flax's ``nn.Dense`` does."""
    y = matmul_f32(x.reshape(-1, x.shape[-1]), weight.t())
    y = y.reshape(x.shape[:-1] + (weight.shape[0],))
    return y if bias is None else y + bias
