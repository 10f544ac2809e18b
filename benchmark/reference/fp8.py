"""The training control's precision: the reference with its products
computed in fp8, the usual recipe. Both operands of every convolution
and matrix product are rounded to float8 e4m3 first, and the gradient
that reaches each product's output in the backward to float8 e5m2; each
tensor is scaled by its max-abs to the format's largest value
(per-tensor scaling). The rounding passes the gradient as it is
(straight through); the backward's products take the rounded operands
that the forward saved, in the compute dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_TWO_OPERANDS = {F.conv2d, F.linear, torch.matmul, torch.mm, torch.bmm,
                 torch.Tensor.matmul, torch.Tensor.__matmul__,
                 torch.Tensor.__rmatmul__}
FORWARD = (torch.float8_e4m3fn, 448.0)
BACKWARD = (torch.float8_e5m2, 57344.0)


def rounded(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to ``fmt`` (a float8 dtype and its largest value)
    at its per-tensor scale, in its own dtype."""
    dtype, top = fmt
    with torch.no_grad():
        xf = x.detach().float()
        scale = xf.abs().amax().clamp(min=1e-30) / top
        return ((xf / scale).to(dtype).float() * scale).to(x.dtype)


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, with the gradient of the identity."""
    return x + (rounded(x, FORWARD) - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rounded(g, BACKWARD)


class Fp8Products(TorchFunctionMode):
    """Every product under this mode computed in fp8."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def q(a):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                return e4m3(a)
            return a
        if func in _TWO_OPERANDS:
            args = tuple(q(a) if i < 2 else a for i, a in enumerate(args))
        elif func is torch.einsum:
            args = (args[0],) + tuple(q(a) for a in args[1:])
        else:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out = _RoundGrad.apply(out)
        return out
