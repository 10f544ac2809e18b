"""Fused ReLU + 3x3/2 max-pool (pad 1) of the ResNet stem, NHWC, with
its gradient.

Counterpart of ``locov_tpu/ops/pallas_pool.py`` (``relu_maxpool``, a
``custom_vjp`` over a forward and a backward Pallas kernel). On a CUDA
tensor ``relu_maxpool`` runs an autograd Function whose forward is the
hand-written kernel ``relu_maxpool_fwd`` and whose backward is
``relu_maxpool_bwd`` (``csrc/relu_maxpool.cu``); on a CPU tensor it runs
an autograd Function over the plain forward and the plain backward.
Taps outside the image act as -inf; the forward equals the plain
version bit for bit (max is exact), and the backward routes each
window's gradient to its first max in row-major order as
``F.max_pool2d`` does, then masks with ``x > 0`` as the Pallas backward
does: a NaN tap gets 0 (autograd of ``F.relu`` would pass the gradient
there), so a window whose max is NaN routes nothing.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernel_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def relu_maxpool_plain(x: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C] pre-relu -> max_pool3x3/2,pad1(relu(x))
    [N, ceil(H/2), ceil(W/2), C], in plain PyTorch."""
    y = F.max_pool2d(F.relu(x.permute(0, 3, 1, 2)), 3, 2, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def relu_maxpool_bwd_plain(x: torch.Tensor,
                           dy: torch.Tensor) -> torch.Tensor:
    """The gradient of ``relu_maxpool_plain`` at ``x`` for the output
    gradient ``dy``, by autograd, masked with ``x > 0`` (the Pallas
    backward's relu mask, 0 at a NaN tap): what the CUDA backward must
    equal."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(relu_maxpool_plain(xr), xr, dy)
    return torch.where(x > 0, dx, torch.zeros_like(dx))


def _fn(name, nargs):
    fn = getattr(kernel_lib.load("relu_maxpool"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nargs + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _vec(*tensors) -> int:
    """Channels per thread: 16 bytes' worth, or 1 where the channel
    count or a pointer is not aligned to it."""
    x = tensors[0]
    vec = 16 // x.element_size()
    if x.shape[3] % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def relu_maxpool_cuda(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel: x a contiguous NHWC float32/bfloat16 CUDA
    tensor of any H, W, C."""
    kernel_lib.check_cuda_tensor(x, "relu_maxpool x", _DTYPES)
    if x.dim() != 4:
        raise ValueError(f"relu_maxpool: expected NHWC, got {x.shape}")
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _fn("relu_maxpool_fwd", 2)(
            x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow,
            _DTYPES[x.dtype], _vec(x, y), kernel_lib.stream_ptr(x.device))
    kernel_lib.check_launch(err, "relu_maxpool")
    kernel_lib.LAUNCHES["relu_maxpool"] += 1
    return y


def relu_maxpool_bwd_cuda(x: torch.Tensor, dy: torch.Tensor
                          ) -> torch.Tensor:
    """The backward kernel: x the forward's input, dy [N, ceil(H/2),
    ceil(W/2), C] of x's dtype, both contiguous CUDA tensors ->
    dx [N, H, W, C]."""
    kernel_lib.check_cuda_tensor(x, "relu_maxpool_bwd x", _DTYPES)
    kernel_lib.check_cuda_tensor(dy, "relu_maxpool_bwd dy", (x.dtype,))
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    if tuple(dy.shape) != (n, oh, ow, c) or dy.device != x.device:
        raise ValueError(f"relu_maxpool_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} for x {tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    with torch.cuda.device(x.device):
        err = _fn("relu_maxpool_bwd", 3)(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow,
            _DTYPES[x.dtype], _vec(x, dy, dx),
            kernel_lib.stream_ptr(x.device))
    kernel_lib.check_launch(err, "relu_maxpool_bwd")
    kernel_lib.LAUNCHES["relu_maxpool_bwd"] += 1
    return dx


class _ReluMaxPool(torch.autograd.Function):
    """Both directions from the saved pre-relu input: K1-fwd and K1-bwd
    on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return relu_maxpool_cuda(x) if x.is_cuda else relu_maxpool_plain(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        if x.is_cuda:
            return relu_maxpool_bwd_cuda(x, dy.contiguous())
        return relu_maxpool_bwd_plain(x, dy)


def relu_maxpool(x: torch.Tensor) -> torch.Tensor:
    """y = maxpool3x3/2,pad1(relu(x)) on NHWC, differentiable: the
    kernels for a CUDA tensor, the plain versions for a CPU tensor."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"relu_maxpool: unsupported device {x.device}")
    return _ReluMaxPool.apply(x)
