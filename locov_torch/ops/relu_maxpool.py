"""Fused ReLU + 3x3/2 max-pool (pad 1) of the ResNet stem, NHWC, with
its gradient.

Counterpart of ``locov_tpu/ops/pallas_pool.py`` (``relu_maxpool``, a
``custom_vjp`` over a forward and a backward Pallas kernel). Both
directions are ``torch.library`` custom ops, ``locov::relu_maxpool``
and ``locov::relu_maxpool_bwd``, the first with the second as its
registered backward: on a CUDA tensor each runs its hand-written kernel
(``relu_maxpool_fwd``, ``relu_maxpool_bwd`` of ``csrc/relu_maxpool.cu``)
and nothing else, on a CPU tensor its plain version; their fake
implementations give the output's shape and dtype, so that
``torch.export`` traces through them. Taps outside the image act as
-inf; the forward equals the plain version bit for bit (max is exact),
and the backward routes each window's gradient to its first max in
row-major order as ``F.max_pool2d`` does, then masks with ``x > 0`` as
the Pallas backward does: a NaN tap gets 0 (autograd of ``F.relu``
would pass the gradient there), so a window whose max is NaN routes
nothing. ``relu_maxpool_bwd_two_pass`` computes the backward as the
kernel does (each window's tap code, then the gather); the tests hold
it to the plain backward and to the Pallas kernel.
"""
from __future__ import annotations

import ctypes
import math

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
    gradient ``dy``, as autograd computes it (the same ATen backward
    ops, called directly so that it also runs where autograd is off, as
    in a custom op's implementation), masked with ``x > 0`` (the Pallas
    backward's relu mask, 0 at a NaN tap): what the CUDA backward must
    equal."""
    aten = torch.ops.aten
    r = F.relu(x.permute(0, 3, 1, 2))
    _, idx = aten.max_pool2d_with_indices(r, [3, 3], [2, 2], [1, 1])
    g = aten.max_pool2d_with_indices_backward(
        dy.permute(0, 3, 1, 2), r, [3, 3], [2, 2], [1, 1], [1, 1], False,
        idx)
    dx = aten.threshold_backward(g, r, 0).permute(0, 2, 3, 1)
    return torch.where(x > 0, dx, torch.zeros_like(dx))


NO_TAP = 15  # tap code of a window that routes nothing (its max is NaN)


def tap_codes(x: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the backward kernel: [N, ceil(H/2), ceil(W/2), C] int,
    each window's argmax tap ty * 3 + tx of relu(x): the first strictly
    larger tap in row-major order (taps outside the image never win),
    ``NO_TAP`` where a tap is NaN."""
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    r = torch.full((n, 2 * oh + 1, 2 * ow + 1, c), -math.inf,
                   device=x.device)
    r[:, 1:h + 1, 1:w + 1] = F.relu(x.float())
    best = torch.full((n, oh, ow, c), -math.inf, device=x.device)
    code = torch.full((n, oh, ow, c), NO_TAP, dtype=torch.int32,
                      device=x.device)
    nan = torch.zeros((n, oh, ow, c), dtype=torch.bool, device=x.device)
    for tap in range(9):
        ty, tx = divmod(tap, 3)
        v = r[:, ty:ty + 2 * oh:2, tx:tx + 2 * ow:2]
        take = v > best
        best = torch.where(take, v, best)
        code = torch.where(take, torch.full_like(code, tap), code)
        nan |= torch.isnan(v)
    return torch.where(nan, torch.full_like(code, NO_TAP), code)


def relu_maxpool_bwd_two_pass(x: torch.Tensor,
                              dy: torch.Tensor) -> torch.Tensor:
    """The backward as the kernel computes it: ``tap_codes``, then for
    each input pixel the dy of its (at most 2 x 2) windows whose code
    names its tap, added in row-major window order from +0 in float32,
    masked with x > 0 and rounded once to x's dtype."""
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    code = tap_codes(x)
    acc = torch.zeros((n, h, w, c), device=x.device)
    iy = torch.arange(h, device=x.device)
    ix = torch.arange(w, device=x.device)
    # a pixel's windows: rows iy // 2 and (iy + 1) // 2 (two for odd iy)
    for a in (0, 1):
        oy = (iy + a) // 2
        vy = ((a == 0) | (iy % 2 == 1)) & (oy < oh)
        oy = oy.clamp(max=oh - 1)
        for b in (0, 1):
            ox = (ix + b) // 2
            vx = ((b == 0) | (ix % 2 == 1)) & (ox < ow)
            ox = ox.clamp(max=ow - 1)
            tap = (iy - 2 * oy + 1)[:, None] * 3 + (ix - 2 * ox + 1)
            hit = (code[:, oy][:, :, ox] == tap[None, :, :, None]) & \
                (vy[:, None] & vx)[None, :, :, None]
            g = dy[:, oy][:, :, ox].float()
            acc = acc + torch.where(hit, g, torch.zeros_like(g))
    return torch.where(x > 0, acc, torch.zeros_like(acc)).to(x.dtype)


def _fn(name, nargs, nints=8):
    fn = getattr(kernel_lib.load("relu_maxpool"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nargs + [ctypes.c_int] * nints + \
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


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor, rows: int = None,
                fill: float = None) -> torch.Tensor:
    """One launch of the backward kernel (no launch count): its default
    plan, or ``rows`` window rows a block. ``fill``: a value dx holds
    before the launch, so that a comparison sees what the kernel wrote."""
    kernel_lib.check_cuda_tensor(x, "relu_maxpool_bwd x", _DTYPES)
    kernel_lib.check_cuda_tensor(dy, "relu_maxpool_bwd dy", (x.dtype,))
    n, h, w, c = x.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    if tuple(dy.shape) != (n, oh, ow, c) or dy.device != x.device:
        raise ValueError(f"relu_maxpool_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} for x {tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    if fill is not None:
        dx.fill_(fill)
    if dx.numel() == 0:
        return dx
    args = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow,
            _DTYPES[x.dtype], _vec(x, dy, dx))
    with torch.cuda.device(x.device):
        stream = kernel_lib.stream_ptr(x.device)
        if rows is None:
            err = _fn("relu_maxpool_bwd", 3)(*args, stream)
        else:
            err = _fn("relu_maxpool_bwd_rows", 3, 9)(*args, rows, stream)
    kernel_lib.check_launch(err, "relu_maxpool_bwd")
    return dx


def relu_maxpool_bwd_cuda(x: torch.Tensor, dy: torch.Tensor
                          ) -> torch.Tensor:
    """The backward kernel: x the forward's input, dy [N, ceil(H/2),
    ceil(W/2), C] of x's dtype, both contiguous CUDA tensors ->
    dx [N, H, W, C]."""
    dx = _launch_bwd(x, dy)
    if dx.numel():
        kernel_lib.LAUNCHES["relu_maxpool_bwd"] += 1
    return dx


@torch.library.custom_op("locov::relu_maxpool", mutates_args=(),
                         device_types="cpu")
def _relu_maxpool_op(x: torch.Tensor) -> torch.Tensor:
    return relu_maxpool_plain(x)


@_relu_maxpool_op.register_kernel("cuda")
def _(x):
    return relu_maxpool_cuda(x)


@_relu_maxpool_op.register_fake
def _(x):
    n, h, w, c = x.shape
    return x.new_empty((n, (h + 1) // 2, (w + 1) // 2, c))


@torch.library.custom_op("locov::relu_maxpool_bwd", mutates_args=(),
                         device_types="cpu")
def _relu_maxpool_bwd_op(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return relu_maxpool_bwd_plain(x, dy)


@_relu_maxpool_bwd_op.register_kernel("cuda")
def _(x, dy):
    return relu_maxpool_bwd_cuda(x, dy.contiguous())


@_relu_maxpool_bwd_op.register_fake
def _(x, dy):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _backward(ctx, dy):
    (x,) = ctx.saved_tensors
    return torch.ops.locov.relu_maxpool_bwd(x, dy)


_relu_maxpool_op.register_autograd(_backward, setup_context=_setup)


def relu_maxpool(x: torch.Tensor) -> torch.Tensor:
    """y = maxpool3x3/2,pad1(relu(x)) on NHWC, differentiable
    (``locov::relu_maxpool``): the kernels for a CUDA tensor, the plain
    versions for a CPU tensor."""
    return torch.ops.locov.relu_maxpool(x)
