"""The ResNet stem conv (7x7 / stride 2 / pad 3, 3 channels) plus the
FrozenBN shift, NHWC, with the plain conv VJP as its gradient.

Counterpart of ``locov_tpu/ops/pallas_stem.py:stem_conv_bn``: x
[N, H, W, 3] (H, W even), w [7, 7, 3, F] (HWIO, BN folded), shift [F]
-> conv7x7/s2/p3(bf16(x), bf16(w)) + shift as bfloat16 [N, H/2, W/2, F],
whatever x's dtype, with the sum in float32 and one rounding. The JAX
function's ``variant`` argument picks one of four TPU layouts of this
one function; the port has one kernel (``csrc/stem_conv_bn.cu``) and
no such argument. The kernel contracts over its own k order: 7
segments (ky) of 24, three zero-weight lead slots and the 21 values
(kx, c) of one input row, so that its A fragments are read straight
from the staged input patch; ``_pack_weights`` repacks w into that
order, and ``stem_conv_bn_packed`` computes the conv as the same matmul
in plain PyTorch (the tests hold it to the plain version and to JAX).

The gradient is the JAX package's ``_vjp_bwd``: the VJP of the plain
convolution at the un-rounded x and ``w.to(x.dtype)``, the cotangent
cast to x's dtype, dw cast to w's dtype, dshift the float32 sum of the
cotangent. ``stem_conv_bn`` calls the ``torch.library`` custom op
``locov::stem_conv_bn``: its forward is the kernel for a CUDA tensor and
the plain version for a CPU tensor, its registered backward that VJP,
and its fake implementation gives the output's shape and dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_lib
from .conv import conv2d, cudnn_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (32, 64, 128)  # output channels the kernel takes
# the kernel's k order and tiles (csrc/stem_conv_bn.cu)
KSEG, LEAD, KP = 24, 3, 176  # k slots a kernel row, its zero lead, k padded
TR, TC, STAGES = 8, 16, 3    # output rows, columns of a tile; patch buffers


def _check_shapes(x, w, shift) -> None:
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem_conv_bn: expected x [N, H, W, 3] with H and "
                         f"W even, got {tuple(x.shape)}")
    f = w.shape[-1]
    if tuple(w.shape) != (7, 7, 3, f) or tuple(shift.shape) != (f,):
        raise ValueError(f"stem_conv_bn: w {tuple(w.shape)}, shift "
                         f"{tuple(shift.shape)}: expected [7, 7, 3, F], [F]")


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv7x7/s2/p3 of NHWC x with HWIO w -> NHWC (full float32 for
    float32 x)."""
    y = conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
               padding=3)
    return y.permute(0, 2, 3, 1)


def stem_conv_bn_plain(x, w, shift) -> torch.Tensor:
    """The conv in float32 on the bfloat16-rounded x and w, + shift, one
    rounding to bfloat16 (on the card with TF32 off)."""
    _check_shapes(x, w, shift)
    bf = torch.bfloat16
    y = _conv(x.to(bf).float(), w.to(bf).float()) + shift.float()
    return y.to(bf).contiguous()


def stem_conv_bn_bwd_plain(x, w, g):
    """The JAX package's backward: (dx, dw, dshift) of the plain conv at x
    and ``w.to(x.dtype)`` for the output cotangent g."""
    gc = g.to(x.dtype).permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    # both gradients in one call, as autograd of F.conv2d makes it
    with cudnn_f32(x.dtype):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            gc, x.permute(0, 3, 1, 2), wc, None, (2, 2), (3, 3), (1, 1),
            False, (0, 0), 1, (True, True, False))
    return (dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0).to(w.dtype),
            g.sum((0, 1, 2), dtype=torch.float32))


_PACKED: list = [None, None, None]  # w, its version, _pack_weights(w)


def _packed(w: torch.Tensor) -> torch.Tensor:
    """``_pack_weights(w)``, repacked only when w is another tensor or
    was written in place since the last call (a conv's weights stay the
    same from call to call; the cache holds w, so its memory is not
    handed to another tensor meanwhile)."""
    if _PACKED[0] is not w or _PACKED[1] != w._version:
        _PACKED[:] = [w, w._version, _pack_weights(w)]
    return _PACKED[2]


def _pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO w [7, 7, 3, F] -> the kernel's B matrix [KP, F] bfloat16:
    row ky * KSEG + LEAD + kx * 3 + c holds w[ky, kx, c], every other row
    is 0."""
    f = w.shape[-1]
    wp = torch.zeros((KP, f), dtype=torch.bfloat16, device=w.device)
    wp[:7 * KSEG].view(7, KSEG, f)[:, LEAD:] = w.reshape(7, 21, f)
    return wp


def _patch_matrix(x: torch.Tensor) -> torch.Tensor:
    """The kernel's A matrix, [N, H/2, W/2, KP] float32 of bfloat16
    values: for output (oy, ox), segment ky holds the 24 values of input
    row 2 oy - 3 + ky from pixel 2 ox - 4 (zeros outside the image), its
    lead slots masked to 0 as the kernel masks them."""
    n, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    xp = torch.nn.functional.pad(x.to(torch.bfloat16).float(),
                                 (0, 0, 4, 2, 3, 3))
    segs = []
    for ky in range(7):
        rows = xp[:, ky:ky + 2 * ho:2]
        px = [rows[:, :, j:j + 2 * wo:2] for j in range(KSEG // 3)]
        seg = torch.stack(px, 3).reshape(n, ho, wo, KSEG)
        segs.append(torch.cat([torch.zeros_like(seg[..., :LEAD]),
                               seg[..., LEAD:]], -1))
    a = torch.cat(segs, -1)
    return torch.nn.functional.pad(a, (0, KP - a.shape[-1]))


def stem_conv_bn_packed(x, w, shift) -> torch.Tensor:
    """The kernel's contraction in plain PyTorch: ``_patch_matrix(x) @
    _pack_weights(w)`` in float32, + shift, one rounding to bfloat16."""
    _check_shapes(x, w, shift)
    y = _patch_matrix(x) @ _pack_weights(w).float() + shift.float()
    return y.to(torch.bfloat16)


def smem_bytes(dtype: torch.dtype) -> int:
    """Shared memory of a kernel block: the ring of STAGES input patches
    of 2 TR + 5 rows by 6 TC + 18 elements of x's dtype."""
    return STAGES * (2 * TR + 5) * (6 * TC + 18) * \
        torch.empty((), dtype=dtype).element_size()


def _fn():
    fn = kernel_lib.load("stem_conv_bn").stem_conv_bn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w, shift, fill: float = None) -> torch.Tensor:
    """One launch of the kernel (no launch count). ``fill``: a value the
    output holds before the launch, so that a comparison sees what the
    kernel wrote."""
    kernel_lib.check_cuda_tensor(x, "stem_conv_bn x", _DTYPES)
    _check_shapes(x, w, shift)
    n, h, wd, _ = x.shape
    f = w.shape[-1]
    if f not in _WIDTHS:
        raise ValueError(f"stem_conv_bn: the kernel takes F in {_WIDTHS}, "
                         f"got {f}")
    if w.device != x.device or shift.device != x.device:
        raise ValueError(f"stem_conv_bn: w on {w.device}, shift on "
                         f"{shift.device}, x on {x.device}")
    if x.data_ptr() % 8:
        raise ValueError("stem_conv_bn: x must be 8-byte aligned")
    wp = _packed(w)
    sh = shift.to(torch.float32).contiguous()
    out = torch.empty((n, h // 2, wd // 2, f), dtype=torch.bfloat16,
                      device=x.device)
    if fill is not None:
        out.fill_(fill)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), wp.data_ptr(), sh.data_ptr(),
                    out.data_ptr(), n, h, wd, f, _DTYPES[x.dtype],
                    kernel_lib.stream_ptr(x.device))
    kernel_lib.check_launch(err, "stem_conv_bn")
    return out


def stem_conv_bn_cuda(x, w, shift) -> torch.Tensor:
    """The kernel: x a contiguous, 8-byte aligned float32/bfloat16 CUDA
    tensor [N, H, W, 3] of any even H and W; F 32, 64 or 128."""
    out = _launch(x, w, shift)
    if out.numel():
        kernel_lib.LAUNCHES["stem_conv_bn"] += 1
    return out


@torch.library.custom_op("locov::stem_conv_bn", mutates_args=(),
                         device_types="cpu")
def _stem_conv_bn_op(x: torch.Tensor, w: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    return stem_conv_bn_plain(x, w, shift)


@_stem_conv_bn_op.register_kernel("cuda")
def _(x, w, shift):
    return stem_conv_bn_cuda(x, w, shift)


@_stem_conv_bn_op.register_fake
def _(x, w, shift):
    _check_shapes(x, w, shift)
    n, h, wd, _ = x.shape
    return x.new_empty((n, h // 2, wd // 2, w.shape[-1]),
                       dtype=torch.bfloat16)


def _setup(ctx, inputs, output):
    x, w, shift = inputs
    ctx.save_for_backward(x, w)
    ctx.shift_dtype = shift.dtype


def _backward(ctx, g):
    """The plain conv VJP from the saved un-rounded x and w."""
    x, w = ctx.saved_tensors
    dx, dw, dshift = stem_conv_bn_bwd_plain(x, w, g)
    return dx, dw, dshift.to(ctx.shift_dtype)


_stem_conv_bn_op.register_autograd(_backward, setup_context=_setup)


def stem_conv_bn(x, w, shift) -> torch.Tensor:
    """conv7x7/s2/p3(x, w) + shift as bfloat16 [N, H/2, W/2, F],
    differentiable in x, w and shift (``locov::stem_conv_bn``)."""
    return torch.ops.locov.stem_conv_bn(x, w, shift)
