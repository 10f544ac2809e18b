"""Fused ResNet bottleneck block (1x1 -> 3x3 -> 1x1 + residual + relu),
identity shortcut, stride 1, forward only, NHWC:

    out = relu(x + W3 . relu(W2 *conv3x3* relu(W1 . x + b1) + b2) + b3)

Counterpart of ``locov_tpu/ops/pallas_block.py``, with its argument
layouts: x [N, H, W, C], w1 [C, M], w2 [3, 3, M, M] (HWIO), w3 [M, C],
FrozenBN folded in, biases b1 [M], b2 [M], b3 [C]. Three versions:

- ``bottleneck_block_plain``: plain PyTorch with the Pallas kernel's
  rounding points: products in x's dtype with float32 sums (float32
  arithmetic on the x-dtype values, TF32 off), each bias added in
  float32, relu, one rounding of t1 and of t2 to x's dtype; the residual
  added from x in float32, relu, one rounding. conv2 pads t1 with zeros.
- ``bottleneck_block_ref``: the twin of ``bottleneck_block_xla``, three
  ``F.conv2d`` calls with bias and relu in the compute dtype (cuDNN on
  the card): the library yardstick of the bench, never called by the
  kernel path.
- ``bottleneck_block``: the ``torch.library`` custom op
  ``locov::bottleneck_block``, the hand-written kernel
  (``csrc/bottleneck_block.cu``) for a CUDA tensor, the plain version for
  a CPU tensor; its fake implementation gives the output's shape and
  dtype.

Like the JAX function it has no gradient: ``bottleneck_block`` raises
when grad mode is on and an input requires grad, rather than return an
output that autograd cannot see through.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernel_lib
from .conv import conv2d

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (64, 128)  # the bottleneck widths M the kernel takes


def _check_shapes(x, w1, b1, w2, b2, w3, b3) -> None:
    if x.dim() != 4:
        raise ValueError(f"bottleneck_block: expected NHWC x, got {x.shape}")
    c, m = x.shape[3], w1.shape[-1]
    want = {"w1": (c, m), "b1": (m,), "w2": (3, 3, m, m), "b2": (m,),
            "w3": (m, c), "b3": (c,)}
    for name, t in zip(want, (w1, b1, w2, b2, w3, b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"bottleneck_block: {name} {tuple(t.shape)}, "
                             f"expected {want[name]} for x {tuple(x.shape)}")


def bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The block with the Pallas kernel's rounding points, in plain
    PyTorch (float32 arithmetic; on the card with TF32 off)."""
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    xf = x.float()
    w1f, w2f, w3f = (t.to(dt).float() for t in (w1, w2, w3))
    t1 = torch.relu(xf @ w1f + b1.float()).to(dt)
    a2 = conv2d(t1.float().permute(0, 3, 1, 2), w2f.permute(3, 2, 0, 1),
                padding=1).permute(0, 2, 3, 1)
    t2 = torch.relu(a2 + b2.float()).to(dt)
    return torch.relu(t2.float() @ w3f + b3.float() + xf).to(dt)


def bottleneck_block_ref(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """``bottleneck_block_xla``'s formulation: three convolutions in the
    compute dtype, each with its bias, relu between them and after the
    residual add."""
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    t1 = F.relu(conv2d(xc, w1.t().to(dt)[:, :, None, None], b1.to(dt)))
    t2 = F.relu(conv2d(t1, w2.permute(3, 2, 0, 1).to(dt), b2.to(dt),
                       padding=1))
    t3 = conv2d(t2, w3.t().to(dt)[:, :, None, None], b3.to(dt))
    return F.relu(t3 + xc).permute(0, 2, 3, 1)


# The kernel's tiling (csrc/bottleneck_block.cu)
TR, TC = 8, 16          # output rows and columns of a tile
NH, NHP, NO = 180, 192, 128  # halo pixels, halo rows padded, outputs
NB = 64                 # channels of a conv1 or conv3 step
# bf16 (Bf16Layout), by M: ring stages, blocks an SM, W2 taps a step
BF16_LAYOUT = {64: {"STAGES": 2, "MINB": 2, "TPS": 3},
               128: {"STAGES": 3, "MINB": 1, "TPS": 1}}


def smem_bytes(dtype: torch.dtype, m: int) -> int:
    """Shared memory of a kernel block, as ``Bf16Layout`` and
    ``F32Layout`` in the source count it. bfloat16: t1 for the halo and
    a ring whose stage holds the largest of a step's operands (a halo
    chunk with its W1 rows, TPS taps of W2, a W3 chunk with the
    residual's chunk); rows padded by 8. float32: t1 or a W3 chunk, and the x and
    W1 chunks, a W2 tap or t2; rows padded by 4."""
    if dtype == torch.bfloat16:
        ldx, ldm = NB + 8, m + 8
        stage = max(NHP * ldx + NB * ldm, BF16_LAYOUT[m]["TPS"] * m * ldm,
                    m * ldx + NO * ldx)
        return 2 * (NH * ldm + BF16_LAYOUT[m]["STAGES"] * stage)
    kc, ldt = 32, m + 4
    ldx, ldn = kc + 4, NB + 4
    return 4 * (max(NHP * ldt, m * ldn)
                + max(NHP * ldx + kc * ldn, max(m, NO) * ldt))


def _fn():
    fn = kernel_lib.load("bottleneck_block").bottleneck_block_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, w2, b2, w3, b3, fill: float = None) -> torch.Tensor:
    """One launch of the kernel (no launch count). ``fill``: a value the
    output holds before the launch, so that a comparison sees what the
    kernel wrote."""
    kernel_lib.check_cuda_tensor(x, "bottleneck_block x", _DTYPES)
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    n, h, w, c = x.shape
    m = w1.shape[1]
    if c % 64 or m not in _WIDTHS:
        raise ValueError(f"bottleneck_block: the kernel takes C a multiple "
                         f"of 64 and M in {_WIDTHS}, got C {c}, M {m}")
    for t in (w1, b1, w2, b2, w3, b3):
        if t.device != x.device:
            raise ValueError(f"bottleneck_block: a weight on {t.device}, x "
                             f"on {x.device}")
    ws = [t.to(x.dtype).contiguous() for t in (w1, w2, w3)]
    bs = [t.to(torch.float32).contiguous() for t in (b1, b2, b3)]
    out = torch.empty_like(x)
    if fill is not None:
        out.fill_(fill)
    if any(t.data_ptr() % 16 for t in [x, out] + ws):
        raise ValueError("bottleneck_block: x and the weights must be "
                         "16-byte aligned")
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), ws[0].data_ptr(), bs[0].data_ptr(),
                    ws[1].data_ptr(), bs[1].data_ptr(), ws[2].data_ptr(),
                    bs[2].data_ptr(), out.data_ptr(), n, h, w, c, m,
                    _DTYPES[x.dtype], kernel_lib.stream_ptr(x.device))
    kernel_lib.check_launch(err, "bottleneck_block")
    return out


def bottleneck_block_cuda(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The kernel: x a contiguous NHWC float32/bfloat16 CUDA tensor of any
    H, W >= 1, C a multiple of 64, M 64 or 128; the weights are cast to
    x's dtype and the biases to float32 (on x's device)."""
    out = _launch(x, w1, b1, w2, b2, w3, b3)
    if out.numel():
        kernel_lib.LAUNCHES["bottleneck_block"] += 1
    return out


@torch.library.custom_op("locov::bottleneck_block", mutates_args=(),
                         device_types="cpu")
def _bottleneck_block_op(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, w3: torch.Tensor,
                         b3: torch.Tensor) -> torch.Tensor:
    return bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)


@_bottleneck_block_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, w3, b3):
    return bottleneck_block_cuda(x, w1, b1, w2, b2, w3, b3)


@_bottleneck_block_op.register_fake
def _(x, w1, b1, w2, b2, w3, b3):
    _check_shapes(x, w1, b1, w2, b2, w3, b3)
    return torch.empty_like(x)


def bottleneck_block(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """x [N, H, W, C] -> [N, H, W, C] (``locov::bottleneck_block``): the
    kernel for a CUDA tensor, the plain version for a CPU tensor. Raises
    under grad: the block has no gradient, as the JAX function has
    none."""
    args = (x, w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("bottleneck_block has no gradient: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")
    return torch.ops.locov.bottleneck_block(*args)
