"""int8 convolution of the int8 serving mode (``TPU.INT8_EVAL``), NHWC.

Counterpart of ``locov_tpu/ops/int8_conv.py``. The scheme is the JAX
package's post-training quantization, with no calibration data needed
for its default:

- weights: symmetric per-output-channel scales (max-abs / 127) of the
  FrozenBN-folded kernel (the fold comes first, ``models/resnet.py``);
- activations: a symmetric per-tensor scale, max-abs / 127 computed on
  the fly (``quantize_per_tensor``, the dynamic scheme) or from a
  calibrated max-abs (``quantize_per_tensor_static``);
- int8 x int8 products summed in int32, dequantized in float32 by
  ``sx * sw[o]`` (computed in float32 first), rounded once to the output
  dtype, then the FrozenBN shift added in that dtype and the relu.

Rounding is half to even (``torch.round``, as ``jnp.round``), values
clip to +-127, and every scale is at least 1e-12, so an all-zero tensor
quantizes to zeros with a finite scale. Divisions are by tensors: on
CUDA PyTorch divides by a Python scalar as a multiply by its reciprocal,
an ulp off the JAX package's division.

The product and its epilogue are the ``torch.library`` custom op
``locov::conv_int8``: on CUDA tensors the hand-written implicit-GEMM
kernel of ``csrc/conv_int8.cu`` (it has no Pallas parent: the JAX
package leaves this conv to XLA), on CPU tensors the plain version
``conv_int8_plain``. The op has a fake implementation for
``torch.export`` and no gradient: the int8 path is inference only. The
quantizers are plain PyTorch, as they are XLA in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import kernel_lib

_QMAX = 127.0
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class QuantizedTensor(NamedTuple):
    """An int8 tensor with its per-tensor dequantization scale (a float32
    scalar), written by a producer that quantized its own output (the
    ROIAlign of the static scheme)."""
    q: torch.Tensor      # int8
    scale: torch.Tensor  # float32, 0-dim


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-12) in float32."""
    amax = amax.float()
    return torch.clamp(amax / torch.full_like(amax, _QMAX), min=1e-12)


def max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar, from one min-max reduction in x's
    own dtype (exact: no rounding is involved)."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(-lo, hi).float()


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(f32(x) / scale), -127, 127) as int8; scale broadcasts.
    The float32 copy of x is divided, rounded and clipped in place."""
    xf = x.float()
    if xf is x:
        xf = x.clone()
    return xf.div_(scale).round_().clamp_(-_QMAX, _QMAX).to(torch.int8)


def quantize_per_tensor(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    scale = _scale_of(max_abs(x))
    return _quantize(x, scale), scale


def quantize_weight_per_channel(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW kernel:
    one scale per O over I, H and W. Returns (q [O, I, kh, kw] int8,
    scale [O] float32)."""
    scale = _scale_of(w.float().abs().amax(dim=(1, 2, 3)))
    return _quantize(w, scale[:, None, None, None]), scale


def quantize_per_tensor_static(x: torch.Tensor, amax: torch.Tensor):
    """Symmetric int8 quantization with a calibrated max-abs: no reduce
    over x; values beyond the calibrated range saturate. Returns
    (q, scale)."""
    scale = _scale_of(amax)
    return _quantize(x, scale), scale


def _out_hw(h: int, w: int, k: int, stride: int, pad: int):
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def _check_shapes(xq, wq, scale, shift, stride, pad) -> None:
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3]:
        raise ValueError(f"conv_int8: xq {tuple(xq.shape)} must be [N, H, "
                         f"W, C] and wq {tuple(wq.shape)} [O, kh, kw, C]")
    o = wq.shape[0]
    if tuple(scale.shape) != (o,) or tuple(shift.shape) != (o,):
        raise ValueError(f"conv_int8: scale {tuple(scale.shape)}, shift "
                         f"{tuple(shift.shape)}: expected [{o}]")
    if stride < 1 or pad < 0:
        raise ValueError(f"conv_int8: stride {stride}, pad {pad}")


def conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                  pad: int) -> torch.Tensor:
    """The exact int32 sum of int8 products: xq [N, H, W, C], wq [O, kh,
    kw, C] -> [N, OH, OW, O]. Computed as a float64 convolution, whose
    partial sums are integers below 2^53 (so exact in any order, and an
    algorithm that is not, as an FFT, errs by far less than 0.5), then
    rounded and cast."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 wq.permute(0, 3, 1, 2).double(), stride=stride,
                 padding=pad)
    return torch.round(y).permute(0, 2, 3, 1).to(torch.int32)


def conv_int8_plain(xq, wq, scale, shift, stride: int, pad: int,
                    relu: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int32 sum
    (``conv_int8_acc``), times ``scale[o]`` in float32, rounded once to
    shift's dtype, plus ``shift[o]`` in that dtype, then relu if asked.
    NHWC [N, OH, OW, O] in shift's dtype."""
    _check_shapes(xq, wq, scale, shift, stride, pad)
    y = conv_int8_acc(xq, wq, stride, pad).float() * scale.float()
    y = y.to(shift.dtype) + shift
    return F.relu(y) if relu else y


def piece_bytes(c: int, addresses: int) -> Optional[int]:
    """The bytes of the kernel's staged pieces for C channels and the OR
    of the operands' addresses: 16, 8 or 4, the largest that divides
    both (None: the kernel does not take them)."""
    for vec in (16, 8, 4):
        if c % vec == 0 and addresses % vec == 0:
            return vec
    return None


def _fn():
    fn = kernel_lib.load("conv_int8").conv_int8_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(xq, wq, scale, shift, stride: int, pad: int, relu: bool,
            fill: Optional[float] = None) -> torch.Tensor:
    """One launch of the kernel (no launch count). ``fill``: a value the
    output holds before the launch, so that a comparison sees what the
    kernel wrote."""
    kernel_lib.check_cuda_tensor(xq, "conv_int8 xq", {torch.int8})
    kernel_lib.check_cuda_tensor(wq, "conv_int8 wq", {torch.int8})
    kernel_lib.check_cuda_tensor(scale, "conv_int8 scale", {torch.float32})
    kernel_lib.check_cuda_tensor(shift, "conv_int8 shift", _OUT_DTYPES)
    _check_shapes(xq, wq, scale, shift, stride, pad)
    if len({t.device for t in (xq, wq, scale, shift)}) != 1:
        raise ValueError("conv_int8: tensors on several devices")
    n, h, w, c = xq.shape
    o, kh, kw, _ = wq.shape
    vec = piece_bytes(c, xq.data_ptr() | wq.data_ptr())
    if vec is None:
        raise ValueError(f"conv_int8: the kernel takes C a multiple of 4 "
                         f"and 4-byte aligned operands, got C {c}")
    oh, ow = _out_hw(h, w, kh, stride, pad)
    out = torch.empty((n, oh, ow, o), dtype=shift.dtype, device=xq.device)
    if fill is not None:
        out.fill_(fill)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xq.device):
        err = _fn()(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), out.data_ptr(), n, h, w, c, o, kh, kw,
                    stride, pad, oh, ow, int(relu), _OUT_DTYPES[shift.dtype],
                    vec, kernel_lib.stream_ptr(xq.device))
    kernel_lib.check_launch(err, "conv_int8")
    return out


def conv_int8_cuda(xq, wq, scale, shift, stride: int, pad: int,
                   relu: bool) -> torch.Tensor:
    """The kernel: xq a contiguous int8 CUDA tensor [N, H, W, C] with C a
    multiple of 4, wq int8 [O, kh, kw, C], scale float32 [O], shift
    [O] float32 or bfloat16 (the output's dtype)."""
    out = _launch(xq, wq, scale, shift, stride, pad, relu)
    if out.numel():
        kernel_lib.LAUNCHES["conv_int8"] += 1
    return out


@torch.library.custom_op("locov::conv_int8", mutates_args=(),
                         device_types="cpu")
def _conv_int8_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, stride: int, pad: int,
                  relu: bool) -> torch.Tensor:
    return conv_int8_plain(xq, wq, scale, shift, stride, pad, relu)


@_conv_int8_op.register_kernel("cuda")
def _(xq, wq, scale, shift, stride, pad, relu):
    return conv_int8_cuda(xq, wq, scale, shift, stride, pad, relu)


@_conv_int8_op.register_fake
def _(xq, wq, scale, shift, stride, pad, relu):
    _check_shapes(xq, wq, scale, shift, stride, pad)
    oh, ow = _out_hw(xq.shape[1], xq.shape[2], wq.shape[1], stride, pad)
    return shift.new_empty((xq.shape[0], oh, ow, wq.shape[0]))


def conv_int8(x, w: torch.Tensor, stride: int, pad: int,
              out_dtype: Optional[torch.dtype] = None,
              amax: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """NHWC x OIHW convolution in int8 with int32 sums
    (``locov::conv_int8``).

    ``x``: float [N, H, W, C], or a ``QuantizedTensor`` already written
    as int8 by its producer (then ``out_dtype`` is required and no
    quantize runs here); ``w``: float [O, C, kh, kw], FrozenBN folded.
    The output is float (``out_dtype`` or x's dtype), dequantized by the
    activation scale times the per-channel weight scales. With ``amax``
    (a calibrated scalar) the activation scale is static, else it is
    computed from x. ``shift`` [O] (in the output dtype) is added after
    the dequantize and ``relu`` applied after it, in the kernel's
    epilogue; without ``shift`` the output is the JAX function's."""
    if isinstance(x, QuantizedTensor):
        if out_dtype is None:
            raise ValueError("conv_int8: a QuantizedTensor needs out_dtype")
        xq, sx = x.q, x.scale
    elif amax is None:
        xq, sx = quantize_per_tensor(x)
    else:
        xq, sx = quantize_per_tensor_static(x, amax)
    out_dtype = out_dtype or x.dtype
    wq, sw = quantize_weight_per_channel(w)
    if shift is None:
        shift = torch.zeros(w.shape[0], dtype=out_dtype, device=w.device)
    return torch.ops.locov.conv_int8(
        xq.contiguous(), wq.permute(0, 2, 3, 1).contiguous(),
        (sx * sw).contiguous(), shift.to(out_dtype).contiguous(),
        int(stride), int(pad), bool(relu))
