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

The dynamic max-abs is global: where ``torch.distributed`` runs several
ranks, each over its share of the batch, ``global_max_abs`` all-reduces
it by MAX, as JAX's one GSPMD step over the sharded batch takes it over
the whole batch.

The product and its epilogue are the ``torch.library`` custom op
``locov::conv_int8``: a float output, and optionally an int8 copy of it
quantized by a calibrated max-abs; the epilogue optionally adds a
residual before the relu (a bottleneck's conv3 with its shortcut). On
CUDA tensors it is the hand-written ``wgmma`` kernel of
``csrc/conv_int8.cu`` (no Pallas parent: the JAX package leaves this
conv to XLA), on CPU tensors the plain version. The kernel takes C a
multiple of 16 and 16-byte aligned operands: ``kernel_operands`` pads
narrower C with zero channels (the tiny models' 8 and 12), which leave
the int32 sums exact, and copies a misaligned operand. The op has a
fake implementation for ``torch.export`` and no gradient: the int8 path
is inference only. The quantizers are plain PyTorch, as they are XLA in
the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import kernel_lib

_QMAX = 127.0
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class QuantizedTensor(NamedTuple):
    """An int8 tensor with its per-tensor dequantization scale (a float32
    scalar), written by a producer that quantized its own output (the
    ROIAlign of the static scheme, a conv's int8 epilogue)."""
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


def global_max_abs(x: torch.Tensor, contributes: bool = True
                   ) -> torch.Tensor:
    """max |x| over every rank's x: ``max_abs``, all-reduced by MAX where
    ``torch.distributed`` runs several ranks (each rank then quantizes
    with the scale of the whole batch, as JAX's step over the global
    batch does). Every dynamic quantize and every calibration record
    goes through here. ``contributes`` False: this rank joins the
    all-reduce with 0 (a padding pass of a rank whose shard is done;
    every max-abs is at least 0, so it moves no other rank's)."""
    cur = max_abs(x)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        if not contributes:
            cur = torch.zeros_like(cur)
        dist.all_reduce(cur, op=dist.ReduceOp.MAX)
    return cur


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(f32(x) / scale), -127, 127) as int8; scale broadcasts.
    The float32 copy of x is divided, rounded and clipped in place."""
    xf = x.float()
    if xf is x:
        xf = x.clone()
    return xf.div_(scale).round_().clamp_(-_QMAX, _QMAX).to(torch.int8)


def quantize_per_tensor(x: torch.Tensor, contributes: bool = True):
    """Symmetric per-tensor int8 quantization with the global max-abs
    (``global_max_abs``, with ``contributes``). Returns (q, scale)."""
    scale = _scale_of(global_max_abs(x, contributes))
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


def _out_shape(xq, wq, stride: int, pad: int):
    return (xq.shape[0],) + _out_hw(xq.shape[1], xq.shape[2], wq.shape[1],
                                    stride, pad) + (wq.shape[0],)


def _check_shapes(xq, wq, scale, shift, stride, pad, residual=None,
                  amax=None, float_out: bool = True) -> None:
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3]:
        raise ValueError(f"conv_int8: xq {tuple(xq.shape)} must be [N, H, "
                         f"W, C] and wq {tuple(wq.shape)} [O, kh, kw, C]")
    o = wq.shape[0]
    if tuple(scale.shape) != (o,) or tuple(shift.shape) != (o,):
        raise ValueError(f"conv_int8: scale {tuple(scale.shape)}, shift "
                         f"{tuple(shift.shape)}: expected [{o}]")
    if stride < 1 or pad < 0:
        raise ValueError(f"conv_int8: stride {stride}, pad {pad}")
    if residual is not None:
        want = _out_shape(xq, wq, stride, pad)
        if tuple(residual.shape) != want or residual.dtype != shift.dtype:
            raise ValueError(f"conv_int8: residual {tuple(residual.shape)} "
                             f"{residual.dtype}: expected {want} "
                             f"{shift.dtype}")
    if amax is not None and amax.dim() != 0:
        raise ValueError(f"conv_int8: amax must be a 0-dim tensor, got "
                         f"{tuple(amax.shape)}")
    if amax is None and not float_out:
        raise ValueError("conv_int8: no output asked for (float_out False "
                         "and no amax)")


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
                    relu: bool, residual: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The kernel's float output in plain PyTorch: the int32 sum
    (``conv_int8_acc``), times ``scale[o]`` in float32, rounded once to
    shift's dtype, plus ``shift[o]`` in that dtype, plus ``residual``
    (same shape and dtype as the output) where given, then relu if
    asked. NHWC [N, OH, OW, O] in shift's dtype."""
    _check_shapes(xq, wq, scale, shift, stride, pad, residual)
    y = conv_int8_acc(xq, wq, stride, pad).float() * scale.float()
    y = y.to(shift.dtype) + shift
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def conv_int8_op_plain(xq, wq, scale, shift, stride: int, pad: int,
                       relu: bool, residual: Optional[torch.Tensor] = None,
                       amax: Optional[torch.Tensor] = None,
                       float_out: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op ``locov::conv_int8`` in plain PyTorch: ``conv_int8_plain``,
    and where ``amax`` is given its output quantized by it
    (``quantize_per_tensor_static``). Returns (the float output, or an
    empty tensor of its dtype unless ``float_out``; the int8 output, or
    an empty int8 tensor without ``amax``)."""
    _check_shapes(xq, wq, scale, shift, stride, pad, residual, amax,
                  float_out)
    y = conv_int8_plain(xq, wq, scale, shift, stride, pad, relu, residual)
    q = xq.new_empty((0,)) if amax is None else \
        quantize_per_tensor_static(y, amax)[0]
    return (y if float_out else y.new_empty((0,))), q


def kernel_operands(xq, wq, residual=None):
    """xq, wq and the residual as the kernel takes them: C padded with
    zero channels to a multiple of 16 (zeros add nothing to an int32
    sum, so the output is the same), and any operand whose address is
    not 16-byte aligned copied (a fresh allocation is). Returns (xq, wq,
    residual)."""
    c = xq.shape[3]
    if c % 16:
        xq = F.pad(xq, (0, 16 - c % 16))
        wq = F.pad(wq, (0, 16 - c % 16))

    def aligned(t):
        return t if t is None or t.data_ptr() % 16 == 0 else t.clone()
    return aligned(xq), aligned(wq), aligned(residual)


def _launch(xq, wq, scale, shift, stride: int, pad: int, relu: bool,
            residual: Optional[torch.Tensor] = None,
            amax: Optional[torch.Tensor] = None, float_out: bool = True,
            fill: Optional[float] = None):
    """One launch of the kernel (no launch count), on the operands
    ``kernel_operands`` makes of these. Returns (the float output or
    None, the int8 output or None: it is written where ``amax`` is
    given). ``fill``: a value the float output holds before the launch
    (the int8 one then holds -128, which the kernel never writes), so
    that a comparison sees what the kernel wrote."""
    kernel_lib.check_cuda_tensor(xq, "conv_int8 xq", {torch.int8})
    kernel_lib.check_cuda_tensor(wq, "conv_int8 wq", {torch.int8})
    kernel_lib.check_cuda_tensor(scale, "conv_int8 scale", {torch.float32})
    kernel_lib.check_cuda_tensor(shift, "conv_int8 shift", _OUT_DTYPES)
    tensors = [xq, wq, scale, shift]
    if residual is not None:
        kernel_lib.check_cuda_tensor(residual, "conv_int8 residual",
                                     _OUT_DTYPES)
        tensors.append(residual)
    if amax is not None:
        kernel_lib.check_cuda_tensor(amax, "conv_int8 amax",
                                     {torch.float32})
        tensors.append(amax)
    _check_shapes(xq, wq, scale, shift, stride, pad, residual, amax,
                  float_out)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("conv_int8: tensors on several devices")
    shape = _out_shape(xq, wq, stride, pad)
    out = q = None
    if float_out:
        out = torch.empty(shape, dtype=shift.dtype, device=xq.device)
    if amax is not None:
        q = torch.empty(shape, dtype=torch.int8, device=xq.device)
    if fill is not None:
        if out is not None:
            out.fill_(fill)
        if q is not None:
            q.fill_(-128)
    if 0 in shape:
        return out, q
    xq, wq, residual = kernel_operands(xq, wq, residual)
    n, h, w, c = xq.shape
    o, kh, kw, _ = wq.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    kernel_lib.launch(
        "conv_int8_fwd", xq.device, xq.data_ptr(), wq.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), ptr(residual), ptr(out), ptr(q),
        ptr(amax), n, h, w, c, o, kh, kw, stride, pad, shape[1], shape[2],
        int(relu), _OUT_DTYPES[shift.dtype])
    return out, q


def conv_int8_cuda(xq, wq, scale, shift, stride: int, pad: int,
                   relu: bool, residual: Optional[torch.Tensor] = None,
                   amax: Optional[torch.Tensor] = None,
                   float_out: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op on CUDA tensors: xq a contiguous int8 CUDA tensor [N, H, W,
    C], wq int8 [O, kh, kw, C], scale float32 [O], shift [O] float32 or
    bfloat16 (the output's dtype), residual None or the output's shape
    and dtype, amax None or a 0-dim float32 CUDA tensor (read on the
    card: no host read). One launch, counted under
    ``LAUNCHES["conv_int8"]``. Returns what ``conv_int8_op_plain``
    returns."""
    out, q = _launch(xq, wq, scale, shift, stride, pad, relu, residual,
                     amax, float_out)
    if out is not None and out.numel() or q is not None and q.numel():
        kernel_lib.LAUNCHES["conv_int8"] += 1
    return (out if float_out else shift.new_empty((0,))), \
        (xq.new_empty((0,)) if q is None else q)


@torch.library.custom_op("locov::conv_int8", mutates_args=(),
                         device_types="cpu")
def _conv_int8_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, stride: int, pad: int, relu: bool,
                  residual: Optional[torch.Tensor] = None,
                  amax: Optional[torch.Tensor] = None,
                  float_out: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return conv_int8_op_plain(xq, wq, scale, shift, stride, pad, relu,
                              residual, amax, float_out)


@_conv_int8_op.register_kernel("cuda")
def _(xq, wq, scale, shift, stride, pad, relu, residual=None, amax=None,
      float_out=True):
    return conv_int8_cuda(xq, wq, scale, shift, stride, pad, relu,
                          residual, amax, float_out)


@_conv_int8_op.register_fake
def _(xq, wq, scale, shift, stride, pad, relu, residual=None, amax=None,
      float_out=True):
    _check_shapes(xq, wq, scale, shift, stride, pad, residual, amax,
                  float_out)
    shape = _out_shape(xq, wq, stride, pad)
    return (shift.new_empty(shape if float_out else (0,)),
            xq.new_empty(shape if amax is not None else (0,)))


def conv_int8(x, w: torch.Tensor, stride: int, pad: int,
              out_dtype: Optional[torch.dtype] = None,
              amax: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              relu: bool = False,
              residual: Optional[torch.Tensor] = None,
              out_amax: Optional[torch.Tensor] = None,
              float_out: bool = True, contributes: bool = True):
    """NHWC x OIHW convolution in int8 with int32 sums
    (``locov::conv_int8``).

    ``x``: float [N, H, W, C], or a ``QuantizedTensor`` already written
    as int8 by its producer (then ``out_dtype`` is required and no
    quantize runs here); ``w``: float [O, C, kh, kw], FrozenBN folded.
    The output is float (``out_dtype`` or x's dtype), dequantized by the
    activation scale times the per-channel weight scales. With ``amax``
    (a calibrated scalar) the activation scale is static, else it is
    computed from x (``quantize_per_tensor``, with ``contributes``).
    ``shift`` [O] (in the output dtype) is added after the dequantize,
    then ``residual`` (the output's shape and dtype), then ``relu``, in
    the kernel's epilogue; without ``shift`` the output is the JAX
    function's.

    With ``out_amax`` (a calibrated scalar tensor) the epilogue also
    quantizes the output by it, as ``quantize_per_tensor_static`` would:
    the return is then (the float output, or None unless ``float_out``;
    a ``QuantizedTensor`` of the int8 output and its scale)."""
    if isinstance(x, QuantizedTensor):
        if out_dtype is None:
            raise ValueError("conv_int8: a QuantizedTensor needs out_dtype")
        xq, sx = x.q, x.scale
    elif amax is None:
        xq, sx = quantize_per_tensor(x, contributes)
    else:
        xq, sx = quantize_per_tensor_static(x, amax)
    out_dtype = out_dtype or x.dtype
    wq, sw = quantize_weight_per_channel(w)
    if shift is None:
        shift = torch.zeros(w.shape[0], dtype=out_dtype, device=w.device)
    if out_amax is None:
        float_out = True
    else:
        out_amax = out_amax.float()
    out, q = torch.ops.locov.conv_int8(
        xq.contiguous(), wq.permute(0, 2, 3, 1).contiguous(),
        (sx * sw).contiguous(), shift.to(out_dtype).contiguous(),
        int(stride), int(pad), bool(relu),
        None if residual is None else residual.contiguous(), out_amax,
        bool(float_out))
    if out_amax is None:
        return out
    return (out if float_out else None), \
        QuantizedTensor(q, _scale_of(out_amax))
