"""ResNet-50 C4 backbone, NHWC at the interfaces.

Counterpart of ``locov_tpu/models/resnet.py``: Caffe conventions
(``stride_in_1x1`` bottlenecks, FrozenBatchNorm folded into the conv),
and ``BACKBONE.FREEZE_AT`` as the JAX package applies it (a gradient
stop after each frozen stage). Submodules carry the Flax scope names
(``conv1`` and ``conv1_norm`` side by side, stages ``res2`` ... with
blocks ``0``, ``1``, ...), so ``utils/weights.py:from_flax`` maps
parameters by name.
Tensors are NHWC; a conv runs on ``x.permute(0, 3, 1, 2)``, which for a
contiguous NHWC tensor is a free view in ``torch.channels_last``.

The int8 serving mode (``TPU.INT8_EVAL``) runs through the blocks'
``int8`` argument, inference only: "dynamic", "calibrate" or "static"
(the JAX package's ``_conv_frozen_bn`` modes) quantize every conv of
res2 .. res5 (``ops/int8_conv.py``); the stem stays float. "dynamic_idle"
is the dynamic scheme's padding pass on a rank whose shard is done: it
joins every all-reduce of a max-abs with 0. A model built
for the static scheme (``int8_amax``) holds each such conv's calibrated
activation max-abs in a child ``<conv>_amax`` with a buffer ``amax``
(JAX's ``quant/.../<conv>_amax/amax``), zero until calibrated.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv import conv2d
from ..ops.int8_conv import QuantizedTensor, conv_int8, global_max_abs
from ..ops.relu_maxpool import relu_maxpool

# stage name -> (num_blocks, stride of the first block)
R50_STAGES = {"res2": (3, 1), "res3": (4, 2), "res4": (6, 2),
              "res5": (3, 2)}
R101_STAGES = {"res2": (3, 1), "res3": (4, 2), "res4": (23, 2),
               "res5": (3, 2)}
STAGE_CHANNELS = {"res2": (64, 256), "res3": (128, 512),
                  "res4": (256, 1024), "res5": (512, 2048)}
STAGE_STRIDES = {"stem": 4, "res2": 4, "res3": 8, "res4": 16, "res5": 32}


class FrozenBatchNorm(nn.Module):
    """d2 FrozenBatchNorm2d: four frozen buffers, never trained."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def scale_shift(self):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """2-D convolution of an NHWC tensor with an OIHW kernel -> NHWC, in
    full float32 when x is float32 (``ops/conv.py``)."""
    y = conv2d(x.permute(0, 3, 1, 2),
                 weight.contiguous(memory_format=torch.channels_last),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def record_amax_(amax: torch.Tensor, x: torch.Tensor) -> None:
    """amax = max(amax, max|x|) in place (the buffer stays the one tensor
    that exports and checkpoints see). Under ``torch.distributed`` with
    several ranks, max|x| is taken over every rank's x
    (``global_max_abs``: one all-reduce), as JAX's calibration takes it
    over the global batch, so that every rank quantizes the next layer
    with the same scale."""
    amax.copy_(torch.maximum(amax, global_max_abs(x)))


class ActAmax(nn.Module):
    """The calibrated activation max-abs of one conv for the static int8
    scheme (JAX's ``_ActAmax``): a float32 scalar buffer ``amax``, zero
    until calibrated, carried in the ``state_dict``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("amax", torch.zeros(()))


def _conv_frozen_bn(x, conv: nn.Conv2d, norm: FrozenBatchNorm,
                    dtype: torch.dtype, relu: bool = True, int8=False,
                    amax: ActAmax = None, residual=None, out_amax=None,
                    float_out: bool = True):
    """conv + FrozenBN + (relu) with the BN scale folded into the kernel
    in f32, cast once to the compute dtype, then the shift added:
    ``conv(x, w) * s + t == conv(x, w * s) + t``.

    With ``int8`` the folded f32 kernel is quantized per output channel
    and the conv runs in int8 (``ops/int8_conv.py``), the shift,
    ``residual`` (added before the relu) and relu in its epilogue: x a
    ``QuantizedTensor`` is taken as it is; else x is cast to the compute
    dtype and quantized on the fly ("dynamic"), by ``amax`` ("static"),
    or by ``amax`` after it recorded max|x| ("calibrate"); "dynamic_idle"
    is "dynamic" whose max-abs contributes 0 to the all-reduce. With
    ``out_amax`` the epilogue also writes the output quantized by it
    (the next conv's calibrated max-abs): the return is then (the float
    output, or None unless ``float_out``; a ``QuantizedTensor``)."""
    scale, shift = norm.scale_shift()
    wk = conv.weight * scale[:, None, None, None]
    stride, pad = conv.stride[0], conv.padding[0]
    if int8:
        fused = dict(shift=shift, relu=relu, residual=residual,
                     out_amax=out_amax, float_out=float_out)
        if isinstance(x, QuantizedTensor):
            return conv_int8(x, wk, stride, pad, out_dtype=dtype, **fused)
        a = None
        if int8 in ("static", "calibrate"):
            if amax is None:
                raise ValueError(f"int8 mode {int8!r} needs a model built "
                                 f"for the static scheme (TPU.INT8_SCHEME "
                                 f"static)")
            if int8 == "calibrate":
                record_amax_(amax.amax, x)
            a = amax.amax
        return conv_int8(x.to(dtype), wk, stride, pad, out_dtype=dtype,
                         amax=a, contributes=int8 != "dynamic_idle",
                         **fused)
    out = conv_nhwc(x.to(dtype), wk.to(dtype), stride, pad)
    out = out + shift.to(out.dtype)
    return F.relu(out) if relu else out


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


class BottleneckBlock(nn.Module):
    """Caffe-style bottleneck: 1x1 (stride here when stride_in_1x1) ->
    3x3 -> 1x1, FrozenBN after each, residual add, relu."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 stride_in_1x1: bool = True, has_shortcut: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 int8_amax: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, s1)
        self.conv1_norm = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3)
        self.conv2_norm = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)
        self.conv3_norm = FrozenBatchNorm(out_channels)
        if has_shortcut:
            self.shortcut = _conv(in_channels, out_channels, 1, stride)
            self.shortcut_norm = FrozenBatchNorm(out_channels)
        else:
            self.shortcut = None
        if int8_amax:
            for name in ("conv1", "conv2", "conv3") + \
                    (("shortcut",) if has_shortcut else ()):
                self.add_module(name + "_amax", ActAmax())

    def _conv_bn(self, x, name: str, int8, relu: bool = True, **fused):
        return _conv_frozen_bn(x, getattr(self, name),
                               getattr(self, name + "_norm"),
                               self.compute_dtype, relu, int8,
                               getattr(self, name + "_amax", None), **fused)

    def forward(self, x, int8=False) -> torch.Tensor:
        """The block. In an int8 mode each conv quantizes its own input,
        and conv3 takes the shortcut as its epilogue's residual,
        ``relu(conv3 + sc)`` in the compute dtype as the float block
        computes it (so the shortcut runs first). Under "static" this is
        the unfused chain, which ``ResNetStage`` replaces by
        ``forward_static`` (the same bits)."""
        out = self._conv_bn(x, "conv1", int8)
        out = self._conv_bn(out, "conv2", int8)
        if self.shortcut is not None:
            sc = self._conv_bn(x, "shortcut", int8, relu=False)
        else:
            sc = x
        if int8:
            return self._conv_bn(out, "conv3", int8, residual=sc)
        out = self._conv_bn(out, "conv3", int8, relu=False)
        return F.relu(out + sc)

    def forward_static(self, x, xq=None, next_amax=None):
        """The block under the static int8 scheme, each quantize fused into
        the epilogue of the conv that produces its input: conv1 and conv2
        write only int8 (by conv2's and conv3's calibrated max-abs), conv3
        adds the shortcut and writes the block's output in the compute
        dtype and, with ``next_amax`` (the next block's conv1 max-abs),
        its int8 copy too. ``xq``: this block's conv1 input as int8,
        written so by the block before (else x is quantized by conv1's
        max-abs, or taken as it is where it is a ``QuantizedTensor``); a
        shortcut conv quantizes x itself. The same bits as the unfused
        scheme. Returns (the output, its int8 copy or None)."""
        if not hasattr(self, "conv1_amax"):
            raise ValueError("int8 mode 'static' needs a model built for "
                             "the static scheme (TPU.INT8_SCHEME static)")
        _, q1 = self._conv_bn(x if xq is None else xq, "conv1", "static",
                              out_amax=self.conv2_amax.amax,
                              float_out=False)
        _, q2 = self._conv_bn(q1, "conv2", "static",
                              out_amax=self.conv3_amax.amax,
                              float_out=False)
        if self.shortcut is not None:
            sc = self._conv_bn(x, "shortcut", "static", relu=False)
        else:
            sc = x
        if next_amax is None:
            return self._conv_bn(q2, "conv3", "static", residual=sc), None
        return self._conv_bn(q2, "conv3", "static", residual=sc,
                             out_amax=next_amax)


class ResNetStage(nn.Sequential):
    """A sequence of bottleneck blocks named ``0``, ``1``, ...
    (d2 ResNet.make_stage). ``fuse_static`` (default True; see
    ``unfuse_static_``): whether the static int8 scheme's quantizes run
    in the epilogues of the convs that produce their inputs."""

    fuse_static = True

    def __init__(self, num_blocks: int, in_channels: int,
                 bottleneck_channels: int, out_channels: int,
                 first_stride: int = 2, stride_in_1x1: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 int8_amax: bool = False):
        super().__init__(*[
            BottleneckBlock(in_channels if i == 0 else out_channels,
                            bottleneck_channels, out_channels,
                            stride=first_stride if i == 0 else 1,
                            stride_in_1x1=stride_in_1x1,
                            has_shortcut=(i == 0),
                            compute_dtype=compute_dtype,
                            int8_amax=int8_amax)
            for i in range(num_blocks)])

    def forward(self, x, int8=False):
        """The blocks in order. Under the static int8 scheme (with
        ``fuse_static``) a block's conv3 also writes the next block's
        conv1 input in int8 where that block is an identity block
        (``BottleneckBlock.forward_static``)."""
        if int8 != "static" or not self.fuse_static:
            for block in self:
                x = block(x, int8=int8)
            return x
        xq = None
        for i, block in enumerate(self):
            nxt = self[i + 1] if i + 1 < len(self) else None
            next_amax = None if nxt is None or nxt.shortcut is not None \
                else nxt.conv1_amax.amax
            x, xq = block.forward_static(x, xq, next_amax)
        return x


def unfuse_static_(module: nn.Module) -> nn.Module:
    """Has every ``ResNetStage`` in ``module`` run the static int8 scheme
    unfused: each conv quantizes its own input by its calibrated max-abs
    (``BottleneckBlock.forward``), with no quantize in an epilogue. The
    same bits as the fused form, with several times its quantize passes:
    the reference that the fusion is held to and timed against. Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, ResNetStage):
            m.fuse_static = False
    return module


class ResNetStem(nn.Module):
    """7x7/2 conv + FrozenBN, then relu + 3x3/2 max-pool, which is the
    hand-written kernel pair on CUDA (``ops/relu_maxpool.py``, forward
    and backward) for every dtype and shape, and its plain version on
    the CPU."""

    def __init__(self, out_channels: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(3, out_channels, 7, 2)
        self.conv1_norm = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_frozen_bn(x, self.conv1, self.conv1_norm,
                            self.compute_dtype, relu=False)
        return relu_maxpool(x.contiguous())


class ResNetC4(nn.Module):
    """Stem + res2..res4 (the C4 trunk; res5 lives in the ROI heads).
    ``forward`` takes NHWC images and returns a dict of the requested
    ``out_features``.

    ``freeze_at`` (d2 ``BACKBONE.FREEZE_AT``): 1 freezes the stem, i >= 2
    also res2 .. res{i}. Their parameters get ``requires_grad=False`` and
    their outputs are detached, so no activation of a frozen stage is
    kept for a backward and no gradient flows into it (the JAX package's
    ``stop_gradient`` at the same places).

    ``remat`` (``TPU.REMAT_BACKBONE``): while gradients are recorded,
    each stage after the stem that trains runs under
    ``torch.utils.checkpoint``, so that its activations are recomputed
    in the backward instead of kept (JAX's ``nn.remat(ResNetStage)``).
    The stem stays outside, so its ReLU + max-pool kernel runs once.

    ``forward(x, int8=...)`` runs res2 .. res4 in an int8 mode (the stem
    float, remat bypassed: int8 is inference only); ``int8_amax`` builds
    the static scheme's ``<conv>_amax`` buffers."""

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res4",),
                 num_groups: int = 1, width_per_group: int = 64,
                 stem_out_channels: int = 64,
                 res2_out_channels: int = 256,
                 stride_in_1x1: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 freeze_at: int = 0, remat: bool = False,
                 int8_amax: bool = False):
        super().__init__()
        self.out_features = tuple(out_features)
        self.compute_dtype = compute_dtype
        self.freeze_at = freeze_at
        self.remat = remat
        self.stem = ResNetStem(stem_out_channels, compute_dtype)
        stages = R50_STAGES if depth == 50 else R101_STAGES
        last = max((s for s in self.out_features if s != "stem"),
                   key=lambda s: STAGE_STRIDES[s])
        self.stage_names = []
        cin = stem_out_channels
        for stage in ["res2", "res3", "res4", "res5"]:
            nblocks, stride = stages[stage]
            bc, oc = STAGE_CHANNELS[stage]
            bc = bc * num_groups * width_per_group // 64
            oc = oc * res2_out_channels // 256
            self.add_module(stage, ResNetStage(
                nblocks, cin, bc, oc, first_stride=stride,
                stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype,
                int8_amax=int8_amax))
            self.stage_names.append(stage)
            cin = oc
            if stage == last:
                break
        for name in ["stem"] + self.stage_names:
            if self._frozen(name):
                getattr(self, name).requires_grad_(False)

    def _frozen(self, name: str) -> bool:
        return self.freeze_at >= (1 if name == "stem" else int(name[3]))

    def forward(self, x: torch.Tensor,
                int8=False) -> Dict[str, torch.Tensor]:
        outputs = {}
        x = x.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled() and not int8
        for name in ["stem"] + self.stage_names:
            stage = getattr(self, name)
            if remat and name != "stem" and not self._frozen(name):
                x = checkpoint(stage, x, use_reentrant=False)
            elif name == "stem" or not int8:
                x = stage(x)
            else:
                x = stage(x, int8=int8)
            if self._frozen(name):
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_res5_stage(cfg, compute_dtype=torch.float32) -> ResNetStage:
    """The standalone res5 block used as the C4 box head
    (d2 ``_build_res5_block``)."""
    r = cfg.MODEL.RESNETS
    return ResNetStage(
        num_blocks=3, in_channels=r.RES2_OUT_CHANNELS * 4,
        bottleneck_channels=r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8,
        out_channels=r.RES2_OUT_CHANNELS * 8, first_stride=2,
        stride_in_1x1=r.STRIDE_IN_1X1, compute_dtype=compute_dtype)
