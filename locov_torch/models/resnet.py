"""ResNet-50 C4 backbone, NHWC at the interfaces.

Counterpart of ``locov_tpu/models/resnet.py`` (inference path): Caffe
conventions (``stride_in_1x1`` bottlenecks, FrozenBatchNorm folded into
the conv). Submodules carry the Flax scope names (``conv1`` and
``conv1_norm`` side by side, stages ``res2`` ... with blocks ``0``,
``1``, ...), so ``utils/weights.py:from_flax`` maps parameters by name.
Tensors are NHWC; a conv runs on ``x.permute(0, 3, 1, 2)``, which for a
contiguous NHWC tensor is a free view in ``torch.channels_last``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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
    """2-D convolution of an NHWC tensor with an OIHW kernel -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 weight.contiguous(memory_format=torch.channels_last),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv_frozen_bn(x: torch.Tensor, conv: nn.Conv2d,
                    norm: FrozenBatchNorm, dtype: torch.dtype,
                    relu: bool = True) -> torch.Tensor:
    """conv + FrozenBN + (relu) with the BN scale folded into the kernel
    in f32, cast once to the compute dtype, then the shift added:
    ``conv(x, w) * s + t == conv(x, w * s) + t``."""
    scale, shift = norm.scale_shift()
    wk = (conv.weight * scale[:, None, None, None]).to(dtype)
    out = conv_nhwc(x.to(dtype), wk, conv.stride[0], conv.padding[0])
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
                 compute_dtype: torch.dtype = torch.float32):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = _conv_frozen_bn(x, self.conv1, self.conv1_norm, dt)
        out = _conv_frozen_bn(out, self.conv2, self.conv2_norm, dt)
        out = _conv_frozen_bn(out, self.conv3, self.conv3_norm, dt,
                              relu=False)
        if self.shortcut is not None:
            sc = _conv_frozen_bn(x, self.shortcut, self.shortcut_norm, dt,
                                 relu=False)
        else:
            sc = x
        return F.relu(out + sc)


class ResNetStage(nn.Sequential):
    """A sequence of bottleneck blocks named ``0``, ``1``, ...
    (d2 ResNet.make_stage)."""

    def __init__(self, num_blocks: int, in_channels: int,
                 bottleneck_channels: int, out_channels: int,
                 first_stride: int = 2, stride_in_1x1: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(*[
            BottleneckBlock(in_channels if i == 0 else out_channels,
                            bottleneck_channels, out_channels,
                            stride=first_stride if i == 0 else 1,
                            stride_in_1x1=stride_in_1x1,
                            has_shortcut=(i == 0),
                            compute_dtype=compute_dtype)
            for i in range(num_blocks)])


class ResNetStem(nn.Module):
    """7x7/2 conv + FrozenBN, then relu + 3x3/2 max-pool, which is the
    hand-written kernel on CUDA (``ops/relu_maxpool.py``) for every
    dtype and shape, and its plain version on the CPU."""

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
    ``out_features``."""

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res4",),
                 num_groups: int = 1, width_per_group: int = 64,
                 stem_out_channels: int = 64,
                 res2_out_channels: int = 256,
                 stride_in_1x1: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        self.compute_dtype = compute_dtype
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
                stride_in_1x1=stride_in_1x1, compute_dtype=compute_dtype))
            self.stage_names.append(stage)
            cin = oc
            if stage == last:
                break

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x.to(self.compute_dtype))
        outputs = {}
        if "stem" in self.out_features:
            outputs["stem"] = x
        for stage in self.stage_names:
            x = getattr(self, stage)(x)
            if stage in self.out_features:
                outputs[stage] = x
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
