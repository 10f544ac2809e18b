"""ViTDet's simple feature pyramid (Detectron2
``modeling/backbone/vit.py:SimpleFeaturePyramid``), NHWC.

From the trunk's one stride-16 map, one branch a scale factor: 4.0 (P2,
stride 4): a 2 x 2 / 2 transposed conv to dim / 2, channel LayerNorm,
GELU, a second 2 x 2 / 2 transposed conv to dim / 4; 2.0 (P3): one
transposed conv to dim / 2; 1.0 (P4): the map itself; 0.5 (P5): a 2 x 2
/ 2 max-pool. Each branch then takes a 1 x 1 conv to ``out_channels``
and a 3 x 3 conv, each without bias and followed by LayerNorm over the
channels (``Conv2dNorm``). The top level is the last one max-pooled at
kernel 1, stride 2 (``LastLevelMaxPool``: P6 from P5).

A 2 x 2 / 2 transposed conv touches each output pixel with one input
pixel, so it is computed exactly as a per-pixel product to 4 x C_out
channels and a pixel shuffle (``ConvTranspose2x2``). Products run in the
compute dtype, LayerNorm statistics in float32. Submodule names are
Detectron2's (``simfp_2.0``, ``simfp_2.4.norm``, ...).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import conv_nhwc
from .vit import LN_EPS, layer_norm


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of each pixel of an NHWC map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self, x.dtype)


class Conv2dNorm(nn.Conv2d):
    """A convolution followed by its ``norm`` (Detectron2's ``Conv2d``
    with ``norm=``), NHWC, in ``compute_dtype``; ReLU after with
    ``relu``."""

    def __init__(self, cin: int, cout: int, kernel: int,
                 compute_dtype: torch.dtype, relu: bool = False):
        super().__init__(cin, cout, kernel, padding=kernel // 2,
                         bias=False)
        self.compute_dtype, self.relu = compute_dtype, relu
        self.norm = ChannelLayerNorm(cout, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self.norm(conv_nhwc(x.to(dt), self.weight.to(dt), 1,
                                self.padding[0]))
        return F.relu(y) if self.relu else y


class ConvTranspose2x2(nn.ConvTranspose2d):
    """A 2 x 2 / 2 transposed conv (weight [C_in, C_out, 2, 2], bias),
    NHWC: out[2i + a, 2j + b] = x[i, j] . W[:, :, a, b] + bias."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__(cin, cout, 2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b, h, w, cin = x.shape
        cout = self.weight.shape[1]
        # [C_in, C_out, 2, 2] -> rows (a, b, C_out) of a [4 C_out, C_in]
        wt = self.weight.permute(2, 3, 1, 0).reshape(4 * cout, cin)
        y = F.linear(x.to(dt), wt.to(dt))
        y = y.view(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, 2 * h, 2 * w, cout) + self.bias.to(dt)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def level_sides(grid: int, scale_factors: Sequence[float]) -> List[int]:
    """The side of each level on a ``grid`` x ``grid`` trunk map: a
    scale's, then the top level's."""
    sides = [grid * int(s) if s >= 1 else grid // int(round(1 / s))
             for s in scale_factors]
    return sides + [-(-sides[-1] // 2)]


def level_names(patch_size: int, scale_factors: Sequence[float]
                ) -> List[str]:
    """``p<k>`` of each level, stride 2^k, the top level last."""
    ks = [int(math.log2(patch_size / s)) for s in scale_factors]
    return [f"p{k}" for k in ks + [ks[-1] + 1]]


class SimpleFeaturePyramid(nn.Module):
    """The trunk (``net``) and the pyramid built on its map; ``levels``
    maps the trunk's output to {``p<k>``: NHWC map}."""

    def __init__(self, net: nn.Module, in_dim: int, out_channels: int,
                 scale_factors: Sequence[float], patch_size: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.net, self.compute_dtype = net, compute_dtype
        self.names = level_names(patch_size, scale_factors)
        self.stages = []
        laws = {}
        for scale, name in zip(scale_factors, self.names):
            dt, dim = compute_dtype, in_dim
            if scale == 4.0:
                layers = [ConvTranspose2x2(dim, dim // 2, dt),
                          ChannelLayerNorm(dim // 2, eps=LN_EPS), nn.GELU(),
                          ConvTranspose2x2(dim // 2, dim // 4, dt)]
                dim //= 4
            elif scale == 2.0:
                layers = [ConvTranspose2x2(dim, dim // 2, dt)]
                dim //= 2
            elif scale == 1.0:
                layers = []
            elif scale == 0.5:
                layers = [nn.MaxPool2d(2, 2)]
            else:
                raise ValueError(f"SIMPLE_FPN.SCALE_FACTORS: {scale}")
            layers += [Conv2dNorm(dim, out_channels, 1, dt),
                       Conv2dNorm(out_channels, out_channels, 3, dt)]
            stage_name = f"simfp_{name[1:]}"
            self.add_module(stage_name, nn.Sequential(*layers))
            self.stages.append(stage_name)
            for i, layer in enumerate(layers):
                if isinstance(layer, ConvTranspose2x2):
                    # He-normal over the C_in inputs each output sums
                    std = (2.0 / layer.weight.shape[0]) ** 0.5
                    laws[f"{stage_name}.{i}.weight"] = ("trunc", std)
                    laws[f"{stage_name}.{i}.bias"] = ("const", 0.0)
        self.seed_laws = laws

    def levels(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The trunk's map [B, h, w, dim] -> {``p<k>``: [B, h_k, w_k,
        out_channels]} in the compute dtype, finest first."""
        out = {}
        for name, stage_name in zip(self.names, self.stages):
            y = x
            for layer in getattr(self, stage_name):
                y = _max_pool_2x2(y) if isinstance(layer, nn.MaxPool2d) \
                    else layer(y)
            out[name] = y
        out[self.names[-1]] = out[self.names[-2]][:, ::2, ::2]
        return out
