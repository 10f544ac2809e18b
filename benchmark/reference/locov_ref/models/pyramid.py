"""ViTDet's simple feature pyramid and its 4conv1fc box head, the plain
reference's copies (Detectron2 ``SimpleFeaturePyramid``,
``LastLevelMaxPool`` and ``FastRCNNConvFCHead``), NHWC.

Each 2 x 2 / 2 transposed convolution is written as a per-pixel
``F.linear`` to 4 x C_out channels and a pixel shuffle, which is the
same arithmetic (each output pixel takes one input pixel), so that every
product is ``F.conv2d`` or ``F.linear``. LayerNorm over the channels
takes float32 statistics; products run in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .vit import LN_EPS, layer_norm, linear, level_names


def conv(x: torch.Tensor, weight: torch.Tensor, pad: int,
         dtype: torch.dtype) -> torch.Tensor:
    """NHWC convolution, stride 1, no bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), weight.to(dtype),
                 padding=pad)
    return y.permute(0, 2, 3, 1)


class ChannelLayerNorm(nn.LayerNorm):
    pass


class Conv2dNorm(nn.Conv2d):
    """conv (no bias) -> LayerNorm over the channels."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelLayerNorm(cout, eps=LN_EPS)

    def run(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return layer_norm(conv(x, self.weight, self.padding[0], dtype),
                          self.norm, dtype)


class ConvTranspose2x2(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def run(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, h, w, cin = x.shape
        cout = self.weight.shape[1]
        # out[2i + a, 2j + c, o] = sum_k x[i, j, k] W[k, o, a, c] + bias[o]
        wt = self.weight.permute(2, 3, 1, 0).reshape(4 * cout, cin)
        y = F.linear(x.to(dtype), wt.to(dtype)).view(b, h, w, 2, 2, cout)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)
        return y + self.bias.to(dtype)


class SimpleFeaturePyramid(nn.Module):
    """``net`` (the ViT), one branch ``simfp_<k>`` a scale factor, and the
    top level: the last one max-pooled at kernel 1, stride 2."""

    def __init__(self, net: nn.Module, dim: int, out: int,
                 scales: Sequence[float], patch: int, dtype: torch.dtype):
        super().__init__()
        self.net, self.dtype = net, dtype
        self.names = level_names(patch, scales)
        self.branches: List[str] = []
        self.seed_laws: Dict[str, tuple] = {}
        for scale, name in zip(scales, self.names):
            d = dim
            if scale == 4.0:
                layers = [ConvTranspose2x2(d, d // 2),
                          ChannelLayerNorm(d // 2, eps=LN_EPS), nn.GELU(),
                          ConvTranspose2x2(d // 2, d // 4)]
                d //= 4
            elif scale == 2.0:
                layers, d = [ConvTranspose2x2(d, d // 2)], d // 2
            elif scale == 1.0:
                layers = []
            else:
                layers = [nn.MaxPool2d(2, 2)]
            layers += [Conv2dNorm(d, out, 1), Conv2dNorm(out, out, 3)]
            branch = "simfp_" + name[1:]
            self.add_module(branch, nn.Sequential(*layers))
            self.branches.append(branch)
            for i, layer in enumerate(layers):
                if isinstance(layer, ConvTranspose2x2):
                    self.seed_laws[f"{branch}.{i}.weight"] = (
                        "trunc", (2.0 / layer.weight.shape[0]) ** 0.5)
                    self.seed_laws[f"{branch}.{i}.bias"] = ("const", 0.0)

    def levels(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, branch in zip(self.names, self.branches):
            y = x
            for layer in getattr(self, branch):
                if isinstance(layer, (ConvTranspose2x2, Conv2dNorm)):
                    y = layer.run(y, self.dtype)
                elif isinstance(layer, ChannelLayerNorm):
                    y = layer_norm(y, layer, self.dtype)
                elif isinstance(layer, nn.GELU):
                    y = F.gelu(y)
                else:
                    y = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(
                        0, 2, 3, 1)
            out[name] = y
        out[self.names[-1]] = F.max_pool2d(
            out[self.names[-2]].permute(0, 3, 1, 2), 1, 2).permute(0, 2, 3, 1)
        return out


class FastRCNNConvFCHead(nn.Module):
    def __init__(self, cin: int, pooled: int, num_conv: int, conv_dim: int,
                 num_fc: int, fc_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype, self.num_conv, self.num_fc = dtype, num_conv, num_fc
        for k in range(num_conv):
            self.add_module(f"conv{k + 1}", Conv2dNorm(cin, conv_dim, 3))
            cin = conv_dim
        d = cin * pooled * pooled
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(d, fc_dim))
            d = fc_dim
        self.out_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, P, P, C] -> [B, N, out_dim]: convs with LN and ReLU, the
        map flattened (C, H, W), fully connected layers with ReLU."""
        b, n, p, _, c = x.shape
        y = x.reshape(b * n, p, p, c)
        for k in range(self.num_conv):
            y = F.relu(getattr(self, f"conv{k + 1}").run(y, self.dtype))
        y = y.permute(0, 3, 1, 2).reshape(b, n, -1)
        for k in range(self.num_fc):
            y = F.relu(linear(y, getattr(self, f"fc{k + 1}"), self.dtype))
        return y
