"""The box head of ViTDet (Detectron2 ``modeling/roi_heads/box_head.py:
FastRCNNConvFCHead`` at ``conv_dims=[256] * 4, fc_dims=[1024]``, LN) and
the level each box is pooled from (``modeling/poolers.py:
assign_boxes_to_levels``).

Four 3 x 3 convs at 256 without bias, each with LayerNorm over the
channels and ReLU, on each box's pooled [7, 7, 256] map, then the map
flattened channel-major (C, H, W, as Detectron2 flattens NCHW) and a
fully connected layer to 1024 with ReLU. Products run in the compute
dtype, LayerNorm statistics in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .pyramid import Conv2dNorm
from .vit import linear


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int,
                           max_level: int, canonical_box_size: int = 224,
                           canonical_level: int = 4) -> torch.Tensor:
    """boxes [..., 4] -> each box's level index (0 for ``min_level``):
    floor(canonical_level + log2(sqrt(area) / canonical_box_size + 1e-8))
    clamped to [min_level, max_level], less min_level, int32."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area) / canonical_box_size + 1e-8))
    return (lvl.clamp(min_level, max_level) - min_level).to(torch.int32)


class FastRCNNConvFCHead(nn.Module):
    """``conv1`` .. ``conv<num_conv>`` then ``fc1`` .. ``fc<num_fc>``."""

    def __init__(self, in_channels: int, pooled: int, num_conv: int,
                 conv_dim: int, num_fc: int, fc_dim: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_conv, self.num_fc = num_conv, num_fc
        c = in_channels
        for k in range(num_conv):
            self.add_module(f"conv{k + 1}", Conv2dNorm(
                c, conv_dim, 3, compute_dtype, relu=True))
            c = conv_dim
        d = c * pooled * pooled
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(d, fc_dim))
            d = fc_dim
        self.out_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, P, P, C] -> [B, N, out_dim] in the compute dtype."""
        b, n, p, _, c = x.shape
        y = x.reshape(b * n, p, p, c)
        for k in range(self.num_conv):
            y = getattr(self, f"conv{k + 1}")(y)
        y = y.permute(0, 3, 1, 2).reshape(b, n, -1)
        for k in range(self.num_fc):
            y = F.relu(linear(y, getattr(self, f"fc{k + 1}"),
                              self.compute_dtype))
        return y
