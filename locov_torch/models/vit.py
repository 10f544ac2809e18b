"""The plain ViT trunk of ViTDet (Li, Mao, Girshick, He, arXiv 2203.16527;
Detectron2 ``modeling/backbone/vit.py``), at test time.

A 16 x 16 / 16 patch embedding, the absolute position table resized
bicubically to the patch grid (its cls row dropped), then blocks of
pre-norm attention and MLP. The blocks listed as windowed attend inside
windows of ``window_size`` x ``window_size`` tokens (the grid zero-padded
up to a multiple of the window, padded tokens attending and attended, as
in Detectron2); the others attend over the whole grid. Every score
carries the decomposed relative-position bias (``add_decomposed_rel_pos``)

    s_ij = (q_i . k_j) / sqrt(hd) + q_i . Rh[i_h - j_h + K - 1]
                                  + q_i . Rw[i_w - j_w + K - 1]

with Rh, Rw the block's ``rel_pos_h``, ``rel_pos_w`` tables [2K - 1, hd]
and K the side of the block's grid (the window's or the whole map's).
The trunk has no final norm; its output is the stride-16 map NHWC.

Compute: the parameters stay float32. Products run in the compute dtype
(bfloat16 on the card) with float32 sums; LayerNorm takes its statistics
in float32 and the residual stream stays float32, as Detectron2 under
autocast keeps it (the position table, a float32 parameter, promotes the
patch embedding). The bias terms are float32 products of the compute
dtype's q with the float32 tables (``ops/rel_attention.py:rel_pos_terms``,
their plain definition); the attention (``ops/rel_attention.py``) takes q
in qkv and the tables, and its softmax in float32: on the card KA2 forms
the terms inside the kernel.
Submodule names are Detectron2's (``net.blocks.N.attn.rel_pos_h``), so
that a converted checkpoint loads by name.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rel_attention import rel_attention
from ..utils.trace import stage
from .resnet import conv_nhwc

# LayerNorm's eps in the trunk, the pyramid and the box head (Detectron2's
# ViTDet: ``partial(nn.LayerNorm, eps=1e-6)``)
LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, in
    ``dtype``."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def get_abs_pos(abs_pos: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """The position table [1, 1 + S * S, C] (a cls row first) as a
    [1, h, w, C] float32 map: the cls row dropped, the S x S grid resized
    bicubically to h x w (``align_corners=False``) where it differs."""
    h, w = hw
    grid = abs_pos[:, 1:]
    size = int(math.sqrt(grid.shape[1]))
    if size * size != grid.shape[1]:
        raise ValueError(f"pos_embed: {grid.shape[1]} rows is no square")
    if size == h and size == w:
        return grid.reshape(1, h, w, -1)
    new = F.interpolate(grid.reshape(1, size, size, -1).permute(0, 3, 1, 2),
                        size=(h, w), mode="bicubic", align_corners=False)
    return new.permute(0, 2, 3, 1)


def window_partition(x: torch.Tensor, window: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> windows [B * nw, window, window, C], the map
    zero-padded to (Hp, Wp), multiples of ``window``; returns (windows,
    (Hp, Wp))."""
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c),
            (hp, wp))


def window_unpartition(windows: torch.Tensor, window: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """The inverse of ``window_partition``, cropped back to ``hw``."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w].contiguous() if (hp, wp) != (h, w) else x


class Attention(nn.Module):
    """Multi-head self-attention over an h x w grid of tokens with the
    decomposed relative-position bias; ``input_size`` is the grid's side
    (the window's or the whole map's). The attention with its bias runs
    in the stage range ``<prefix>.<stage_name>``; the qkv and proj
    products outside it."""
    seed_laws = {"rel_pos_h": ("trunc", 0.02), "rel_pos_w": ("trunc", 0.02)}

    def __init__(self, dim: int, num_heads: int, input_size: int,
                 compute_dtype: torch.dtype, prefix: str, stage_name: str):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.prefix, self.stage_name = prefix, stage_name
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        nn.init.trunc_normal_(self.rel_pos_h, std=0.02)
        nn.init.trunc_normal_(self.rel_pos_w, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, h, w, dim] in the compute dtype -> [N, h, w, dim]."""
        n, h, w, c = x.shape
        dt, nh = self.compute_dtype, self.num_heads
        qkv = linear(x.reshape(n, h * w, c), self.qkv, dt)
        with stage(self.prefix, self.stage_name):
            ctx = rel_attention(qkv, self.rel_pos_h, self.rel_pos_w, nh,
                                (h, w))
        return linear(ctx, self.proj, dt).reshape(n, h, w, c)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return linear(F.gelu(linear(x, self.fc1, dt)), self.fc2, dt)


class Block(nn.Module):
    """x = x + proj(attn(LN1(x))), then x = x + fc2(GELU(fc1(LN2(x)))),
    the attention inside windows when ``window_size`` > 0 (the normed
    map partitioned, the output unpartitioned and cropped)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size: int,
                 compute_dtype: torch.dtype, prefix: str):
        super().__init__()
        self.window_size, self.compute_dtype = window_size, compute_dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(
            dim, num_heads, window_size if window_size else input_size,
            compute_dtype, prefix,
            "window_attention" if window_size else "global_attention")
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, dim] float32 (the residual stream)."""
        dt = self.compute_dtype
        h = layer_norm(x, self.norm1, dt)
        if self.window_size:
            hw = (h.shape[1], h.shape[2])
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw,
                                   hw)
        else:
            h = self.attn(h)
        x = x + h.float()
        return x + self.mlp(layer_norm(x, self.norm2, dt)).float()


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x [B, H, W, 3] NHWC -> [B, H / p, W / p, embed_dim]."""
        w = self.proj.weight
        return conv_nhwc(x.to(dtype), w.to(dtype), w.shape[-1], 0) + \
            self.proj.bias.to(dtype)


class ViT(nn.Module):
    """The trunk: patch embedding, position table, ``depth`` blocks. The
    global blocks see the whole ``img_size / patch_size`` grid (their
    tables have 2 * grid - 1 rows), the windowed ones a window."""
    seed_laws = {"pos_embed": ("trunc", 0.02)}

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 depth: int, num_heads: int, mlp_ratio: float,
                 window_size: int, window_block_indexes: Sequence[int],
                 pretrain_img_size: int, compute_dtype: torch.dtype,
                 prefix: str):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        side = pretrain_img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + side * side,
                                                  embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        grid = img_size // patch_size
        windowed = set(window_block_indexes)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size if i in windowed else 0, grid, compute_dtype,
                  prefix)
            for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] NHWC -> the stride-16 map [B, H / 16, W / 16,
        dim] in the compute dtype."""
        x = self.patch_embed(x, self.compute_dtype)
        x = x.float() + get_abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x.to(self.compute_dtype)
