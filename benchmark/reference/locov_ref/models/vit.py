"""ViTDet's plain ViT trunk, the plain reference's copy (Detectron2
``modeling/backbone/vit.py`` at test time), NHWC.

The patch embedding (a 16 x 16 / 16 convolution), the position table
without its cls row, resized bicubically to the patch grid, then blocks
``x = x + proj(attn(LN1(x)))``, ``x = x + fc2(GELU(fc1(LN2(x))))``, the
windowed blocks attending inside zero-padded windows. Attention takes
the straightforward route: the scores of one image (global blocks) or of
one image's windows (windowed blocks) materialized, the decomposed
relative-position bias added to them, the softmax, the product with v.

Every product is ``F.conv2d``, ``F.linear`` or ``torch.matmul`` in the
compute dtype (the model's caller turns TF32 off for float32, and
``reference/fp8.py`` rounds each of them for the control); LayerNorm
statistics, the softmax and the residual stream are float32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # Detectron2's ViTDet: partial(nn.LayerNorm, eps=1e-6)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
               dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def abs_pos(table: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[1, 1 + S * S, C] -> [1, h, w, C]: the cls row dropped, bicubic
    resize of the S x S grid (align_corners False)."""
    grid = table[:, 1:]
    s = int(round(math.sqrt(grid.shape[1])))
    grid = grid.reshape(1, s, s, -1).permute(0, 3, 1, 2)
    if (s, s) != (h, w):
        grid = F.interpolate(grid, size=(h, w), mode="bicubic",
                             align_corners=False)
    return grid.permute(0, 2, 3, 1)


def rel_table(size: int, table: torch.Tensor) -> torch.Tensor:
    """[size, size, C]: entry (i, j) = table[i - j + size - 1]."""
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + size - 1]


def attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
              rel_pos_w: torch.Tensor, heads: int, kh: int, kw: int,
              dtype: torch.dtype) -> torch.Tensor:
    """qkv [N, L, 3 C] (L = kh * kw) -> the context [N, L, C]: the
    [N, heads, L, L] scores (q / sqrt(hd)) k^T materialized, plus
    q . Rh[i_h - j_h + kh - 1] and q . Rw[i_w - j_w + kw - 1], the
    softmax over the keys in float32, then the product with v."""
    n, l, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = (t.reshape(n, l, heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    s = torch.matmul(q * (1.0 / math.sqrt(hd)), k.transpose(-1, -2))
    rh = rel_table(kh, rel_pos_h).to(dtype)          # [kh, kh, hd]
    rw = rel_table(kw, rel_pos_w).to(dtype)          # [kw, kw, hd]
    r_q = q.reshape(n, heads, kh, kw, hd)
    # rel_h[n, h, i_h, i_w, j_h] = r_q[n, h, i_h, i_w] . rh[i_h, j_h]
    rel_h = torch.matmul(r_q, rh.transpose(-1, -2)[None, None])
    # rel_w[n, h, i_w, i_h, j_w] = r_q[n, h, i_h, i_w] . rw[i_w, j_w]
    rel_w = torch.matmul(r_q.transpose(2, 3), rw.transpose(-1, -2)[None, None])
    s = (s.float().view(n, heads, kh, kw, kh, kw)
         + rel_h.float()[..., :, None]
         + rel_w.float().transpose(2, 3)[..., None, :])
    p = torch.softmax(s.view(n, heads, l, l), dim=-1)
    ctx = torch.matmul(p.to(dtype), v)
    return ctx.transpose(1, 2).reshape(n, l, c)


class Attention(nn.Module):
    seed_laws = {"rel_pos_h": ("trunc", 0.02), "rel_pos_w": ("trunc", 0.02)}

    def __init__(self, dim: int, heads: int, size: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x: torch.Tensor, group: int) -> torch.Tensor:
        """x [N, h, w, dim]; the attention ``group`` maps at a time."""
        n, h, w, c = x.shape
        qkv = linear(x.reshape(n, h * w, c), self.qkv, self.dtype)
        ctx = torch.cat([attention(qkv[i:i + group], self.rel_pos_h,
                                   self.rel_pos_w, self.heads, h, w,
                                   self.dtype)
                         for i in range(0, n, group)])
        return linear(ctx, self.proj, self.dtype).reshape(n, h, w, c)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1, self.dtype)), self.fc2,
                      self.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, window: int,
                 grid: int, dtype: torch.dtype):
        super().__init__()
        self.window, self.dtype = window, dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, window or grid, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = layer_norm(x, self.norm1, self.dtype)
        ws = self.window
        if ws:
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
            y = y.view(b, hp // ws, ws, wp // ws, ws, c).permute(
                0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
            nw = (hp // ws) * (wp // ws)
            y = self.attn(y, nw)  # one image's windows at a time
            y = y.view(b, hp // ws, wp // ws, ws, ws, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
        else:
            y = self.attn(y, 1)
        x = x + y.float()
        return x + self.mlp(layer_norm(x, self.norm2, self.dtype)).float()


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class ViT(nn.Module):
    seed_laws = {"pos_embed": ("trunc", 0.02)}

    def __init__(self, img_size: int, patch_size: int, embed_dim: int,
                 depth: int, num_heads: int, mlp_ratio: float,
                 window_size: int, window_block_indexes: Sequence[int],
                 pretrain_img_size: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        side = pretrain_img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + side * side,
                                                  embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size if i in set(window_block_indexes) else 0,
                  img_size // patch_size, dtype) for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, H / 16, W / 16, dim] in the dtype."""
        p = self.patch_embed.proj
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype),
                     p.weight.to(self.dtype), p.bias.to(self.dtype),
                     stride=p.stride)
        y = y.permute(0, 2, 3, 1).float()
        y = y + abs_pos(self.pos_embed, y.shape[1], y.shape[2])
        for blk in self.blocks:
            y = blk(y)
        return y.to(self.dtype)


def level_names(patch: int, scales: Sequence[float]) -> Tuple:
    """``p<k>`` of each scale's level, then of the top level."""
    ks = [int(round(math.log2(patch / s))) for s in scales]
    return tuple(f"p{k}" for k in ks + [ks[-1] + 1])
