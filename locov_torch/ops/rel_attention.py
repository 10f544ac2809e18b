"""The ViT's multi-head self-attention with the decomposed
relative-position bias, from the fused qkv product and the two position
tables: KA2 (``csrc/rel_attention.cu``) on the card, its plain version
elsewhere.

No Pallas parent: the JAX package has no ViT. ``rel_attention`` takes
qkv [N, L, 3 C] (query, key and value side by side, each C = heads x hd
wide, a head's hd columns together, as ``models/vit.py:Attention``'s
``qkv`` product lays them), the block's float32 tables rel_pos_h
[2 kh - 1, hd] and rel_pos_w [2 kw - 1, hd] and the grid (kh, kw),
L = kh * kw, and returns the context [N, L, C]:

    s_ij = (q_i / sqrt(hd)) . k_j + rel_h[i, j // kw] + rel_w[i, j % kw]
    ctx_i = sum_j softmax_j(s_ij) v_j

with the bias terms of ``rel_pos_terms``: rel_h[i, j_h] = q_i .
Rh[i_h - j_h + kh - 1], rel_w[i, j_w] = q_i . Rw[i_w - j_w + kw - 1].

- a bfloat16 qkv on a CUDA device goes through the op
  ``locov::rel_attention``, whose CUDA kernel is KA2: the terms formed
  inside the kernel from q and the tables (float32-accurate), the keys
  walked in tiles with an online softmax in float32, so that no bias
  term and no [L, L] tensor is ever written; the context comes back in
  bfloat16 (hd 64, any grid up to 64 x 64);
- anything else (the CPU, the float32 compute dtype) runs
  ``rel_attention_plain``: ``rel_pos_terms`` in float32, then the same
  equations with the scores materialized, in float32, the context cast
  back to qkv's dtype.

The kernel's context equals the plain one's, cast to bfloat16, within
bfloat16 rounding: it rounds each tile's probabilities to bfloat16 for
the product with v (float32 sums), and takes exp2 of the log2e-scaled
scores.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import kernel_lib

HEAD_DIM = 64
MAX_GRID = 64  # KA2's largest kh, kw


def get_rel_pos(q_size: int, k_size: int,
                rel_pos: torch.Tensor) -> torch.Tensor:
    """The table's rows by relative position: [q_size, k_size, C], row
    (i, j) = rel_pos[i - j + k_size - 1] (query and key grids of one
    side, as in every block here)."""
    if q_size != k_size or rel_pos.shape[0] != 2 * k_size - 1:
        raise ValueError(f"rel_pos: {rel_pos.shape[0]} rows for a grid of "
                         f"{q_size} x {k_size}; expected {2 * k_size - 1}")
    coords = torch.arange(q_size, device=rel_pos.device)
    return rel_pos[coords[:, None] - coords[None, :] + (k_size - 1)]


def rel_pos_terms(q: torch.Tensor, rel_pos_h: torch.Tensor,
                  rel_pos_w: torch.Tensor, grid: Tuple[int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposed bias terms in float32 from q [N, heads, L, hd]
    (L = kh * kw, unscaled): rel_h [N, heads, L, kh], rel_h[., i, j_h] =
    q_i . Rh[i_h - j_h + kh - 1], and rel_w [N, heads, L, kw] likewise by
    column. Each is one batched product a grid row (or column)."""
    n, nh, _, hd = q.shape
    kh, kw = grid
    rh = get_rel_pos(kh, kh, rel_pos_h.float())  # [kh, kh, hd]
    rw = get_rel_pos(kw, kw, rel_pos_w.float())
    r_q = q.float().reshape(n * nh, kh, kw, hd)
    qh = r_q.permute(1, 0, 2, 3).reshape(kh, n * nh * kw, hd)
    rel_h = torch.bmm(qh, rh.transpose(1, 2)).view(kh, n * nh, kw, kh)
    rel_h = rel_h.permute(1, 0, 2, 3).reshape(n, nh, kh * kw, kh)
    qw = r_q.permute(2, 0, 1, 3).reshape(kw, n * nh * kh, hd)
    rel_w = torch.bmm(qw, rw.transpose(1, 2)).view(kw, n * nh, kh, kw)
    rel_w = rel_w.permute(1, 2, 0, 3).reshape(n, nh, kh * kw, kw)
    return rel_h, rel_w


def rel_attention_plain(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                        rel_pos_w: torch.Tensor, num_heads: int,
                        grid: Tuple[int, int]) -> torch.Tensor:
    """qkv [N, L, 3 C], the tables rel_pos_h [2 kh - 1, hd] and rel_pos_w
    [2 kw - 1, hd] -> the context [N, L, C] in qkv's dtype: the bias
    terms by ``rel_pos_terms`` in float32, then the attention in float32
    with the [N, heads, L, L] scores materialized."""
    n, l, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    kh, kw = grid
    q, k, v = (t.reshape(n, l, num_heads, hd).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    rel_h, rel_w = rel_pos_terms(q, rel_pos_h, rel_pos_w, grid)
    q, k, v = q.float(), k.float(), v.float()
    s = (q * (1.0 / math.sqrt(hd))) @ k.transpose(-1, -2)
    s = (s.view(n, num_heads, l, kh, kw) + rel_h[..., :, None]
         + rel_w[..., None, :]).view(n, num_heads, l, l)
    ctx = torch.softmax(s, dim=-1) @ v
    return ctx.transpose(1, 2).reshape(n, l, c).to(qkv.dtype)


def rel_attention_cuda(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor, num_heads: int,
                       grid: Tuple[int, int]) -> torch.Tensor:
    """KA2: qkv [N, L, 3 C] bf16, rel_pos_h [2 kh - 1, 64] and rel_pos_w
    [2 kw - 1, 64] f32, contiguous CUDA tensors -> ctx [N, L, C] bf16.
    One launch for every (image or window, head)."""
    kernel_lib.check_cuda_tensor(qkv, "rel_attention qkv", (torch.bfloat16,))
    kernel_lib.check_cuda_tensor(rel_pos_h, "rel_attention rel_pos_h",
                                 (torch.float32,))
    kernel_lib.check_cuda_tensor(rel_pos_w, "rel_attention rel_pos_w",
                                 (torch.float32,))
    n, l, c3 = qkv.shape
    kh, kw = grid
    if c3 % (3 * num_heads) or c3 // (3 * num_heads) != HEAD_DIM:
        raise ValueError(f"rel_attention: qkv {tuple(qkv.shape)} with "
                         f"{num_heads} heads; the kernel takes hd "
                         f"{HEAD_DIM}")
    if l != kh * kw or not (1 <= kh <= MAX_GRID and 1 <= kw <= MAX_GRID) \
            or tuple(rel_pos_h.shape) != (2 * kh - 1, HEAD_DIM) \
            or tuple(rel_pos_w.shape) != (2 * kw - 1, HEAD_DIM):
        raise ValueError(f"rel_attention: rel_pos_h "
                         f"{tuple(rel_pos_h.shape)}, rel_pos_w "
                         f"{tuple(rel_pos_w.shape)} for qkv "
                         f"{tuple(qkv.shape)} on a {kh} x {kw} grid (at "
                         f"most {MAX_GRID} x {MAX_GRID})")
    if not (qkv.device == rel_pos_h.device == rel_pos_w.device) or any(
            t.data_ptr() % 16 for t in (qkv, rel_pos_h, rel_pos_w)):
        raise ValueError("rel_attention: inputs on one device, 16-byte "
                         "aligned")
    ctx = torch.empty((n, l, c3 // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    if ctx.numel() == 0:
        return ctx
    kernel_lib.launch("rel_attention_fwd", qkv.device, qkv.data_ptr(),
                      rel_pos_h.data_ptr(), rel_pos_w.data_ptr(),
                      ctx.data_ptr(), n, l, num_heads, HEAD_DIM, kh, kw,
                      1.0 / math.sqrt(HEAD_DIM))
    kernel_lib.LAUNCHES["rel_attention"] += 1
    return ctx


@torch.library.custom_op("locov::rel_attention", mutates_args=(),
                         device_types="cpu")
def _rel_attention_op(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                      rel_pos_w: torch.Tensor, num_heads: int, kh: int,
                      kw: int) -> torch.Tensor:
    return rel_attention_plain(qkv, rel_pos_h, rel_pos_w, num_heads,
                               (kh, kw))


@_rel_attention_op.register_kernel("cuda")
def _(qkv, rel_pos_h, rel_pos_w, num_heads, kh, kw):
    return rel_attention_cuda(qkv, rel_pos_h, rel_pos_w, num_heads,
                              (kh, kw))


@_rel_attention_op.register_fake
def _(qkv, rel_pos_h, rel_pos_w, num_heads, kh, kw):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


def rel_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                  rel_pos_w: torch.Tensor, num_heads: int,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """The context [N, L, C] of ``num_heads``-head self-attention over
    qkv [N, L, 3 C] on a ``grid`` of tokens with the decomposed bias of
    the tables ``rel_pos_h``, ``rel_pos_w``: KA2
    (``locov::rel_attention``, the terms formed in the kernel) for a
    bfloat16 qkv on the card (bfloat16 context), else the plain version
    in float32."""
    if qkv.is_cuda and qkv.dtype == torch.bfloat16:
        return torch.ops.locov.rel_attention(
            qkv.contiguous(), rel_pos_h.float().contiguous(),
            rel_pos_w.float().contiguous(), num_heads, int(grid[0]),
            int(grid[1]))
    return rel_attention_plain(qkv, rel_pos_h, rel_pos_w, num_heads, grid)
