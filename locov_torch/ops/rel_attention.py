"""The ViT's multi-head self-attention with the decomposed
relative-position bias, from the fused qkv product: KA2
(``csrc/rel_attention.cu``) on the card, its plain version elsewhere.

No Pallas parent: the JAX package has no ViT. ``rel_attention`` takes
qkv [N, L, 3 C] (query, key and value side by side, each C = heads x hd
wide, a head's hd columns together, as ``models/vit.py:Attention``'s
``qkv`` product lays them), the two bias terms rel_h [N, heads, L, kh]
and rel_w [N, heads, L, kw] in float32 (``models/vit.py:rel_pos_terms``)
and the grid (kh, kw), L = kh * kw, and returns the context [N, L, C]:

    s_ij = (q_i / sqrt(hd)) . k_j + rel_h[i, j // kw] + rel_w[i, j % kw]
    ctx_i = sum_j softmax_j(s_ij) v_j

- a bfloat16 qkv on a CUDA device goes through the op
  ``locov::rel_attention``, whose CUDA kernel is KA2: the keys walked in
  tiles with an online softmax in float32, the bias added as each tile
  is scored, so that no [L, L] score or bias tensor is ever written; the
  context comes back in bfloat16 (hd 64, any L);
- anything else (the CPU, the float32 compute dtype) runs
  ``rel_attention_plain``, the same equations with the scores
  materialized, in float32, the context cast back to qkv's dtype.

The kernel's context equals the plain one's, cast to bfloat16, within
bfloat16 rounding: it rounds each tile's probabilities to bfloat16 for
the product with v (float32 sums), and takes exp2 of the log2e-scaled
scores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import kernel_lib

HEAD_DIM = 64


def rel_attention_plain(qkv: torch.Tensor, rel_h: torch.Tensor,
                        rel_w: torch.Tensor, num_heads: int,
                        grid: Tuple[int, int]) -> torch.Tensor:
    """qkv [N, L, 3 C], rel_h [N, heads, L, kh], rel_w [N, heads, L, kw]
    -> the context [N, L, C] in qkv's dtype, computed in float32 with
    the [N, heads, L, L] scores materialized."""
    n, l, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    kh, kw = grid
    q, k, v = (t.reshape(n, l, num_heads, hd).transpose(1, 2).float()
               for t in qkv.split(c, dim=-1))
    s = (q * (1.0 / math.sqrt(hd))) @ k.transpose(-1, -2)
    s = (s.view(n, num_heads, l, kh, kw) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(n, num_heads, l, l)
    ctx = torch.softmax(s, dim=-1) @ v
    return ctx.transpose(1, 2).reshape(n, l, c).to(qkv.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = kernel_lib.load("rel_attention").rel_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_F, _P]
        fn.restype = ctypes.c_int
    return fn


def rel_attention_cuda(qkv: torch.Tensor, rel_h: torch.Tensor,
                       rel_w: torch.Tensor, num_heads: int,
                       grid: Tuple[int, int]) -> torch.Tensor:
    """KA2: qkv [N, L, 3 C] bf16, rel_h [N, heads, L, kh] and rel_w
    [N, heads, L, kw] f32, contiguous CUDA tensors -> ctx [N, L, C]
    bf16. One launch for every (image or window, head)."""
    kernel_lib.check_cuda_tensor(qkv, "rel_attention qkv", (torch.bfloat16,))
    kernel_lib.check_cuda_tensor(rel_h, "rel_attention rel_h",
                                 (torch.float32,))
    kernel_lib.check_cuda_tensor(rel_w, "rel_attention rel_w",
                                 (torch.float32,))
    n, l, c3 = qkv.shape
    kh, kw = grid
    if c3 % (3 * num_heads) or c3 // (3 * num_heads) != HEAD_DIM:
        raise ValueError(f"rel_attention: qkv {tuple(qkv.shape)} with "
                         f"{num_heads} heads; the kernel takes hd "
                         f"{HEAD_DIM}")
    if l != kh * kw or tuple(rel_h.shape) != (n, num_heads, l, kh) or \
            tuple(rel_w.shape) != (n, num_heads, l, kw):
        raise ValueError(f"rel_attention: rel_h {tuple(rel_h.shape)}, "
                         f"rel_w {tuple(rel_w.shape)} for qkv "
                         f"{tuple(qkv.shape)} on a {kh} x {kw} grid")
    if not (qkv.device == rel_h.device == rel_w.device) or \
            qkv.data_ptr() % 16:
        raise ValueError("rel_attention: inputs on one device, qkv "
                         "16-byte aligned")
    ctx = torch.empty((n, l, c3 // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    if ctx.numel() == 0:
        return ctx
    with torch.cuda.device(qkv.device):
        err = _fn()(qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                    ctx.data_ptr(), n, l, num_heads, HEAD_DIM, kh, kw,
                    1.0 / math.sqrt(HEAD_DIM),
                    kernel_lib.stream_ptr(qkv.device))
    kernel_lib.check_launch(err, "rel_attention")
    kernel_lib.LAUNCHES["rel_attention"] += 1
    return ctx


@torch.library.custom_op("locov::rel_attention", mutates_args=(),
                         device_types="cpu")
def _rel_attention_op(qkv: torch.Tensor, rel_h: torch.Tensor,
                      rel_w: torch.Tensor, num_heads: int, kh: int,
                      kw: int) -> torch.Tensor:
    return rel_attention_plain(qkv, rel_h, rel_w, num_heads, (kh, kw))


@_rel_attention_op.register_kernel("cuda")
def _(qkv, rel_h, rel_w, num_heads, kh, kw):
    return rel_attention_cuda(qkv, rel_h, rel_w, num_heads, (kh, kw))


@_rel_attention_op.register_fake
def _(qkv, rel_h, rel_w, num_heads, kh, kw):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


def rel_attention(qkv: torch.Tensor, rel_h: torch.Tensor,
                  rel_w: torch.Tensor, num_heads: int,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """The context [N, L, C] of ``num_heads``-head self-attention over
    qkv [N, L, 3 C] on a ``grid`` of tokens with the decomposed bias
    terms: KA2 (``locov::rel_attention``) for a bfloat16 qkv on the card
    (bfloat16 context), else the plain version in float32."""
    if qkv.is_cuda and qkv.dtype == torch.bfloat16:
        return torch.ops.locov.rel_attention(
            qkv.contiguous(), rel_h.contiguous(), rel_w.contiguous(),
            num_heads, int(grid[0]), int(grid[1]))
    return rel_attention_plain(qkv, rel_h, rel_w, num_heads, grid)
