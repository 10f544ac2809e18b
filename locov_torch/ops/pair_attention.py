"""The joint encoder's multi-head self-attention from the fused QKV
product: KA1 (``csrc/pair_attention.cu``) on the card, its plain version
elsewhere.

No Pallas parent: JAX leaves this attention to XLA
(``locov_tpu/models/bert.py:95-100``). ``pair_attention`` takes qkv
[B, L, 3 H] (query, key and value side by side, the product of
``models/bert.py:BertSelfAttention``), the additive bias [B, 1, 1, L]
and the dropout rate, and returns the context [B, L, H]:

- a bfloat16 qkv on a CUDA device goes through ``_PairAttention``, whose
  forward and backward are KA1's two kernels (``pair_attention_cuda``,
  ``pair_attention_bwd_cuda``), and the context comes back in bfloat16;
  the bias must then be float32, hd 64 or 96 and L at most 512, or the
  wrapper raises;
- anything else (the CPU, the float32 compute dtype) runs
  ``pair_attention_plain``, the PyTorch chain under Flax's dtype rules:
  the float32 bias promotes the bfloat16 scores, so the softmax, the
  dropout and the context product run in float32 and the context comes
  back in float32.

Both routes draw the dropout's uniforms the same way, one ``torch.rand``
of [B, heads, L, L] from ``generator`` before the scores, so the masks,
and every later draw, are the same on either route. The kernel's
context equals the plain one rounded to bfloat16 (the consumer,
``Dense``, casts it first) up to float32 summation order; its gradient
likewise (the rounding points are the same; ``csrc/pair_attention.cu``
lists them).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import kernel_lib

HEAD_DIMS = (64, 96)
MAX_TOKENS = 512


def pair_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                         num_heads: int, p: float,
                         u: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv [..., L, 3 H], bias broadcastable to [..., heads, L, L], u the
    dropout's uniforms [..., heads, L, L] or None (no dropout) ->
    the context [..., L, H], in plain PyTorch."""
    hsz = qkv.shape[-1] // 3
    hd = hsz // num_heads
    q, k, v = (x.reshape(x.shape[:-1] + (num_heads, hd)).transpose(-2, -3)
               for x in qkv.split(hsz, dim=-1))  # [B, nh, L, hd]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores + bias  # [B, 1, 1, L]; promotes
    probs = torch.softmax(scores, dim=-1)
    if u is not None:
        probs = torch.where(u < 1.0 - p, probs / (1.0 - p),
                            torch.zeros_like(probs))
    ct = torch.promote_types(probs.dtype, v.dtype)
    ctx = probs.to(ct) @ v.to(ct)
    return ctx.transpose(-2, -3).reshape(qkv.shape[:-1] + (hsz,))


def scalars(hd: int, p: float):
    """(1 / sqrt(hd), 1 - p, 1 / (1 - p)) in float32, as PyTorch on CUDA
    computes them for the plain chain's divisions by a Python number (a
    product by the float32 reciprocal) and its comparison with one."""
    one = np.float32(1.0)
    keep = np.float32(1.0 - p)
    return (float(one / np.float32(math.sqrt(hd))), float(keep),
            float(one / keep))


def bits_words(num_tokens: int) -> int:
    """32-bit words of keep bits a row: L rounded up to 16, over 32."""
    return (-(-num_tokens // 16) * 16 + 31) // 32


def _check(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int):
    """(n, l, hd) of a qkv and bias the kernels take, or raise."""
    kernel_lib.check_cuda_tensor(qkv, "pair_attention qkv",
                                 (torch.bfloat16,))
    kernel_lib.check_cuda_tensor(bias, "pair_attention bias",
                                 (torch.float32,))
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"pair_attention: qkv {tuple(qkv.shape)} is not "
                         f"[B, L, 3 H] with H a multiple of {num_heads}")
    n, l, h3 = qkv.shape
    hd = h3 // (3 * num_heads)
    if hd not in HEAD_DIMS or not 1 <= l <= MAX_TOKENS:
        raise ValueError(f"pair_attention: head size {hd}, {l} tokens; "
                         f"the kernel takes {HEAD_DIMS} and 1 to "
                         f"{MAX_TOKENS}")
    if tuple(bias.shape) != (n, l) or bias.device != qkv.device:
        raise ValueError(f"pair_attention: bias {tuple(bias.shape)} on "
                         f"{bias.device} for qkv {tuple(qkv.shape)}")
    if qkv.data_ptr() % 16:
        raise ValueError("pair_attention: qkv must be 16-byte aligned")
    return n, l, hd


def pair_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                        u: Optional[torch.Tensor], num_heads: int, p: float,
                        for_backward: bool = True):
    """KA1's forward: qkv [n, L, 3 H] bf16, bias [n, L] f32, u [n, heads,
    L, L] f32 or None -> (ctx [n, L, H] bf16, saved), contiguous CUDA
    tensors; ``saved`` what the backward takes, None without
    ``for_backward``: the context in float32 [n, L, H], the rows'
    statistics [n, heads, L, 2] f32 (max and sum) and the keep bits [n,
    heads, L, ``bits_words(L)``] int32 (None without u)."""
    n, l, hd = _check(qkv, bias, num_heads)
    if u is not None:
        kernel_lib.check_cuda_tensor(u, "pair_attention u", (torch.float32,))
        if tuple(u.shape) != (n, num_heads, l, l) or u.device != qkv.device:
            raise ValueError(f"pair_attention: u {tuple(u.shape)} for "
                             f"qkv {tuple(qkv.shape)}")
    dev = qkv.device
    ctx = torch.empty((n, l, num_heads * hd), dtype=torch.bfloat16,
                      device=dev)
    saved = None
    if for_backward:
        saved = (torch.empty(ctx.shape, dtype=torch.float32, device=dev),
                 torch.empty((n, num_heads, l, 2), dtype=torch.float32,
                             device=dev),
                 None if u is None else torch.empty(
                     (n, num_heads, l, bits_words(l)), dtype=torch.int32,
                     device=dev))
    ptrs = [None if t is None else t.data_ptr()
            for t in (saved or (None, None, None))]
    inv_sqrt, keep_below, inv_keep = scalars(hd, p)
    kernel_lib.launch(
        "pair_attention_fwd", dev, qkv.data_ptr(), bias.data_ptr(),
        None if u is None else u.data_ptr(), ctx.data_ptr(), *ptrs, n, l,
        num_heads, hd, inv_sqrt, keep_below, inv_keep)
    kernel_lib.LAUNCHES["pair_attention"] += 1
    return ctx, saved


def pair_attention_bwd_cuda(qkv: torch.Tensor, bias: torch.Tensor, saved,
                            dout: torch.Tensor, num_heads: int,
                            p: float) -> torch.Tensor:
    """KA1's backward: the forward's qkv, bias and ``saved``, and dout
    [n, L, H] bf16, the context's gradient -> dqkv [n, L, 3 H] bf16."""
    n, l, hd = _check(qkv, bias, num_heads)
    ctx32, stats, bits = saved
    kernel_lib.check_cuda_tensor(ctx32, "pair_attention ctx32",
                                 (torch.float32,))
    kernel_lib.check_cuda_tensor(stats, "pair_attention stats",
                                 (torch.float32,))
    kernel_lib.check_cuda_tensor(dout, "pair_attention dout",
                                 (torch.bfloat16,))
    shape = (n, l, num_heads * hd)
    if not (tuple(dout.shape) == tuple(ctx32.shape) == shape and
            tuple(stats.shape) == (n, num_heads, l, 2)) or \
            dout.data_ptr() % 16:
        raise ValueError(f"pair_attention: dout {tuple(dout.shape)}, ctx32 "
                         f"{tuple(ctx32.shape)}, stats {tuple(stats.shape)} "
                         f"for qkv {tuple(qkv.shape)}, or dout not 16-byte "
                         f"aligned")
    if bits is not None:
        kernel_lib.check_cuda_tensor(bits, "pair_attention bits",
                                     (torch.int32,))
    dqkv = torch.empty_like(qkv)
    inv_sqrt, _, inv_keep = scalars(hd, p)
    kernel_lib.launch(
        "pair_attention_bwd", qkv.device, qkv.data_ptr(), bias.data_ptr(),
        ctx32.data_ptr(), stats.data_ptr(),
        None if bits is None else bits.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), n, l, num_heads, hd, inv_sqrt, inv_keep)
    kernel_lib.LAUNCHES["pair_attention_bwd"] += 1
    return dqkv


class _PairAttention(torch.autograd.Function):
    """KA1 with its backward. It keeps qkv, the float32 context, the row
    statistics and the keep bits for the backward, never the score
    tensor; under ``remat`` the recompute runs the forward again on the
    same uniforms."""

    @staticmethod
    def forward(ctx, qkv, bias, u, num_heads, p):
        out, saved = pair_attention_cuda(qkv, bias, u, num_heads, p,
                                         ctx.needs_input_grad[0])
        if saved is not None:
            ctx.save_for_backward(qkv, bias, *saved)
        ctx.num_heads, ctx.p = num_heads, p
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, *saved = ctx.saved_tensors
        dqkv = pair_attention_bwd_cuda(qkv, bias, saved, dout.contiguous(),
                                       ctx.num_heads, ctx.p)
        return dqkv, None, None, None, None


def pair_attention(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                   p: float, deterministic: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """The context [..., L, H] of ``num_heads``-head self-attention over
    qkv [..., L, 3 H] with the additive bias [..., 1, 1, L], its
    probabilities dropped at rate ``p`` (Flax's ``nn.Dropout``: uniforms
    from ``generator``) unless ``deterministic`` or p is 0. KA1 for a
    bfloat16 qkv on the card (bfloat16 context), else the plain chain."""
    u = None
    if not deterministic and p != 0.0:
        l = qkv.shape[-2]
        u = torch.rand(qkv.shape[:-2] + (num_heads, l, l),
                       generator=generator, device=qkv.device)
    if not (qkv.is_cuda and qkv.dtype == torch.bfloat16):
        return pair_attention_plain(qkv, bias, num_heads, p, u)
    if bias.requires_grad:
        raise ValueError("pair_attention: the kernel gives no gradient "
                         "for the bias")
    n, l = qkv.shape[0], qkv.shape[-2]
    if tuple(bias.shape) != (n, 1, 1, l):
        raise ValueError(f"pair_attention: bias {tuple(bias.shape)}, "
                         f"expected {(n, 1, 1, l)}")
    return _PairAttention.apply(qkv, bias.reshape(n, l).contiguous(), u,
                                num_heads, p)
