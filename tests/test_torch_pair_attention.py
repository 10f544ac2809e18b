"""The attention route of ``models/bert.py:BertSelfAttention`` on the CPU
(``locov_torch/ops/pair_attention.py``): the plain version is the chain
the port ran before KA1, bit for bit, in both compute dtypes, both mask
forms and with dropout on or off, drawing the same uniforms from the
generator; the CPU takes it and launches nothing; the kernels' wrappers
refuse CPU tensors before building anything; the float32 constants the
kernels take are those PyTorch on CUDA uses for the chain's divisions.
KA1 itself runs only on the card (tests/test_torch_kernels_gpu.py)."""
import math

import numpy as np
import pytest
import torch

from locov_torch.models import bert as tbert
from locov_torch.ops import kernel_lib
from locov_torch.ops import pair_attention as pa


def _chain(att, hidden, bias, deterministic, generator):
    """``BertSelfAttention.forward`` as the port wrote it before KA1."""
    c = att.cfg
    nh = c.num_attention_heads
    hd = c.hidden_size // nh
    dt = c.dtype or torch.promote_types(hidden.dtype, torch.float32)
    w = torch.cat([att.query.weight, att.key.weight,
                   att.value.weight]).to(dt)
    b = torch.cat([att.query.bias, att.key.bias, att.value.bias]).to(dt)
    qkv = torch.nn.functional.linear(hidden.to(dt), w) + b
    q, k, v = (x.reshape(x.shape[:-1] + (nh, hd)).transpose(-2, -3)
               for x in qkv.split(c.hidden_size, dim=-1))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    probs = tbert.dropout(probs, c.attention_probs_dropout_prob,
                          deterministic, generator)
    ct = torch.promote_types(probs.dtype, v.dtype)
    ctx = probs.to(ct) @ v.to(ct)
    return ctx.transpose(-2, -3).reshape(hidden.shape[:-1] +
                                         (c.hidden_size,))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw_mask", "min_mask"])
@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["no_dropout", "dropout"])
def test_plain_route_is_the_chain_bit_for_bit(dtype, raw, deterministic):
    """Output, input gradient and every parameter gradient equal to the
    chain's bits; the generator left in the same state."""
    cfg = tbert.BertConfig(hidden_size=32, num_attention_heads=2,
                           attention_probs_dropout_prob=0.3, dtype=dtype)
    torch.manual_seed(0)
    att = tbert.BertSelfAttention(cfg)
    hidden = torch.randn(3, 7, 32)
    m = (torch.arange(7)[None] < torch.tensor([[7], [5], [2]])).float()
    m = m[:, None, None, :]
    bias = m if raw else (1.0 - m) * torch.finfo(torch.float32).min
    outs = []
    for fn in (att.forward, lambda *a: _chain(att, *a)):
        att.zero_grad()
        h = hidden.clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(11)
        y = fn(h, bias, deterministic, gen)
        y.float().square().sum().backward()
        outs.append((y, h.grad, [p.grad.clone() for p in att.parameters()],
                     gen.get_state()))
    (y, dh, dp, st), (y0, dh0, dp0, st0) = outs
    assert y.dtype == y0.dtype == torch.float32
    assert torch.equal(y, y0) and torch.equal(dh, dh0)
    assert all(torch.equal(a, b) for a, b in zip(dp, dp0))
    assert torch.equal(st, st0)


def test_cpu_takes_the_plain_version():
    """A bfloat16 qkv on the CPU: the plain chain, no kernel launched,
    the uniforms drawn from the generator in the chain's shape."""
    qkv = torch.randn(2, 5, 3 * 128).to(torch.bfloat16)
    bias = torch.zeros(2, 1, 1, 5)
    before = dict(kernel_lib.LAUNCHES)
    gen = torch.Generator().manual_seed(3)
    got = pa.pair_attention(qkv, bias, 2, 0.1, False, gen)
    assert kernel_lib.LAUNCHES == before
    u = torch.rand((2, 2, 5, 5), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, pa.pair_attention_plain(qkv, bias, 2, 0.1, u))
    assert torch.equal(gen.get_state(), _after_one_draw(3, (2, 2, 5, 5)))


def _after_one_draw(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    torch.rand(shape, generator=gen)
    return gen.get_state()


@pytest.mark.parametrize("hd,p", [(96, 0.1), (64, 0.1), (64, 0.0)])
def test_kernel_scalars_are_cuda_reciprocals(hd, p):
    """PyTorch on CUDA divides by a Python number as a product by the
    float32 reciprocal of its float32 value, and compares with its
    float32 value: the kernels take those three float32 numbers."""
    inv_sqrt, keep, inv_keep = pa.scalars(hd, p)
    assert inv_sqrt == float(np.float32(1) / np.float32(math.sqrt(hd)))
    assert keep == float(np.float32(1 - p))
    assert inv_keep == float(np.float32(1) / np.float32(1 - p))
    for x in (inv_sqrt, keep, inv_keep):
        assert float(np.float32(x)) == x


@pytest.mark.parametrize("tokens,words", [(1, 1), (16, 1), (17, 1),
                                          (33, 2), (170, 6), (512, 16)])
def test_keep_bit_words(tokens, words):
    """A row's keep bits cover L rounded up to 16, 32 to a word."""
    assert pa.bits_words(tokens) == words


def test_kernel_wrappers_refuse_cpu_tensors():
    qkv = torch.zeros(2, 5, 3 * 192, dtype=torch.bfloat16)
    bias = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        pa.pair_attention_cuda(qkv, bias, None, 2, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        pa.pair_attention_bwd_cuda(
            qkv, bias, (torch.zeros(2, 5, 192), torch.zeros(2, 2, 5, 2),
                        None),
            torch.zeros(2, 5, 192, dtype=torch.bfloat16), 2, 0.1)
