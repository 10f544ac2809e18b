"""BERT in PyTorch (encoder, embeddings, pooler, LM head), with Flax's
dtype rules.

Counterpart of ``locov_tpu/models/bert.py``: a post-LN encoder with
learned positions and exact GELU, and a prediction head whose decoder is
tied to the word-embedding matrix, which is a forward input. Submodules
carry the Flax scope names (``layer_0``, ``attention_self/query``,
``attention_norm``, ...), so ``utils/weights.py:from_flax`` maps the
weights one to one.

Compute dtype (``BertConfig.dtype``): None computes in float32; with
bfloat16 the dense layers and the attention products run in bfloat16
while the parameters stay float32, as Flax does it:

- ``Dense`` casts its input and parameters to the dtype and returns it;
- ``LayerNorm`` (float32 parameters) computes in float32 and returns
  float32, whatever its input's dtype;
- a bfloat16 tensor plus a float32 one is float32 (the attention bias
  makes the scores float32, so the softmax and the context product run
  in float32).

The attention after the fused QKV product is ``ops/pair_attention.py``:
on the card in bfloat16, one hand-written kernel each way (KA1), which
keeps those rounding points and returns the context already in the
``Dense``'s bfloat16; elsewhere the plain chain.

Dropout draws its mask from the ``torch.Generator`` passed down with
``deterministic=False`` (``F.dropout`` would use the global generator);
``remat`` recomputes a function in the backward with the same masks.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.matmul import linear_f32
from ..ops.pair_attention import pair_attention


class BertConfig(NamedTuple):
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # compute dtype of the dense and attention products (parameters stay
    # float32); None = float32
    dtype: Any = None

    @classmethod
    def from_cfg_node(cls, node):
        """Build from a ``BERT_CONFIG`` CfgNode (unknown keys ignored)."""
        known = cls._fields
        return cls(**{k: v for k, v in node.items() if k in known})


def dropout(x: torch.Tensor, p: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each element with probability 1 - p
    (a uniform draw from ``generator`` below 1 - p) and scale it by
    1 / (1 - p); the identity when ``deterministic`` or p is 0."""
    if deterministic or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def remat(fn, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward instead of kept.
    The checkpoint restores only the global RNG states for the
    recompute, never an explicit generator, so the dropout masks that
    ``fn`` draws from ``generator`` would be drawn anew, from a later
    state. Here the recompute starts from the state the forward started
    from, and the generator's state after the recompute is put back, so
    the backward sees the forward's masks and later draws are not
    moved."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    start = generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)
    return checkpoint(run, *args, use_reentrant=False)


class Dense(nn.Linear):
    """Flax's ``nn.Dense`` ([..., in] -> [..., out], weight stored
    [out, in]): the input and the parameters cast to ``dtype`` (None:
    the input's dtype promoted with float32), the product rounded, then
    the bias added. ``highest`` computes a float32 product in full
    float32 on the card (``Precision.HIGHEST``, ``ops/matmul.py``).
    ``init_std`` is the initialiser ``utils/weights.py:seeded_init_``
    gives it: N(0, init_std), or Flax's ``lecun_normal`` where None."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 init_std: Optional[float] = None, highest: bool = False):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        self.init_std = init_std
        self.highest = highest

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if self.highest and dt == torch.float32:
            return linear_f32(x.to(dt), self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """Flax's ``nn.LayerNorm`` with float32 parameters: statistics and
    output in float32 whatever the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def _dense(cfg: BertConfig, cin: int, cout: int) -> Dense:
    return Dense(cin, cout, dtype=cfg.dtype,
                 init_std=cfg.initializer_range)


class BertSelfAttention(nn.Module):
    """Multi-head self-attention. ``query``, ``key`` and ``value`` keep
    their own parameters and run as one fused QKV product."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = _dense(cfg, h, h)
        self.key = _dense(cfg, h, h)
        self.value = _dense(cfg, h, h)

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        nh = c.num_attention_heads
        dt = c.dtype or torch.promote_types(hidden.dtype, torch.float32)
        w = torch.cat([self.query.weight, self.key.weight,
                       self.value.weight]).to(dt)             # [3h, h]
        b = torch.cat([self.query.bias, self.key.bias,
                       self.value.bias]).to(dt)
        qkv = F.linear(hidden.to(dt), w) + b
        return pair_attention(qkv, attention_bias, nh,
                              c.attention_probs_dropout_prob, deterministic,
                              generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attention_self = BertSelfAttention(cfg)
        self.attention_output = _dense(cfg, h, h)
        self.attention_norm = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.intermediate = _dense(cfg, h, cfg.intermediate_size)
        self.output = _dense(cfg, cfg.intermediate_size, h)
        self.output_norm = LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, hidden, attention_bias, deterministic=True,
                generator=None):
        p = self.cfg.hidden_dropout_prob
        attn = self.attention_self(hidden, attention_bias, deterministic,
                                   generator)
        attn = dropout(self.attention_output(attn), p, deterministic,
                       generator)
        hidden = self.attention_norm(hidden + attn)
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = dropout(self.output(inter), p, deterministic, generator)
        return self.output_norm(hidden + out)


class BertEncoder(nn.Module):
    """``num_hidden_layers`` layers named ``layer_0``, ``layer_1``, ..."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                deterministic: bool = True, raw_additive_mask: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """hidden [B, L, H]; attention_mask [B, L] (1 = attend).

        ``raw_additive_mask`` adds the 0/1 mask itself to the logits, as
        the reference TransformerHead hands it to HF's encoder (valid
        positions +1, padding +0: attention leaks to padding); otherwise
        padding gets the dtype's most negative value."""
        m = attention_mask[:, None, None, :].to(hidden.dtype)
        bias = m if raw_additive_mask else \
            (1.0 - m) * torch.finfo(hidden.dtype).min
        for i in range(self.cfg.num_hidden_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, bias,
                                                 deterministic, generator)
        return hidden


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout. The
    three tables are parameters of this module, named as in Flax. Where
    the caller never adds positions (the embeddings-only language
    backbone), ``norm=False`` builds no LayerNorm, as Flax creates
    none."""

    def __init__(self, cfg: BertConfig, norm: bool = True):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, h))
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, h))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(cfg.type_vocab_size, h))
        self.norm = LayerNorm(h, eps=cfg.layer_norm_eps) if norm else None

    def forward(self, input_ids, token_type_ids=None, deterministic=True,
                add_position: bool = True, generator=None):
        x = self.word_embeddings[input_ids.long()]
        if add_position:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            pos = torch.arange(input_ids.shape[-1], device=x.device)
            x = (x + self.position_embeddings[pos]
                 + self.token_type_embeddings[token_type_ids.long()])
            x = dropout(self.norm(x), self.cfg.hidden_dropout_prob,
                        deterministic, generator)
        return x


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[..., 0, :]))


class BertPredictionTransform(nn.Module):
    """dense + GELU + LayerNorm (HF BertPredictionHeadTransform)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg, cfg.hidden_size, cfg.hidden_size)
        self.norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden):
        return self.norm(F.gelu(self.dense(hidden), approximate="none"))


class BertLMHead(nn.Module):
    """transform + tied decoder: logits = transform(h) @ word_emb.T + b."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = BertPredictionTransform(cfg)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden, word_embeddings):
        h = self.transform(hidden)
        return h @ word_embeddings.to(h.dtype).t() + self.decoder_bias


class BertModel(nn.Module):
    """Embeddings + encoder, HF's layout. ``encoder=False`` builds the
    embeddings alone (Flax creates no encoder parameters for a model
    whose encoder never runs), and ``embeddings_norm=False`` leaves out
    the embeddings' LayerNorm, which only positions use."""

    def __init__(self, cfg: BertConfig, encoder: bool = True,
                 embeddings_norm: bool = True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, norm=embeddings_norm)
        self.encoder = BertEncoder(cfg) if encoder else None

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                deterministic=True, generator=None):
        x = self.embeddings(input_ids, token_type_ids,
                            deterministic=deterministic, generator=generator)
        return self.encoder(x, attention_mask, deterministic=deterministic,
                            generator=generator)

    def embed_only(self, input_ids, token_type_ids=None,
                   deterministic=True, add_position=True, generator=None):
        return self.embeddings(input_ids, token_type_ids,
                               deterministic=deterministic,
                               add_position=add_position,
                               generator=generator)
