"""PyTorch port vs JAX: BERT (``locov_torch/models/bert.py``) and the
language backbones (``locov_torch/models/language.py``), at a tiny width
(hidden 16, 2 layers, 2 heads, vocabulary 50), on the same numpy inputs
and Flax weights (``from_flax``), in float32.

Tolerance: rtol 1e-5 with atol 1e-6 times the largest |value|, or
1e-6 where that is below 1 (LayerNorm outputs of order 1, the LM head's
logits of order 10; float32 sums in another order; Flax computes the
variance as E[x^2] - E[x]^2, PyTorch in two passes); the encoder's
parameter gradients within 1e-4 of each tensor's largest JAX value.
Dropout is checked on its own: the same generator seed gives the same
mask, and the keep rate is 1 - p within five standard deviations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.models import bert as jbert
from locov_tpu.models import language as jlang
from locov_tpu.structures.batches import TextBatch as JText
from locov_torch.models import bert as tbert
from locov_torch.models import language as tlang
from locov_torch.structures.batches import TextBatch as TText
from locov_torch.utils.weights import from_flax
from torch_parity import TINY_BERT, flat_params, n, t

RTOL, ATOL = 1e-5, 1e-6
JCFG = jbert.BertConfig(**TINY_BERT)
TCFG = tbert.BertConfig(**TINY_BERT)


def _close(got, want, err_msg=""):
    want = n(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(n(got), want, rtol=RTOL, atol=atol,
                               err_msg=err_msg)


def _load(module, variables):
    module.load_state_dict(from_flax(flat_params(variables)), strict=True)
    return module


def _mask(b, length, valid):
    m = np.zeros((b, length), np.int32)
    for i, v in enumerate(valid):
        m[i, :v] = 1
    return m


def _text(rng, b=3, length=8):
    ids = rng.randint(1, 50, (b, length)).astype(np.int32)
    attn = _mask(b, length, [8, 6, 3])
    special = np.zeros_like(attn)
    special[:, 0] = 1
    mlm = np.zeros_like(attn)
    mlm[0, 2] = 1
    return ids, attn, special, mlm


@pytest.mark.parametrize("raw", [True, False], ids=["raw_mask", "min_mask"])
def test_encoder_matches_jax(rng, raw):
    """Both mask modes: the raw 0/1 mask added to the logits (the joint
    encoder's) and (1 - m) * min (BERT's own)."""
    hidden = rng.randn(3, 7, 16).astype(np.float32)
    mask = _mask(3, 7, [7, 5, 2])
    jm = jbert.BertEncoder(JCFG)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(hidden),
                jnp.asarray(mask), True, raw)
    want = jm.apply(v, jnp.asarray(hidden), jnp.asarray(mask), True, raw)
    tm = _load(tbert.BertEncoder(TCFG), v)
    assert set(tm.state_dict()) == set(from_flax(flat_params(v)))
    got = tm(t(hidden), t(mask), raw_additive_mask=raw)
    _close(got, want)
    # the two modes differ where a row has padding
    other = tm(t(hidden), t(mask), raw_additive_mask=not raw)
    assert not np.allclose(n(other)[1:], n(got)[1:], atol=1e-3)


def test_encoder_gradients_match_jax(rng):
    hidden = rng.randn(2, 6, 16).astype(np.float32)
    mask = _mask(2, 6, [6, 4])
    r = rng.randn(2, 6, 16).astype(np.float32)
    jm = jbert.BertEncoder(JCFG)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(hidden),
                jnp.asarray(mask), True, True)
    g = jax.grad(lambda p: (jm.apply(p, jnp.asarray(hidden),
                                     jnp.asarray(mask), True, True)
                            * r).sum())(v)
    want = from_flax(flat_params(g))
    tm = _load(tbert.BertEncoder(TCFG), v)
    (tm(t(hidden), t(mask), raw_additive_mask=True) * t(r)).sum().backward()
    for name, p in tm.named_parameters():
        w = n(want[name])
        scale = np.abs(w).max()
        if name.endswith("key.bias"):  # softmax ignores a row's shift
            assert max(scale, float(p.grad.abs().max())) < 1e-6
            continue
        assert np.abs(n(p.grad) - w).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("add_position", [False, True])
def test_embeddings_match_jax(rng, add_position):
    ids = rng.randint(1, 50, (3, 8)).astype(np.int32)
    types = rng.randint(0, 2, (3, 8)).astype(np.int32)
    jm = jbert.BertModel(JCFG)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(types),
                method=jm.embed_only)
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(types), True,
                    add_position, method=jm.embed_only)
    tm = tbert.BertModel(TCFG, encoder=False)
    _load(tm, v)
    got = tm.embed_only(t(ids), t(types), add_position=add_position)
    _close(got, want)


def test_bert_model_pooler_and_lm_head_match_jax(rng):
    ids, attn, _, _ = _text(rng)
    jm = jbert.BertModel(JCFG)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(attn))
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(attn))
    tm = _load(tbert.BertModel(TCFG), v)
    got = tm(t(ids), t(attn))
    _close(got, want)

    hidden = n(want)
    word = rng.randn(50, 16).astype(np.float32)
    for jcls, tcls, args in (
            (jbert.BertPooler, tbert.BertPooler, (hidden,)),
            (jbert.BertLMHead, tbert.BertLMHead, (hidden, word))):
        jh = jcls(JCFG)
        vh = jh.init(jax.random.PRNGKey(4), *map(jnp.asarray, args))
        vh = jax.tree.map(lambda a: a + 0.1, vh)  # nonzero biases
        th = _load(tcls(TCFG), vh)
        _close(th(*map(t, args)), jh.apply(vh, *map(jnp.asarray, args)))


@pytest.mark.parametrize("kind,add_position", [
    ("build_bertemb_backbone", False), ("build_bertemb_backbone", True),
    ("build_bert_backbone", False)])
def test_language_backbones_match_jax(rng, kind, add_position):
    """The caption features and the parameter key sets: the
    embeddings-only type builds no encoder, and no LayerNorm without
    positions, as Flax creates none."""
    ids, attn, special, mlm = _text(rng)
    kw = {"add_position_embedding": add_position} \
        if kind == "build_bertemb_backbone" else {}
    jm = jlang.LANGUAGE_BACKBONES[kind](bert_cfg=JCFG, **kw)
    jt = JText(*map(jnp.asarray, (ids, attn, special, ids, mlm)))
    v = jm.init(jax.random.PRNGKey(5), jt)
    want = jm.apply(v, jt)
    tm = tlang.LANGUAGE_BACKBONES[kind](bert_cfg=TCFG, **kw)
    assert set(tm.state_dict()) == set(from_flax(flat_params(v)))
    _load(tm, v)
    got = tm(TText(*map(t, (ids, attn, special, ids, mlm))))
    for field in ("encoded_tokens", "input_embeddings"):
        _close(getattr(got, field), getattr(want, field), field)
    assert (n(got.mlm_mask) == mlm).all()
    assert got.asdict()["input_ids"] is got.input_ids
    keys = set(tm.state_dict())
    if kind == "build_bertemb_backbone":
        assert not any(".encoder." in k for k in keys)
        assert ("bert_model.embeddings.norm.weight" in keys) == add_position
    assert torch.equal(tm.word_embedding_matrix(),
                       tm.bert_model.embeddings.word_embeddings)


def test_build_language_backbone_is_full_size_bert():
    from locov_torch.config import config_path, get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    m = tlang.build_language_backbone(cfg)
    assert isinstance(m, tlang.BertEmbeddingBackbone)
    assert tuple(m.word_embedding_matrix().shape) == (30522, 768)


def test_dropout_draws_from_the_generator():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(7)
    a = tbert.dropout(x, 0.1, False, gen)
    b = tbert.dropout(x, 0.1, False, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) <= 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert tbert.dropout(x, 0.1, True, gen) is x
    assert tbert.dropout(x, 0.0, False, gen) is x
    # the attention's dropout draws one [B, heads, L, L] block of
    # uniforms, after nothing else, on either route
    att = tbert.BertSelfAttention(TCFG._replace(
        attention_probs_dropout_prob=0.1))
    gen = torch.Generator().manual_seed(7)
    att(torch.randn(3, 5, 16), torch.zeros(3, 1, 1, 5), False, gen)
    want = torch.Generator().manual_seed(7)
    torch.rand((3, 2, 5, 5), generator=want)
    assert torch.equal(gen.get_state(), want.get_state())
    att(torch.randn(3, 5, 16), torch.zeros(3, 1, 1, 5), True, gen)
    assert torch.equal(gen.get_state(), want.get_state())
