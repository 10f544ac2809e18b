"""PyTorch port vs JAX: the attention-free ``MLPHead``
(``locov_torch/models/mmss/mlp_head.py``) alone and inside ``MMSSHeads``
(``TYPES ("GroundingHead", "MLPHead")``), at a tiny width, on the same
numpy inputs and Flax weights.

The JAX head cannot be built: its ``encode`` helper creates ``mlp_in``,
``mlp_out`` and ``mlp_norm`` on each of its two calls, and Flax refuses
the second (``NameInUseError``; pinned below). The reference here is
``FixedMLPHead``: the JAX head's code with those three modules created
once and called twice, which is what the JAX head means, built from the
JAX package's own modules (``_dense``, ``VisualEmbedding``,
``BertLMHead``, ``mean_cross_entropy``). ``MMSSHeads`` is held to JAX's
with ``FixedMLPHead`` in place of the JAX head.

Tolerances (tests/test_torch_mmss_heads.py's): outputs and losses rtol
1e-5 with atol 1e-6 times the largest |value|; gradients within 1e-4 of
each tensor's largest JAX value."""
from typing import Dict

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from locov_tpu.models.bert import BertLMHead, _dense
from locov_tpu.models.meta_arch import mmss_gcnn as jgcnn
from locov_tpu.models.mmss import grounding_head as jgh
from locov_tpu.models.mmss import mlp_head as jmlp
from locov_tpu.models.mmss.transformer_head import VisualEmbedding
from locov_tpu.ops.losses import mean_cross_entropy
from locov_tpu.structures import batches as jb
from locov_torch.models.meta_arch import mmss_gcnn as tgcnn
from locov_torch.models.mmss import grounding_head as tgh
from locov_torch.models.mmss import mlp_head as tmlp
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import from_flax
from test_torch_mmss_heads import (L_DIM, V_DIM, _close, _inputs, _load,
                                   _pair, _tcfgs)
from torch_parity import flat_params, n, t


class FixedMLPHead(jmlp.MLPHead):
    """``locov_tpu/models/mmss/mlp_head.py:MLPHead`` with its MLP block
    built once and shared by the caption and region calls."""

    @nn.compact
    def __call__(self, image, caption, word_embeddings,
                 deterministic: bool = True):
        t_ = self.tcfg
        c = t_.bert
        caption_emb = caption.encoded_tokens
        caption_mask = caption.attention_mask.astype(jnp.float32)
        target_ids = jnp.where(caption.mlm_mask > 0, caption.target_ids,
                               -1)
        b = caption_mask.shape[0]
        if self.external_projection:
            image_emb = image.features
        else:
            image_emb = nn.Dense(self.l_dim, name="v2l_projection")(
                image.features)
        image_emb = VisualEmbedding(c, name="visual_emb")(
            image_emb, image.loc, deterministic)
        region_mask = image.mask.astype(jnp.float32)
        mlp_in = _dense(c, c.intermediate_size, "mlp_in")
        mlp_out = _dense(c, c.hidden_size, "mlp_out")
        mlp_norm = nn.LayerNorm(epsilon=c.layer_norm_eps, name="mlp_norm")

        def encode(tokens):
            h = nn.gelu(mlp_in(tokens), approximate=False)
            return mlp_norm(mlp_out(h) + tokens)

        seq_t = encode(caption_emb)
        seq_v = encode(image_emb)
        losses: Dict[str, jnp.ndarray] = {}
        other: Dict[str, jnp.ndarray] = {}
        lm_logits = BertLMHead(c, name="predictions")(seq_t,
                                                      word_embeddings)
        losses["Masked Language Modeling Loss"] = mean_cross_entropy(
            lm_logits, target_ids, ignore_index=-1)
        acc_num = ((lm_logits.argmax(-1) == target_ids)
                   & (target_ids >= 0)).sum().astype(jnp.float32)
        acc_den = (target_ids >= 0).sum().astype(jnp.float32)
        other["Masked Language Modeling Accuracy"] = jnp.where(
            acc_den > 0, acc_num / jnp.maximum(acc_den, 1.0), 0.0)
        if t_.mmm_loss == "cross_entropy":
            cap_pool = (seq_t * caption_mask[..., None]).sum(1) / \
                jnp.maximum(caption_mask.sum(1, keepdims=True), 1.0)
            img_pool = (seq_v * region_mask[..., None]).sum(1) / \
                jnp.maximum(region_mask.sum(1, keepdims=True), 1.0)
            score = _dense(c, c.hidden_size, "match_proj")(cap_pool)
            pw_cost = -jnp.einsum("cd,id->ci", score, img_pool,
                                  precision=jax.lax.Precision.HIGHEST)
            lc = jax.nn.log_softmax(-pw_cost, axis=0)
            li = jax.nn.log_softmax(-pw_cost, axis=1)
            losses["Image Caption Matching Loss"] = (
                -jnp.diagonal(lc).mean() - jnp.diagonal(li).mean())
            arange = jnp.arange(b)
            other["Batch Accuracy (Choose Caption)"] = \
                (pw_cost.argmin(axis=0) == arange).mean()
            other["Batch Accuracy (Choose Image)"] = \
                (pw_cost.argmin(axis=1) == arange).mean()
        else:
            pw_cost = None
            losses["Image Caption Matching Loss"] = jnp.float32(0.0)
        if t_.return_dist:
            return other, losses, {"trans": pw_cost}
        return other, losses


def _nonzero(v):
    """Nonzero biases (Flax initialises them to 0), so that a bias that
    went missing would show."""
    return jax.tree.map(lambda x: x + 0.05 * jnp.cos(
        jnp.arange(x.size).reshape(x.shape)), v)


def test_jax_mlp_head_cannot_be_built(rng):
    """The JAX package's head as it is: the second ``encode`` call's
    modules clash with the first's."""
    jcfg, _ = _tcfgs()
    a = _inputs(rng, V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    jm = jmlp.MLPHead(jcfg, V_DIM, L_DIM)
    with pytest.raises(flax.errors.NameInUseError, match="mlp_in"):
        jm.init(jax.random.PRNGKey(0), ji, jc, jnp.asarray(a["word"]))


@pytest.mark.parametrize("external,over", [
    (True, {}), (False, {}), (True, {"mmm_loss": ""}),
    (False, {"return_dist": False})],
    ids=["tied", "own_projection", "no_matching", "no_dist"])
def test_mlp_head_matches_jax(rng, external, over):
    over = dict(over)
    dist = over.pop("return_dist", True)
    jcfg, tcfg = (c._replace(return_dist=dist) for c in _tcfgs(**over))
    a = _inputs(rng, L_DIM if external else V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    word = jnp.asarray(a["word"])
    jm = FixedMLPHead(jcfg, V_DIM, L_DIM, external_projection=external)
    v = _nonzero(jm.init(jax.random.PRNGKey(2), ji, jc, word))
    tm = _load(tmlp.MLPHead(tcfg, V_DIM, L_DIM,
                            external_projection=external), v)
    keys = set(tm.state_dict())
    assert keys == set(from_flax(flat_params(v)))
    assert {"mlp_in.weight", "mlp_out.weight", "mlp_norm.weight"} <= keys
    assert ("match_proj.weight" in keys) == (over.get("mmm_loss") != "")

    def jloss(p):
        res = jm.apply(p, ji, jc, word)
        total = sum(jax.tree.leaves(res[1]))
        if len(res) > 2 and res[2]["trans"] is not None:
            total = total + res[2]["trans"].sum()
        return total, res

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v)
    got = tm(ti, tc, t(a["word"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if w[k] is None:
                assert g[k] is None
                continue
            _close(g[k].detach(), w[k], err_msg=k)
    total = sum(got[1][k] for k in sorted(got[1]))
    if len(got) > 2 and got[2]["trans"] is not None:
        total = total + got[2]["trans"].sum()
    total.backward()
    want_g = from_flax(flat_params(jgrads))
    for name, p in tm.named_parameters():
        w = n(want_g[name])
        if not np.abs(w).max() > 0:  # no loss reads the regions
            assert p.grad is None or not p.grad.abs().max() > 0, name
            continue
        assert np.abs(n(p.grad) - w).max() <= 1e-4 * np.abs(w).max(), name


def test_mmss_heads_with_the_mlp_head_match_jax(rng, monkeypatch):
    """``MMSSHeads`` of ``("GroundingHead", "MLPHead")`` with the tied
    projection, one group and two (``image2``: the MLP head runs a group
    at a time), against JAX's ``MMSSHeads`` with ``FixedMLPHead``."""
    monkeypatch.setattr(jmlp, "MLPHead", FixedMLPHead)
    jcfg, tcfg = _tcfgs()
    types = ("GroundingHead", "MLPHead")
    a = _inputs(rng, V_DIM)
    b = _inputs(rng, V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    ji2, ti2 = _pair(b, jnp.asarray, jb)[0], _pair(b, t, tb)[0]
    word = jnp.asarray(a["word"])
    jgcfg = jgh.GroundingConfig(return_dist=True)
    jm = jgcnn.MMSSHeads(types, "GroundingHead", True, jgcfg, jcfg, V_DIM,
                         L_DIM)
    key = jax.random.PRNGKey(3)
    v = _nonzero(jm.init(key, ji, jc, word, key))
    tm = _load(tgcnn.MMSSHeads(types, True,
                               tgh.GroundingConfig(return_dist=True), tcfg,
                               V_DIM, L_DIM), v)
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "v2l_projection", "mlp_head"}
    want = jm.apply(v, ji, jc, word, key, image2=ji2, rng2=key)
    got = tm(ti, tc, t(a["word"]), image2=ti2)
    assert len(got) == len(want) == 2
    for gg, wg in zip(got, want):
        for g, w in zip(gg, wg):
            assert set(g) == set(w)
            for k in w:
                _close(g[k].detach(), w[k], err_msg=k)
    single = tm(ti, tc, t(a["word"]))
    for g, w in zip(single, got[0]):
        for k in w:
            _close(g[k].detach(), w[k].detach(), err_msg=k)
