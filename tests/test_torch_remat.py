"""PyTorch port: rematerialisation (``TPU.REMAT_BACKBONE``,
``locov_torch/models/resnet.py``) and the chunked pair encoder
(``TPU.PAIRWISE_CHUNK``, ``models/mmss/transformer_head.py`` through
``models/bert.py:remat``).

- The remat trunk's gradients (parameters and input) against JAX's
  ``ResNetC4(remat=True)``, within 1e-4 of each tensor's largest JAX
  value (float32 convolutions summed in another order, as in
  tests/test_torch_resnet.py), and against the port's trunk without
  remat within 1e-6 (the recompute repeats the forward's arithmetic);
  only the stages that train are checkpointed, and nothing is without
  gradients or under ``inference_mode``.
- The generator trap: ``torch.utils.checkpoint`` restores the global RNG
  states for its recompute, never an explicit ``torch.Generator``, from
  which the port's dropout draws. With dropout live (0.1) and a seeded
  generator, the chunked head's gradients under ``remat`` equal the
  same chunking's without a checkpoint within 1e-6, and under a bare
  checkpoint they do not (the recompute draws other masks); the
  generator ends where the forward left it. The same holds for the
  tiny image-caption model with the remat trunk and the chunked head
  (``losses`` of the training step, every parameter's gradient).
The chunked head against JAX's chunked head (forward and gradients,
deterministic) is a case of tests/test_torch_mmss_heads.py's
``test_transformer_head_matches_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from locov_tpu.models import resnet as jres
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.models import bert as tbert
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.models import resnet as tres
from locov_torch.models.mmss import transformer_head as tth
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import seeded_init_
from test_torch_mmss_heads import L_DIM, V_DIM, _inputs, _pair
from torch_parity import (TINY_BERT, lsm_batch, load_flax, n, t,
                          tiny_lsm_arrays, tiny_lsm_cfg)

KW = dict(out_features=("res4",), stem_out_channels=8,
          res2_out_channels=32, width_per_group=8)
DROPOUT = {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}


def _direct(fn, *args, generator=None):
    """``bert.remat`` without the checkpoint: the same chunks, kept."""
    return fn(*args)


def _bare(fn, *args, generator=None):
    """A checkpoint that knows nothing of the generator."""
    return checkpoint(fn, *args, use_reentrant=False)


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None}


def test_remat_trunk_gradients_match_jax(rng):
    x = rng.randn(2, 64, 48, 3).astype(np.float32) * 50
    g_out = rng.randn(2, 4, 3, 128).astype(np.float32)
    jm = jres.ResNetC4(compute_dtype=jnp.float32, remat=True, **KW)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))

    def jloss(p, xx):
        return (jm.apply(p, xx)["res4"] * jnp.asarray(g_out)).sum()
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(v, jnp.asarray(x))
    from torch_parity import flat_params
    from locov_torch.utils.weights import from_flax
    want = from_flax(flat_params(jg))

    got = {}
    for remat in (True, False):
        tm = load_flax(tres.ResNetC4(remat=remat, **KW), v)
        xt = t(x).requires_grad_(True)
        (tm(xt)["res4"] * t(g_out)).sum().backward()
        got[remat] = (_grads(tm), xt.grad)
    assert set(got[True][0]) == {k for k in want if "norm" not in k}
    for k, g in got[True][0].items():
        scale = np.abs(n(want[k])).max()
        assert np.abs(n(g) - n(want[k])).max() <= 1e-4 * scale, k
        assert (g - got[False][0][k]).abs().max() <= 1e-6 * scale, k
    scale = np.abs(n(jgx)).max()
    assert np.abs(n(got[True][1]) - n(jgx)).max() <= 1e-4 * scale


@pytest.mark.parametrize("freeze_at,stages", [(0, 3), (2, 2)])
def test_remat_checkpoints_the_training_stages_only(monkeypatch,
                                                   freeze_at, stages):
    calls = []

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return checkpoint(fn, *args, **kwargs)
    monkeypatch.setattr(tres, "checkpoint", counting)
    tm = tres.ResNetC4(remat=True, freeze_at=freeze_at, **KW)
    x = torch.randn(1, 32, 32, 3)
    with torch.inference_mode():
        tm(x)
    with torch.no_grad():
        tm(x)
    assert calls == []
    tm(x)["res4"].sum().backward()
    assert calls == [getattr(tm, s) for s in ("res2", "res3", "res4")
                     ][3 - stages:]


def _live_head(rng, chunk):
    tcfg = tth.TransformerHeadConfig(
        bert=tbert.BertConfig(**{**TINY_BERT, **DROPOUT}), return_dist=True,
        pairwise_chunk=chunk)
    torch.manual_seed(0)
    tm = seeded_init_(tth.TransformerHead(tcfg, V_DIM, L_DIM,
                                          external_projection=True), 0)
    a = _inputs(rng, L_DIM)
    image, caption = _pair(a, t, tb)
    return tm, image, caption, t(a["word"])


def _head_run(tm, image, caption, word, seed):
    gen = torch.Generator().manual_seed(seed)
    tm.zero_grad()
    feats = image.features.clone().requires_grad_(True)
    out = tm(image._replace(features=feats), caption, word,
             deterministic=False, generator=gen)
    (sum(out[1][k] for k in sorted(out[1])) + out[2]["trans"].sum()
     ).backward()
    return _grads(tm), feats.grad, gen.get_state()


def test_chunked_head_remat_keeps_the_dropout_masks(rng, monkeypatch):
    tm, image, caption, word = _live_head(rng, chunk=3)  # 9 pairs, 3 chunks
    got, gx, state = _head_run(tm, image, caption, word, seed=5)
    monkeypatch.setattr(tth, "remat", _direct)
    want, wx, want_state = _head_run(tm, image, caption, word, seed=5)
    assert torch.equal(state, want_state)
    for k, w in want.items():
        assert (got[k] - w).abs().max() <= 1e-6 * w.abs().max(), k
    assert (gx - wx).abs().max() <= 1e-6 * wx.abs().max()
    # the trap: a checkpoint that redraws the masks gives other gradients
    monkeypatch.setattr(tth, "remat", _bare)
    bare, _, _ = _head_run(tm, image, caption, word, seed=5)
    k = "encoder.layer_0.intermediate.weight"
    assert (bare[k] - want[k]).abs().max() > 1e-3 * want[k].abs().max()


def test_lsm_remat_and_chunk_keep_the_gradients(monkeypatch):
    """The tiny image-caption model's training-step losses with dropout
    live: REMAT_BACKBONE and PAIRWISE_CHUNK 2 (2 chunks of the 2 x 2
    pairs) against the same chunking without any checkpoint."""
    bert = "MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG."
    extra = {bert + k: v for k, v in DROPOUT.items()}
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    batch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                      tb.DetectionBatch, t)
    out = []
    for remat in (True, False):
        cfg = tiny_lsm_cfg(tget, tpath, **extra, **{
            "TPU.REMAT_BACKBONE": remat, "TPU.PAIRWISE_CHUNK": 2})
        tm = seeded_init_(tbuild(cfg, device="cpu"), 0)
        if not remat:
            monkeypatch.setattr(tth, "remat", _direct)
        assert tm.backbone.remat is remat
        gen = torch.Generator().manual_seed(3)
        _, losses = tm.losses(batch, t(arrays["class_emb"]), gen,
                              deterministic=False)
        sum(losses[k] for k in sorted(losses)).backward()
        out.append((losses, _grads(tm)))
    (lr, gr), (lp, gp) = out
    for k in lp:
        assert torch.equal(lr[k], lp[k]), k
    assert set(gr) == set(gp) and len(gp) > 100
    for k, w in gp.items():
        assert (gr[k] - w).abs().max() <= 1e-6 * max(float(w.abs().max()),
                                                      1e-12), k
