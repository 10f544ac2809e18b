"""PyTorch port vs JAX: the multi-token grounding box predictor
(``locov_torch/models/box_emb_grounding.py``:
``ClassTokenEmbeddings``, ``grounding_class_scores``,
``EmbeddingGroundingBoxPredictor``) alone and in the tiny ``OvrRCNN``
(``ROI_BOX_HEAD.NAME`` "EmbeddingGroundingFastRCNNOutputLayers"), on the
same numpy inputs and Flax weights.

Tolerances: scores, deltas and their gradients rtol 1e-5 with atol 1e-6
times the largest |value| (tests/test_torch_mmss_heads.py's bound: one
float32 product summed in another order); ``from_ragged`` exact. The STT
model (tests/test_torch_train_step.py's tiny model, RPN tamed, FREEZE_AT
2) with multi-token class embeddings: the loss dict rtol 1e-4, the
gradients of the chosen parameters within 1e-3 of each tensor's largest
JAX value, and inference boxes within 1e-3 px and scores within 1e-5
(that file's and tests/test_torch_lsm_step.py's bounds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import box_emb_grounding as jbeg
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.models import box_emb_grounding as tbeg
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.models.box_predictor import (BoxPredictorConfig,
                                              EmbeddingBoxPredictor)
from locov_torch.utils.weights import from_flax
from test_torch_mmss_heads import _close
from test_torch_train_step import _batch, _cfg, _torch_grads, loss_uniforms
from torch_parity import flat_params, n, t

NAME = "EmbeddingGroundingFastRCNNOutputLayers"


def _tokens(rng, k=6, d=8, t_max=3):
    """K + 1 classes (the last the background) of 1 .. t_max tokens."""
    per_class = [(rng.randn(rng.randint(1, t_max + 1), d) * 0.5)
                 .astype(np.float32) for _ in range(k - 1)]
    return per_class, jbeg.ClassTokenEmbeddings.from_ragged(per_class, d), \
        tbeg.ClassTokenEmbeddings.from_ragged(per_class, d)


def test_from_ragged_is_jaxs(rng):
    per_class, jct, tct = _tokens(rng, k=7, d=5, t_max=4)
    np.testing.assert_array_equal(n(tct.tokens), np.asarray(jct.tokens))
    np.testing.assert_array_equal(n(tct.mask), np.asarray(jct.mask))
    assert tct.mask[-1].tolist() == [1.0] + [0.0] * (tct.mask.shape[1] - 1)
    assert not bool(tct.tokens[-1].any())
    want = jbeg.ClassTokenEmbeddings.from_ragged(per_class, 5,
                                                 background_class=False)
    got = tbeg.ClassTokenEmbeddings.from_ragged(per_class, 5,
                                                background_class=False)
    np.testing.assert_array_equal(n(got.mask), np.asarray(want.mask))


@pytest.mark.parametrize("metric,alignment,normalize", [
    ("dot", "softmax", False), ("dot", "hardmax", False),
    ("cosine", "softmax", False), ("dot", "softmax", True)],
    ids=["dot_softmax", "dot_hardmax", "cosine", "normalized"])
def test_grounding_class_scores_match_jax(rng, metric, alignment,
                                          normalize):
    _, jct, tct = _tokens(rng)
    emb = rng.randn(9, 8).astype(np.float32)

    def jfn(e, toks):
        return jbeg.grounding_class_scores(
            e, jct._replace(tokens=toks), metric, alignment, 2.0,
            normalize)
    want = jfn(jnp.asarray(emb), jct.tokens)
    jge, jgt = jax.grad(lambda e, k: (jfn(e, k) * jnp.arange(6.0)).sum(),
                        argnums=(0, 1))(jnp.asarray(emb), jct.tokens)
    e = t(emb).requires_grad_(True)
    toks = tct.tokens.clone().requires_grad_(True)
    got = tbeg.grounding_class_scores(e, tct._replace(tokens=toks), metric,
                                      alignment, 2.0, normalize)
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    _close(got.detach(), want)
    (got * torch.arange(6.0)).sum().backward()
    _close(e.grad, jge, rtol=1e-5)
    if metric == "dot":
        # cosine normalises the zero background token: JAX's gradient of
        # the norm at 0 is NaN there, PyTorch's 0 (class tokens are
        # constants in the models)
        _close(toks.grad, jgt, rtol=1e-5)


@pytest.mark.parametrize("detach", [False, True], ids=["live", "detached"])
def test_predictor_matches_jax(rng, detach):
    _, jct, tct = _tokens(rng)
    x = rng.randn(2, 7, 32).astype(np.float32)
    jm = jbeg.EmbeddingGroundingBoxPredictor(
        emb_dim=8, temperature=10.0, detach_cls_predictor=detach)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jct)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.cos(
        jnp.arange(a.size).reshape(a.shape)), v)
    tm = tbeg.EmbeddingGroundingBoxPredictor(
        32, 8, temperature=10.0, detach_cls_predictor=detach)
    tm.load_state_dict(from_flax(flat_params(v)), strict=True)

    def jloss(p, xx):
        s, d = jm.apply(p, xx, jct)
        return (s * jnp.arange(6.0)).sum() + (d ** 2).sum(), (s, d)
    (_, (ws, wd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v, jnp.asarray(x))
    xx = t(x).requires_grad_(True)
    s, d = tm(xx, tct)
    assert s.shape == (2, 7, 6) and d.shape == (2, 7, 4)
    _close(s.detach(), ws)
    _close(d.detach(), wd)
    ((s * torch.arange(6.0)).sum() + (d ** 2).sum()).backward()
    _close(xx.grad, jgx, rtol=1e-5)
    want_g = from_flax(flat_params(jgp))
    for name, p in tm.named_parameters():
        w = n(want_g[name])
        if not np.abs(w).max() > 0:  # detached: emb_pred gets nothing
            assert detach and name.startswith("emb_pred")
            assert p.grad is None or not p.grad.abs().max() > 0
            continue
        _close(p.grad, w, rtol=1e-5, err_msg=name)


def test_single_tokens_score_as_the_embedding_predictor(rng):
    """A [K+1, D] matrix is wrapped as one token a class
    (``ClassTokenEmbeddings.single_token``, as JAX's ``predict`` wraps
    it): at temperature 1 the scores are the embedding predictor's dot
    products, with the same weights."""
    ce = (rng.randn(6, 8) * 0.5).astype(np.float32)
    x = t(rng.randn(5, 32).astype(np.float32))
    tm = tbeg.EmbeddingGroundingBoxPredictor(32, 8, temperature=1.0)
    torch.nn.init.normal_(tm.emb_pred.weight)
    pcfg = BoxPredictorConfig(
        emb_dim=8, embedding_based=True, normalize_emb=False,
        standardize_emb=False, detach_cls_predictor=False,
        bbox_reg_weights=(10., 10., 5., 5.), smooth_l1_beta=0.0,
        box_reg_loss_type="smooth_l1", box_reg_loss_weight=1.0,
        test_score_thresh=0.0, test_nms_thresh=0.5, test_topk_per_image=10)
    plain = EmbeddingBoxPredictor(32, pcfg)
    plain.load_state_dict(tm.state_dict())
    s1, d1 = tm(x, tbeg.ClassTokenEmbeddings.single_token(t(ce)))
    s0, d0 = plain(x, t(ce))
    _close(s1.detach(), s0.detach())
    assert torch.equal(d1, d0)


@pytest.fixture(scope="module")
def stt():
    """The tiny STT model with the grounding predictor, JAX's weights,
    losses and gradients, on class names of 1 .. 4 tokens."""
    rng = np.random.RandomState(0)
    jb, tb = _batch(rng)
    per_class = [(rng.randn(rng.randint(1, 5), 8) * 0.1).astype(np.float32)
                 for _ in range(5)]
    jct = jbeg.ClassTokenEmbeddings.from_ragged(per_class, 8)
    tct = tbeg.ClassTokenEmbeddings.from_ragged(per_class, 8)
    extra = {"MODEL.ROI_BOX_HEAD.NAME": NAME,
             "MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE": 1.0}
    jm = jbuild(_cfg(jget, 2, **extra))
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jb, jct, key)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}

    def loss_fn(p):
        losses = jm.apply(p, jb, jct, key, method=jm.losses)
        return sum(jax.tree.leaves(losses)), losses
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(v)
    dets = jax.jit(lambda p, b, c: jm.apply(p, b, c,
                                            method=jm.inference))(v, jb, jct)
    tm = tbuild(_cfg(tget, 2, **extra), device="cpu")
    tm.load_state_dict(from_flax(flat), strict=True)
    return dict(tm=tm, tb=tb, tct=tct, key=key, losses=losses, grads=grads,
                dets=dets, ntok=int(np.asarray(jct.mask).sum(1).max()))


def test_stt_step_with_the_grounding_predictor_matches_jax(stt):
    tm = stt["tm"]
    assert isinstance(tm.roi_heads.box_predictor,
                      tbeg.EmbeddingGroundingBoxPredictor)
    assert stt["ntok"] > 1
    losses = tm.losses(stt["tb"], stt["tct"],
                       uniforms=loss_uniforms(stt["key"]))
    assert set(losses) == set(stt["losses"])
    for k, w in stt["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), float(w),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    sum(losses[k] for k in sorted(losses)).backward()
    want = _torch_grads(stt["grads"])
    for name in ("roi_heads.box_predictor.emb_pred.weight",
                 "roi_heads.box_predictor.bbox_pred.weight",
                 "roi_heads.res5.2.conv3.weight",
                 "backbone.res4.0.conv2.weight"):
        w = n(want[name])
        assert np.abs(w).max() > 0, name
        p = dict(tm.named_parameters())[name]
        assert np.abs(n(p.grad) - w).max() <= 1e-3 * np.abs(w).max(), name


def test_stt_inference_with_the_grounding_predictor_matches_jax(stt):
    want = stt["dets"]
    got = stt["tm"].inference(stt["tb"], stt["tct"])
    m = n(want.mask)
    assert m.sum() > 0 and (n(got.mask) == m).all()
    assert (n(got.classes)[m] == n(want.classes)[m]).all()
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], atol=1e-3)
    np.testing.assert_allclose(n(got.scores), n(want.scores), atol=1e-5)
