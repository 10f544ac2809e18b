"""PyTorch port vs JAX: RPN anchors, head and proposal selection; the
embedding box predictor and batched fast-RCNN inference.

Tolerances: anchors and decoded boxes atol 1e-4 px (float32 at
coordinates up to ~1e3); head outputs and classifier scores rtol 1e-4
(float32 convolutions and matmuls summed in another order); keep sets,
proposal indices, classes and masks identical (the inputs to the
selection steps are the same float32 values on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import box_predictor as jbp
from locov_tpu.models import rpn as jrpn
from locov_torch.config import get_cfg as tget
from locov_torch.models import box_predictor as tbp
from locov_torch.models import rpn as trpn
from torch_parity import load_flax, n, t


def test_anchors_match_jax():
    sizes, ratios = (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
    tc = trpn.generate_cell_anchors(sizes, ratios)
    jc = jrpn.generate_cell_anchors(sizes, ratios)
    np.testing.assert_allclose(n(tc), n(jc), atol=1e-5)
    for offset in (0.0, 0.5):
        np.testing.assert_allclose(
            n(trpn.grid_anchors(tc, 5, 7, 16, offset)),
            n(jrpn.grid_anchors(jc, 5, 7, 16, offset)), atol=1e-4)


def test_rpn_head_matches_flax(rng):
    x = rng.randn(2, 6, 9, 32).astype(np.float32)
    jm = jrpn.RPNHead(num_anchors=15, conv_dim=32,
                      compute_dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # non-zero biases, so the bias path is compared too
    v = jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    tm = load_flax(trpn.RPNHead(32, 15, 32), v)
    for got, want in zip(tm(t(x)), jm.apply(v, jnp.asarray(x))):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(n(got), n(want), rtol=1e-4,
                                   atol=1e-4 * np.abs(n(want)).max())


@pytest.mark.parametrize("pre,post", [(64, 16), (700, 100)])
def test_select_proposals_matches_jax(rng, pre, post):
    cfgs = []
    for get in (jget, tget):
        cfg = get()
        cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = pre
        cfg.MODEL.RPN.POST_NMS_TOPK_TEST = post
        cfgs.append(cfg)
    jcfg, tcfg = jrpn.RPNConfig.from_cfg(cfgs[0]), \
        trpn.RPNConfig.from_cfg(cfgs[1])
    # the port keeps the inference fields, with the JAX package's values
    assert {k: getattr(jcfg, k) for k in tcfg._fields} == tcfg._asdict()
    anchors = n(jrpn.grid_anchors(
        jrpn.generate_cell_anchors(jcfg.sizes, jcfg.aspect_ratios),
        12, 20, 16))
    b, na = 2, anchors.shape[0]
    # quantized logits: many ties at the top-k boundary
    logits = (rng.randint(0, 50, (b, na)) / 10.0).astype(np.float32)
    deltas = (rng.randn(b, na, 4) * 0.3).astype(np.float32)
    hw = np.array([[192, 320], [150, 260]], np.int32)
    got = trpn.select_proposals(t(anchors), t(logits), t(deltas), t(hw),
                                tcfg)
    want = jrpn.select_proposals(jnp.asarray(anchors), jnp.asarray(logits),
                                 jnp.asarray(deltas), jnp.asarray(hw), jcfg,
                                 training=False)
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    m = n(want.mask)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m],
                               atol=1e-4)
    np.testing.assert_array_equal(n(got.objectness)[m],
                                  n(want.objectness)[m])


def _pcfgs(**over):
    out = []
    for get in (jget, tget):
        cfg = get()
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 6
        cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = True
        cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 16
        cfg.TEST.DETECTIONS_PER_IMAGE = 20
        for k, v in over.items():
            setattr(cfg.MODEL.ROI_BOX_HEAD, k, v)
        out.append(cfg)
    return jbp.BoxPredictorConfig.from_cfg(out[0]), \
        tbp.BoxPredictorConfig.from_cfg(out[1])


@pytest.mark.parametrize("over", [
    {}, {"NORMALIZE_EMB_PRED": True}, {"STANDARDIZE_EMB_PRED": True},
    # no emb_pred: the features are scored as they are, not normalized
    {"EMBEDDING_BASED": False, "NORMALIZE_EMB_PRED": True}])
def test_embedding_predictor_matches_flax(rng, over):
    jp, tp = _pcfgs(**over)
    x = rng.randn(2, 30, 64).astype(np.float32)
    ce = rng.randn(7, 16 if tp.embedding_based else 64).astype(np.float32)
    jm = jbp.EmbeddingBoxPredictor(jp)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ce))
    tm = load_flax(tbp.EmbeddingBoxPredictor(64, tp), v)
    for got, want in zip(tm(t(x), t(ce)),
                         jm.apply(v, jnp.asarray(x), jnp.asarray(ce))):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-4,
                                   atol=1e-4 * np.abs(n(want)).max())


@pytest.mark.parametrize("nprop", [40, 300])
def test_fast_rcnn_inference_matches_jax(rng, nprop):
    # 300 proposals x 6 classes = 1800 candidates: the compacted NMS path
    jp, tp = _pcfgs()
    b = 2
    lo = rng.uniform(0, 200, (b, nprop, 2))
    props = np.concatenate([lo, lo + rng.uniform(5, 90, (b, nprop, 2))],
                           -1).astype(np.float32)
    scores = (rng.randn(b, nprop, 7) * 2).astype(np.float32)
    deltas = (rng.randn(b, nprop, 4) * 0.5).astype(np.float32)
    mask = rng.rand(b, nprop) > 0.1
    hw = np.array([[240, 250], [180, 300]], np.int32)
    got = tbp.fast_rcnn_inference_batched(t(scores), t(deltas), t(props),
                                          t(mask), t(hw), tp)
    want = jbp.fast_rcnn_inference_batched(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(props),
        jnp.asarray(mask), jnp.asarray(hw), jp)
    m = n(want.mask)
    assert m.sum() > 10
    np.testing.assert_array_equal(n(got.mask), m)
    np.testing.assert_array_equal(n(got.classes)[m], n(want.classes)[m])
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m],
                               atol=1e-4)
