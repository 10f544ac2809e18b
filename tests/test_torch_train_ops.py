"""PyTorch port vs JAX: the training ops of the detector. RPN losses,
proposal selection at the training top-k, gt appended to proposals,
ROI labelling and sampling, FastRCNN losses, and the gradients of the
two kernel ops (ROIAlign to its features, the stem's ReLU + max-pool).

Each sampler gets JAX's own uniform draws (the keys split as the JAX
function splits them), so both packages sample the same anchors and
ROIs.

Tolerances: sampled indices, labels, classes, masks and routed
positions identical; gathered boxes exact; losses rtol 1e-5 (float32
sums of a few hundred terms in another order). ROIAlign gradient, in
units of the gradient of |g| at each cell (what a float32 sum-order
error scales with): the port within 1e-6 of the float64 sum of its
interpolation matrices, and within 1e-4 of JAX, whose own float32 sums
came out up to 3.3e-5 from the float64 sum at ratio 2. ReLU + max-pool
gradient: atol 1e-6 * max|dy| (float32 sums of at most 4 terms in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import box_predictor as jbp
from locov_tpu.models import roi_heads as jrh
from locov_tpu.models import rpn as jrpn
from locov_tpu.ops import roi_align as jroi
from locov_tpu.ops.pallas_pool import relu_maxpool as pallas_relu_maxpool
from locov_tpu.ops.pallas_roi_align import roi_align_pallas
from locov_tpu.structures.batches import GtBatch as JGt
from locov_tpu.structures.batches import ProposalBatch as JProps
from locov_torch.config import get_cfg as tget
from locov_torch.models import box_predictor as tbp
from locov_torch.models import roi_heads as trh
from locov_torch.models import rpn as trpn
from locov_torch.ops import kernel_lib
from locov_torch.ops import roi_align as troi
from locov_torch.ops.relu_maxpool import relu_maxpool
from locov_torch.structures.batches import GtBatch as TGt
from locov_torch.structures.batches import ProposalBatch as TProps
from torch_parity import jax_uniforms, n, t
from test_torch_roi_align import STRIDE, _boxes, _features


def _cfgs(**over):
    out = []
    for get in (jget, tget):
        cfg = get()
        for key, value in over.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, value)
        out.append(cfg)
    return out


def _gt(rng, b=2, m=5, size=(192, 320)):
    lo = rng.uniform(0, 1, (b, m, 2)) * (np.array(size[::-1]) - 100)
    boxes = np.concatenate([lo, lo + rng.uniform(20, 100, (b, m, 2))], -1)
    mask = np.ones((b, m), bool)
    mask[1, 3:] = False
    boxes[~mask] = 0.0
    return (boxes.astype(np.float32),
            rng.randint(0, 6, (b, m)).astype(np.int32), mask)


def test_rpn_losses_match_jax(rng):
    jc, tc = (mod.RPNConfig.from_cfg(c) for mod, c in
              zip((jrpn, trpn), _cfgs()))
    assert {k: getattr(jc, k) for k in tc._fields} == tc._asdict()
    anchors = n(jrpn.grid_anchors(
        jrpn.generate_cell_anchors(jc.sizes, jc.aspect_ratios), 12, 20, 16))
    b, na = 2, anchors.shape[0]
    logits = rng.randn(b, na).astype(np.float32)
    deltas = (rng.randn(b, na, 4) * 0.3).astype(np.float32)
    boxes, classes, mask = _gt(rng)
    key = jax.random.PRNGKey(3)
    want = jrpn.rpn_losses(jnp.asarray(anchors), jnp.asarray(logits),
                           jnp.asarray(deltas),
                           JGt(jnp.asarray(boxes), jnp.asarray(classes),
                               jnp.asarray(mask)), jc, key)
    got = trpn.rpn_losses(t(anchors), t(logits), t(deltas),
                          TGt(t(boxes), t(classes), t(mask)), tc,
                          *jax_uniforms(key, b, na))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert float(got["loss_rpn_loc"]) > 0


@pytest.mark.parametrize("pre,post", [(64, 32), (3000, 2000)])
def test_select_proposals_training_matches_jax(rng, pre, post):
    jc, tc = (mod.RPNConfig.from_cfg(c) for mod, c in zip(
        (jrpn, trpn), _cfgs(**{"MODEL.RPN.PRE_NMS_TOPK_TRAIN": pre,
                               "MODEL.RPN.POST_NMS_TOPK_TRAIN": post})))
    anchors = n(jrpn.grid_anchors(
        jrpn.generate_cell_anchors(jc.sizes, jc.aspect_ratios), 12, 20, 16))
    b, na = 2, anchors.shape[0]
    logits = (rng.randint(0, 50, (b, na)) / 10.0).astype(np.float32)
    deltas = (rng.randn(b, na, 4) * 0.3).astype(np.float32)
    hw = np.array([[192, 320], [150, 260]], np.int32)
    got = trpn.select_proposals(t(anchors), t(logits), t(deltas), t(hw), tc,
                                training=True)
    want = jrpn.select_proposals(jnp.asarray(anchors), jnp.asarray(logits),
                                 jnp.asarray(deltas), jnp.asarray(hw), jc,
                                 training=True)
    assert got.boxes.shape == (b, post, 4)
    m = n(want.mask)
    np.testing.assert_array_equal(n(got.mask), m)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], atol=1e-4)
    np.testing.assert_array_equal(n(got.objectness)[m],
                                  n(want.objectness)[m])


def _proposals(rng, b=2, k=60, size=(192, 320)):
    lo = rng.uniform(0, 1, (b, k, 2)) * (np.array(size[::-1]) - 60)
    boxes = np.concatenate([lo, lo + rng.uniform(8, 120, (b, k, 2))], -1)
    return (boxes.astype(np.float32), rng.randn(b, k).astype(np.float32),
            rng.rand(b, k) > 0.15)


def test_add_gt_to_proposals_matches_jax(rng):
    pb, po, pm = _proposals(rng)
    gb, gc, gm = _gt(rng)
    got = trpn.add_gt_to_proposals(TProps(t(pb), t(po), t(pm)),
                                   TGt(t(gb), t(gc), t(gm)))
    want = jrpn.add_gt_to_proposals(
        JProps(jnp.asarray(pb), jnp.asarray(po), jnp.asarray(pm)),
        JGt(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gm)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("frac,append_gt", [(0.25, True), (1.0, True),
                                            (0.25, False)])
def test_label_and_sample_proposals_matches_jax(rng, frac, append_gt):
    over = {"MODEL.ROI_HEADS.NUM_CLASSES": 6,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
            "MODEL.ROI_HEADS.POSITIVE_FRACTION": frac,
            "MODEL.ROI_HEADS.PROPOSAL_APPEND_GT": append_gt}
    jc, tc = (mod.ROIHeadsConfig.from_cfg(c) for mod, c in
              zip((jrh, trh), _cfgs(**over)))
    pb, po, pm = _proposals(rng)
    gb, gc, gm = _gt(rng)
    # proposals near the gt, so that there are positives
    pb[:, :5] = gb[:, :5] + rng.uniform(-6, 6, (2, 5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jrh.label_and_sample_proposals(
        JProps(jnp.asarray(pb), jnp.asarray(po), jnp.asarray(pm)),
        JGt(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gm)), jc, key)
    got = trh.label_and_sample_proposals(
        TProps(t(pb), t(po), t(pm)), TGt(t(gb), t(gc), t(gm)), tc,
        *jax_uniforms(key, 2, pb.shape[1] + (5 if append_gt else 0)))
    assert n(want.is_fg).sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.parametrize("over", [
    {}, {"MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE": "giou"},
    {"MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA": 0.5,
     "MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT": 2.0},
    {"MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR": True}])
def test_fast_rcnn_losses_match_jax(rng, over):
    jc, tc = (mod.BoxPredictorConfig.from_cfg(c) for mod, c in
              zip((jbp, tbp), _cfgs(**over)))
    r, k = 64, 7
    scores = (rng.randn(r, k) * 2).astype(np.float32)
    deltas = (rng.randn(r, 4) * 0.3).astype(np.float32)
    lo = rng.uniform(0, 200, (r, 2))
    props = np.concatenate([lo, lo + rng.uniform(5, 80, (r, 2))],
                           -1).astype(np.float32)
    gtb = (props + rng.uniform(-5, 5, (r, 4))).astype(np.float32)
    cls = rng.randint(0, k, r).astype(np.int32)  # k - 1: background
    valid = rng.rand(r) > 0.2
    got = tbp.fast_rcnn_losses(t(scores), t(deltas), t(props), t(cls),
                               t(gtb), t(valid), tc)
    want = jbp.fast_rcnn_losses(*(jnp.asarray(a) for a in (
        scores, deltas, props, cls, gtb, valid)), jc)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-7)


def _roi_grad(f, bx, g, pooled, sr):
    ft = t(f).requires_grad_(True)
    bt = t(bx).requires_grad_(True)
    out = troi.roi_align_fused(ft, bt, 1 / STRIDE, pooled, sr)
    (out * t(g)).sum().backward()
    assert bt.grad is None  # the boxes get no gradient
    return n(ft.grad)


def _assert_roi_grad_close(got, want, g, bx, h, w, pooled, sr):
    bound = n(troi.roi_align_bwd_plain(t(np.abs(g)), t(bx), 1 / STRIDE, h,
                                       w, pooled, sr))
    ky, kx = (n(k).astype(np.float64) for k in troi._build_kernels(
        t(bx), 1 / STRIDE, h, w, pooled, sr))
    exact = np.einsum("bnph,bnpqc,bnqw->bhwc", ky, g.astype(np.float64), kx)
    # the port against the float64 sum of its own matrices
    assert (np.abs(got - exact) <= 1e-6 * bound + 1e-30).all()
    # against JAX: its float32 sums in its order came out up to 3.3e-5 *
    # bound from the float64 sum at ratio 2, so the bound is 1e-4
    assert (np.abs(got - want) <= 1e-4 * bound + 1e-30).all()
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("sampling_ratio", [2, 0])
def test_roi_align_gradient_matches_jax_grad(rng, sampling_ratio):
    f, bx = _features(rng, c=32), _boxes(rng)
    g = rng.randn(2, bx.shape[1], 14, 14, 32).astype(np.float32)
    got = _roi_grad(f, bx, g, 14, sampling_ratio)
    want = jax.grad(lambda x: (jroi.roi_align_batched(
        x, jnp.asarray(bx), 1 / STRIDE, 14, sampling_ratio)
        * jnp.asarray(g)).sum())(jnp.asarray(f))
    _assert_roi_grad_close(got, n(want), g, bx, 16, 24, 14, sampling_ratio)


def test_roi_align_gradient_matches_pallas_interpret(rng):
    """K3's own semantics: the Pallas pair at a fixed ratio 2."""
    f, bx = _features(rng, c=64), _boxes(rng)
    g = rng.randn(2, bx.shape[1], 7, 7, 64).astype(np.float32)
    got = _roi_grad(f, bx, g, 7, 2)
    want = jax.grad(lambda x: (roi_align_pallas(
        x, jnp.asarray(bx), 1 / STRIDE, 7, 2, True)
        * jnp.asarray(g)).sum())(jnp.asarray(f))
    _assert_roi_grad_close(got, n(want), g, bx, 16, 24, 7, 2)


def test_degenerate_boxes_get_no_gradient(rng):
    f, bx = _features(rng, c=8), _boxes(rng)
    g = rng.randn(2, 3, 14, 14, 8).astype(np.float32)
    # zero-width, inverted and wholly outside boxes, adaptive sampling
    got = _roi_grad(f, np.ascontiguousarray(bx[:, [2, 3, 5]]), g, 14, 0)
    assert (got == 0).all()


def _pool_cases(rng):
    # the tie-heavy inputs of tests/test_pallas_pool.py
    smooth = rng.randn(2, 32, 20, 8).astype(np.float32)
    tied = rng.randint(-2, 3, size=(2, 48, 12, 8)).astype(np.float32)
    quant = np.asarray(
        jnp.asarray(rng.randn(1, 16, 64, 16).astype(np.float32) * 1e-2)
        .astype(jnp.bfloat16).astype(jnp.float32))
    # NaNs (2%) and negative zeros (10%) among heavy ties, as in
    # tests/test_torch_relu_maxpool.py
    nan = rng.randint(-2, 3, size=(2, 32, 12, 8)).astype(np.float32)
    nan[rng.rand(*nan.shape) < 0.02] = np.nan
    nan[rng.rand(*nan.shape) < 0.1] = -0.0
    return {"smooth": smooth, "tied": tied, "quant": quant, "nan": nan}


@pytest.mark.parametrize("name", ["smooth", "tied", "quant", "nan"])
def test_relu_maxpool_gradient_matches_pallas_interpret(rng, name):
    """With NaN taps the gradient equals the Pallas backward bit for bit:
    0 at every NaN tap (the mask is x > 0) and nothing routed from a
    window whose max is NaN. There dy holds multiples of 1/16, so that
    the f32 sums of a tap's windows are exact in either order."""
    x = _pool_cases(rng)[name]
    oshape = (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, x.shape[3])
    dy = rng.randn(*oshape).astype(np.float32)
    if name == "nan":
        dy = np.round(dy * 16) / 16
    xt = t(x).requires_grad_(True)
    relu_maxpool(xt).backward(t(dy))
    _, vjp = jax.vjp(lambda v: pallas_relu_maxpool(v, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got, want = n(xt.grad), n(want)
    if name == "nan":
        assert np.isnan(x).any() and not np.isnan(got).any()
        assert (got[np.isnan(x)] == 0).all()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    np.testing.assert_array_equal(got != 0, want != 0)  # same routing
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(dy).max())


@pytest.mark.parametrize("pallas,ratio,want", [(True, 0, 2), (True, 3, 3),
                                              (False, 0, 0)])
def test_roi_heads_take_the_pallas_ratio_substitution(pallas, ratio, want):
    """TPU.USE_PALLAS_ROIALIGN samples at ratio 2 where adaptive is asked
    (the JAX package's roi_heads.py:197-204), so both packages compute
    the same function under either setting."""
    jc, tc = (mod.ROIHeadsConfig.from_cfg(c) for mod, c in zip(
        (jrh, trh), _cfgs(**{"TPU.USE_PALLAS_ROIALIGN": pallas,
                             "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO":
                                 ratio})))
    assert tc.use_pallas_roi_align == jc.use_pallas_roi_align == pallas
    assert tc.sampling_ratio == want


def test_kernel_build_name_hashes_every_header(tmp_path, monkeypatch):
    """An edited header must give the kernels a new build (a stale
    library would be loaded otherwise)."""
    for name in ("relu_maxpool.cu", "common.cuh"):
        (tmp_path / name).write_text("// v1\n")
    monkeypatch.setattr(kernel_lib, "CSRC", str(tmp_path))
    before = kernel_lib.lib_path("relu_maxpool")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert kernel_lib.lib_path("relu_maxpool") != before
