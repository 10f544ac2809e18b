"""PyTorch port vs JAX: tiny ``OvrRCNN.inference`` end to end, with the
JAX model's weights (``model.init`` -> ``flatten_params`` ->
``from_flax``), plus the port's device and weight-import contracts.

The random-init RPN is a knife edge (decoded boxes can collapse to
zero-area corner boxes on ulp-level differences), so the RPN is tamed
as tests/test_int8.py:_tame_rpn does: the anchor-delta head is zeroed
and proposals are the clipped anchors. A torchvision-like pixel std
keeps activations of order 10 and the RPN logits well apart at the
top-k boundary, and the class embeddings are scaled by 0.1 so that the
class logits are of order 1 and the scores spread.

Tolerances: identical proposal masks, detection masks and classes;
proposal and detection boxes atol 1e-3 px; detection scores atol 1e-5
(softmax probabilities from float32 logits that differ by the
summation order of a dozen convolutions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.models.meta_arch.ovr_rcnn import \
    normalize_and_zero_pad as j_normalize
from locov_tpu.models.rpn import select_proposals as j_select
from locov_tpu.structures.batches import DetectionBatch as JBatch
from locov_tpu.structures.batches import ImageBatch as JImages
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.models.meta_arch.ovr_rcnn import \
    normalize_and_zero_pad as t_normalize
from locov_torch.models.rpn import select_proposals as t_select
from locov_torch.structures.batches import DetectionBatch as TBatch
from locov_torch.structures.batches import ImageBatch as TImages
from locov_torch.structures.batches import ProposalBatch as TProposals
from locov_torch.utils.weights import from_flax
from torch_parity import flat_params, n, t, tiny_cfg

EXTRA = {"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    hw = np.array([[64, 64], [48, 56]], np.int32)
    ohw = np.array([[128, 128], [96, 112]], np.int32)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0  # background row
    jm = jbuild(tiny_cfg(jget, **EXTRA))
    jb = JBatch(images=JImages(image=jnp.asarray(img), hw=jnp.asarray(hw),
                               orig_hw=jnp.asarray(ohw)))
    v = jax.jit(lambda b, c: jm.init(jax.random.PRNGKey(0), b, c,
                                     method=jm.inference))(jb, jnp.asarray(ce))
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}
    tm = tbuild(tiny_cfg(tget, **EXTRA), device="cpu")
    tm.load_state_dict(from_flax(flat), strict=True)
    tb = TBatch(images=TImages(image=t(img), hw=t(hw), orig_hw=t(ohw)))
    return dict(jm=jm, v=v, jb=jb, tm=tm, tb=tb, ce=ce, flat=flat)


def _jax_proposals(p):
    def fn(m, b):
        feats = m.backbone(m.preprocess(b.images))["res4"]
        anchors, logits, deltas = m.run_rpn(feats, b.images, False)
        return j_select(anchors, logits, deltas, b.images.hw, m.rpn_cfg,
                        training=False)
    return p["jm"].apply(p["v"], p["jb"], method=fn)


def _torch_proposals(p):
    m, images = p["tm"], p["tb"].images
    with torch.inference_mode():
        feats = m.backbone(m.preprocess(images))["res4"]
        anchors, logits, deltas = m.run_rpn(feats)
        return t_select(anchors, logits, deltas, images.hw, m.rpn_cfg)


def _assert_same_detections(got, want):
    m = n(want.mask)
    assert m.sum() >= 10
    np.testing.assert_array_equal(n(got.mask), m)
    np.testing.assert_array_equal(n(got.classes)[m], n(want.classes)[m])
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], rtol=0,
                               atol=1e-3)


def test_from_flax_covers_every_parameter(pair):
    sd = pair["tm"].state_dict()
    mapped = from_flax(pair["flat"])
    assert set(mapped) == set(sd)
    assert len(sd) == 275
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_normalize_and_zero_pad_matches_jax(pair):
    cfg = tiny_cfg(tget, **EXTRA)
    got = t_normalize(pair["tb"].images, cfg.MODEL.PIXEL_MEAN,
                      cfg.MODEL.PIXEL_STD, torch.float32)
    want = j_normalize(pair["jb"].images, cfg.MODEL.PIXEL_MEAN,
                       cfg.MODEL.PIXEL_STD, jnp.float32)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    assert (n(got)[1, 48:] == 0).all() and (n(got)[1, :, 56:] == 0).all()


def test_proposals_match_jax(pair):
    got, want = _torch_proposals(pair), _jax_proposals(pair)
    m = n(want.mask)
    assert m.sum() > 8
    np.testing.assert_array_equal(n(got.mask), m)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(n(got.objectness)[m], n(want.objectness)[m],
                               rtol=1e-4, atol=1e-5)


def test_second_stage_on_jax_proposals_matches_jax(pair):
    """The stages compared apart: the JAX proposals go through the
    port's precomputed-proposals path and the JAX model's."""
    props = _jax_proposals(pair)
    cfg_over = {"MODEL.PROPOSAL_GENERATOR.NAME": "PrecomputedProposals"}
    jm = jbuild(tiny_cfg(jget, **EXTRA, **cfg_over))
    v = {"params": {k: w for k, w in pair["v"]["params"].items()
                    if k != "rpn_head"}}
    want = jm.apply(v, pair["jb"]._replace(proposals=props),
                    jnp.asarray(pair["ce"]), method=jm.inference)
    tm = tbuild(tiny_cfg(tget, **EXTRA, **cfg_over), device="cpu")
    sd = {k: w for k, w in from_flax(pair["flat"]).items()
          if not k.startswith("rpn_head.")}
    tm.load_state_dict(sd, strict=True)
    tprops = TProposals(boxes=t(n(props.boxes)),
                        objectness=t(n(props.objectness)),
                        mask=t(n(props.mask)))
    got = tm.inference(pair["tb"]._replace(proposals=tprops),
                       t(pair["ce"]))
    _assert_same_detections(got, want)
    with pytest.raises(ValueError, match="precomputed proposals"):
        tm.inference(pair["tb"], t(pair["ce"]))


def test_inference_matches_jax(pair):
    want = pair["jm"].apply(pair["v"], pair["jb"], jnp.asarray(pair["ce"]),
                            method=pair["jm"].inference)
    got = pair["tm"].inference(pair["tb"], t(pair["ce"]))
    assert got.boxes.shape == (2, 10, 4)
    assert got.classes.dtype == torch.int32
    _assert_same_detections(got, want)
    # boxes are in original-image coordinates, clipped to them
    b = n(got.boxes)
    assert b[0].max() <= 128 and b[1][..., 0::2].max() <= 112


def test_entry_points_default_to_cuda():
    cfg = tiny_cfg(tget)
    if torch.cuda.is_available():
        assert tbuild(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuild(cfg)
    assert tbuild(cfg, device="cpu").device.type == "cpu"
