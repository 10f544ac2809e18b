"""PyTorch port vs JAX: the tiny ``OvrRCNN`` training step end to end,
at FREEZE_AT 2 (STT's setting) and 0 (the stem trains, through the
relu + max-pool backward), with the JAX model's weights
(``model.init(method=losses)`` -> ``flatten_params`` -> ``from_flax``)
and the samplers' uniform draws of the JAX step's own keys; plus the
solver's schedule, freezing rules and refusals.

The RPN is tamed as in tests/test_torch_ovr_rcnn.py (zero anchor
deltas: the proposals are the clipped anchors), with a torchvision-like
pixel std and class embeddings x0.1, so that activations and logits are
of order 1.

Tolerances: the loss dict rtol 1e-4; the gradients of the chosen
parameters within 1e-3 of the largest JAX value of each tensor (float32
convolutions summed in another order through a dozen layers, forward
and backward); two SGD updates of every parameter within 2e-3 of the
largest JAX update of each tensor (two such gradients, the second at
parameters that differ by the first one's error; where clipping by
value caps the update, the gradients' error is not capped with it);
frozen parameters bit-identical to their start on both sides.

The losses take JAX's gradient at the kinks of |x| and max(x, 0)
(``locov_torch/ops/losses.py``): with torch's own, an anchor centred on
its gt (a box delta of exactly 0) trains differently, and the second
step's proposals and samples differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.engine import solver as jsolver
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.structures.batches import DetectionBatch as JBatch
from locov_tpu.structures.batches import GtBatch as JGt
from locov_tpu.structures.batches import ImageBatch as JImages
from locov_tpu.utils.checkpoint import flatten_params, unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.engine import solver as tsolver
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import make_train_step
from locov_torch.structures.batches import DetectionBatch as TBatch
from locov_torch.structures.batches import GtBatch as TGt
from locov_torch.structures.batches import ImageBatch as TImages
from locov_torch.utils.weights import from_flax
from torch_parity import flat_params, jax_uniforms, n, t, tiny_cfg

EXTRA = {"MODEL.PIXEL_STD": [57.375, 57.12, 58.395],
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16,
         "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 64,
         "MODEL.RPN.POST_NMS_TOPK_TRAIN": 32,
         "MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED": True,
         "SOLVER.BASE_LR": 0.05, "SOLVER.WARMUP_ITERS": 0}
N_ANCHORS = (64 // 16) ** 2 * 15
N_ROI = 32 + 2  # post-NMS proposals + the padded gt
GRAD_NAMES = ["backbone.stem.conv1.weight", "backbone.res2.1.conv1.weight",
              "backbone.res4.0.conv2.weight", "rpn_head.conv.weight",
              "roi_heads.res5.2.conv3.weight",
              "roi_heads.box_predictor.bbox_pred.weight"]


def _cfg(get, freeze_at, **extra):
    return tiny_cfg(get, **{**EXTRA, "MODEL.BACKBONE.FREEZE_AT": freeze_at,
                            **extra})


def _batch(rng):
    img = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    hw = np.array([[64, 64], [48, 56]], np.int32)
    ohw = np.array([[128, 128], [96, 112]], np.int32)
    boxes = np.array([[[4, 4, 30, 30], [10, 20, 40, 44]],
                      [[8, 8, 24, 24], [0, 0, 0, 0]]], np.float32)
    classes = np.array([[1, 3], [0, 0]], np.int32)
    mask = np.array([[True, True], [True, False]])
    jb = JBatch(images=JImages(image=jnp.asarray(img), hw=jnp.asarray(hw),
                               orig_hw=jnp.asarray(ohw)),
                gt=JGt(jnp.asarray(boxes), jnp.asarray(classes),
                       jnp.asarray(mask)))
    tb = TBatch(images=TImages(image=t(img), hw=t(hw), orig_hw=t(ohw)),
                gt=TGt(t(boxes), t(classes), t(mask)))
    return jb, tb


def loss_uniforms(key):
    """What ``OvrRCNN.losses`` of the JAX package draws from ``key``: the
    RPN sampler's keys from the first split, the ROI sampler's from the
    second."""
    key, k_rpn = jax.random.split(key)
    _, k_roi = jax.random.split(key)
    return {"rpn": jax_uniforms(k_rpn, 2, N_ANCHORS),
            "roi": jax_uniforms(k_roi, 2, N_ROI)}


@pytest.fixture(scope="module", params=[2, 0], ids=["freeze2", "freeze0"])
def pair(request):
    freeze_at = request.param
    rng = np.random.RandomState(0)
    jb, tb = _batch(rng)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0  # background row
    jm = jbuild(_cfg(jget, freeze_at))
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jb, jnp.asarray(ce), key)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}

    def loss_fn(p, b, c, k):
        losses = jm.apply(p, b, c, k, method=jm.losses)
        return sum(jax.tree.leaves(losses)), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return dict(freeze_at=freeze_at, jm=jm, v=v, flat=flat, jb=jb, tb=tb,
                ce=ce, key=key, grad_fn=grad_fn)


def _torch_model(p, **extra):
    tm = tbuild(_cfg(tget, p["freeze_at"], **extra), device="cpu")
    tm.load_state_dict(from_flax(p["flat"]), strict=True)
    return tm


def _torch_grads(grads):
    """JAX gradients -> the port's names and layouts."""
    return from_flax({k: np.asarray(a) for k, a in
                      flatten_params(jax.device_get(grads["params"])).items()})


def test_from_flax_loads_the_training_tree(pair):
    tm = _torch_model(pair)
    assert set(from_flax(pair["flat"])) == set(tm.state_dict())
    assert len(tm.state_dict()) == 275


def test_losses_match_jax(pair):
    (_, want), _ = pair["grad_fn"](pair["v"], pair["jb"],
                                   jnp.asarray(pair["ce"]), pair["key"])
    got = _torch_model(pair).losses(pair["tb"], t(pair["ce"]),
                                    uniforms=loss_uniforms(pair["key"]))
    assert set(got) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                        "loss_box_reg"} == set(want)
    for k in want:
        assert np.isfinite(float(want[k])) and float(want[k]) > 0
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-4)


def _assert_close(got, want, what, rtol=1e-3):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} vs scale {scale}"


def test_gradients_match_jax(pair):
    _, grads = pair["grad_fn"](pair["v"], pair["jb"],
                               jnp.asarray(pair["ce"]), pair["key"])
    want = _torch_grads(grads)
    tm = _torch_model(pair)
    losses = tm.losses(pair["tb"], t(pair["ce"]),
                       uniforms=loss_uniforms(pair["key"]))
    sum(losses[k] for k in sorted(losses)).backward()
    params = dict(tm.named_parameters())
    frozen = ("backbone.stem.", "backbone.res2.")[:pair["freeze_at"]]
    for name in GRAD_NAMES:
        w = n(want[name])
        if name.startswith(frozen):
            # a frozen stage: JAX's gradient stops there, the port
            # builds no graph through it at all
            assert not params[name].requires_grad and \
                params[name].grad is None
            assert (w == 0).all()
            continue
        assert np.abs(w).max() > 0, name
        _assert_close(n(params[name].grad), w, name)


@pytest.mark.parametrize("nesterov,clip", [(False, "value"), (True, "norm")])
def test_two_sgd_steps_match_jax(pair, nesterov, clip):
    """Two steps, so that momentum and weight decay both act; the clip
    thresholds are low enough that the clipping acts."""
    extra = {"SOLVER.NESTEROV": nesterov,
             "SOLVER.CLIP_GRADIENTS.ENABLED": True,
             "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": clip,
             "SOLVER.CLIP_GRADIENTS.CLIP_VALUE":
                 0.05 if clip == "value" else 0.5}
    jcfg = _cfg(jget, pair["freeze_at"], **extra)
    opt = jsolver.build_optimizer(
        jcfg, pair["v"], frozen_fn=jsolver.default_frozen_fn(jcfg))[0]
    params, state = pair["v"], None
    state = opt.init(params)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    ce = jnp.asarray(pair["ce"])
    for k in keys:
        _, grads = pair["grad_fn"](params, pair["jb"], ce, k)
        leaves = jax.tree.leaves(grads)
        if clip == "value":
            clipped = sum(int((jnp.abs(g) > 0.05).sum()) for g in leaves)
        else:
            clipped = int(sum(float((g * g).sum()) for g in leaves) > 0.25)
        assert clipped > 0  # the clipping acts
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

    tcfg = _cfg(tget, pair["freeze_at"], **extra)
    tm = _torch_model(pair, **extra)
    step = make_train_step(tm, *tsolver.build_optimizer(tcfg, tm))
    for k in keys:
        metrics = step(pair["tb"], t(pair["ce"]), None, loss_uniforms(k))
        assert np.isfinite(float(metrics["total_loss"]))

    start = from_flax(pair["flat"])
    want = from_flax(flat_params(params))
    frozen_fn = tsolver.default_frozen_fn(tcfg)
    moved = 0
    for name, p in tm.named_parameters():
        d_got = n(p) - n(start[name])
        d_want = n(want[name]) - n(start[name])
        if frozen_fn(name):
            assert (d_got == 0).all() and (d_want == 0).all(), name
            continue
        moved += 1
        _assert_close(d_got, d_want, name, rtol=2e-3)
    for name, b in tm.named_buffers():  # FrozenBN
        assert torch.equal(b, start[name]), name
        assert (n(want[name]) == n(start[name])).all(), name
    assert moved > 0


def test_parameter_without_gradient_steps_as_in_jax():
    """A trainable parameter that got no gradient (``emb_pred`` under
    DETACH_CLASS_PREDICTOR) still decays and keeps its momentum, as the
    JAX package's update does with its zero gradient."""
    cfg = _cfg(tget, 2, **{"SOLVER.WEIGHT_DECAY": 0.1,
                           "MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED": False})
    tm = tbuild(cfg, device="cpu")
    opt, _ = tsolver.build_optimizer(cfg, tm)
    w = tm.roi_heads.box_predictor.emb_pred.weight
    start = w.detach().clone()
    for _ in range(2):
        opt.zero_grad(set_to_none=True)
        opt.step()
    jcfg = _cfg(jget, 2, **{"SOLVER.WEIGHT_DECAY": 0.1})
    params = {"w": jnp.asarray(n(start))}
    jopt = jsolver.build_optimizer(jcfg, params)[0]
    state = jopt.init(params)
    for _ in range(2):
        upd, state = jopt.update({"w": jnp.zeros_like(params["w"])}, state,
                                 params)
        params = {"w": params["w"] + upd["w"]}
    np.testing.assert_allclose(n(w), n(params["w"]), rtol=1e-6, atol=1e-9)
    assert not torch.equal(w.detach(), start)


def test_warmup_multistep_lr_matches_jax():
    args = (0.02, (5, 9), 0.1, 0.001, 4)
    for method in ("linear", "constant"):
        js = jsolver.warmup_multistep_lr(*args, method)
        ts = tsolver.warmup_multistep_lr(*args, method)
        for step in range(12):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_default_frozen_fn_names():
    cfg = _cfg(tget, 2)
    frozen = tsolver.default_frozen_fn(cfg)
    assert frozen("backbone.stem.conv1.weight")
    assert frozen("backbone.res2.0.conv1.weight")
    assert not frozen("backbone.res3.0.conv1.weight")
    assert not frozen("roi_heads.res5.0.conv1.weight")
    assert frozen("roi_heads.box_predictor.emb_pred.weight")
    assert not frozen("roi_heads.box_predictor.bbox_pred.weight")
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED = False
    frozen = tsolver.default_frozen_fn(cfg)
    assert not frozen("backbone.stem.conv1.weight")
    assert not frozen("roi_heads.box_predictor.emb_pred.weight")


def test_frozen_parameters_get_no_group_and_no_gradient():
    cfg = _cfg(tget, 2)
    tm = tbuild(cfg, device="cpu")
    opt, _ = tsolver.build_optimizer(cfg, tm)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in tm.named_parameters():
        frozen = name.startswith(("backbone.stem.", "backbone.res2.")) or \
            "emb_pred" in name
        assert (id(p) in in_opt) != frozen, name
        assert p.requires_grad != frozen, name


def test_settings_not_ported_yet_raise():
    """A clip type other than value or norm raises. The grounding box
    predictor, which raised here before, builds under JAX's names
    (``bbox_pred``, ``emb_pred``: the same state keys as JAX's tree)
    and, on a [K+1, D] matrix (one token a class) at temperature 1,
    scores as the embedding predictor does
    (tests/test_torch_box_emb_grounding.py holds its training step and
    inference to JAX's). Gradient accumulation and remat, which raised
    here before too, are held to JAX in test_torch_accumulation.py and
    test_torch_remat.py."""
    from locov_tpu.models.box_emb_grounding import ClassTokenEmbeddings
    rng = np.random.RandomState(0)
    jb, tb = _batch(rng)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    extra = {"MODEL.ROI_BOX_HEAD.NAME":
             "EmbeddingGroundingFastRCNNOutputLayers",
             "MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE": 1.0}
    jm = jbuild(_cfg(jget, 2, **extra))
    key = jax.random.PRNGKey(0)
    tokens = ClassTokenEmbeddings(jnp.asarray(ce)[:, None],
                                  jnp.ones((6, 1), jnp.float32))
    shapes = jax.eval_shape(lambda: jm.init(key, jb, tokens, key,
                                            method=jm.losses))
    tm = tbuild(_cfg(tget, 2, **extra), device="cpu")
    assert set(tm.state_dict()) == set(from_flax(
        {k: np.zeros(a.shape, np.float32)
         for k, a in flatten_params(shapes["params"]).items()}))
    plain = tbuild(_cfg(tget, 2), device="cpu")
    plain.load_state_dict(tm.state_dict())
    feats = torch.randn(5, 256)
    s1, d1 = tm.roi_heads.predict(feats, t(ce))
    s0, d0 = plain.roi_heads.predict(feats, t(ce))
    np.testing.assert_allclose(n(s1.detach()), n(s0.detach()), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(d1, d0)
    cfg = _cfg(tget, 2, **{"SOLVER.CLIP_GRADIENTS.ENABLED": True,
                           "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "full_model"})
    with pytest.raises(NotImplementedError, match="CLIP_TYPE"):
        tsolver.build_optimizer(cfg, tbuild(cfg, device="cpu"))
