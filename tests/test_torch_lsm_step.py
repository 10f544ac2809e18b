"""PyTorch port vs JAX: the tiny ``DistillProposalMMSSRCNN`` (the
image-caption stage) end to end: its parameter tree, the loss dict and
the MMSS outputs of ``losses``, the gradients, two SGD steps through
``make_train_step`` and ``build_optimizer``, and ``inference``, with the
JAX model's weights (``model.init(method=losses)`` -> ``flatten_params``
-> ``from_flax``) and the random draws of the JAX step's own key (the
RPN and ROI samplers' uniforms and the grid and box spatial-dropout
keys).

The RPN is tamed as in tests/test_torch_train_step.py (zero anchor
deltas: the proposals are the clipped anchors); the trunk is tiny, the
pixel std torchvision-like and the class embeddings x0.1, so that
activations and logits are of order 1 (tests/torch_parity.py:TINY_LSM).
FREEZE_AT is 0 (coco_lsm.yaml), so the stem trains too, and dropout is
off (the parity runs are deterministic).

Tolerances: the loss dict and the MMSS outputs rtol 1e-4; the gradient
of each parameter within 2e-3 of its largest JAX value (float32
convolutions summed in another order through a dozen layers, forward
and backward, then a joint encoder and three distillation losses); two
SGD updates of every parameter within 2e-3 of the largest JAX update of
each tensor; frozen state (the word embeddings, FrozenBN) bit-identical
to its start on both sides; inference boxes within 1e-3 px and scores
within 1e-5. Where a gradient is zero but for rounding (``ZERO_BY_SHIFT``:
a softmax ignores a shift of a whole row) both sides are held below a
bound on that rounding noise instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import config_path as jpath
from locov_tpu.config import get_cfg as jget
from locov_tpu.engine import solver as jsolver
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.structures import batches as jb
from locov_tpu.utils.checkpoint import flatten_params, unflatten_params
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.engine import solver as tsolver
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import make_train_step
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import from_flax
from torch_parity import (LSM_B, flat_params, jax_uniforms, lsm_batch, n, t,
                          tiny_lsm_arrays, tiny_lsm_cfg)

N_ANCHORS = (96 // 16) * (128 // 16) * 15
N_ROI = 24 + 3     # post-NMS proposals + the padded gt
N_GRID = 3 * 4     # res5 cells of a 96 x 128 canvas
N_SAMPLED = 12     # BATCH_SIZE_PER_IMAGE


def _jcfg(**extra):
    return tiny_lsm_cfg(jget, jpath, **extra)


def _tcfg(**extra):
    return tiny_lsm_cfg(tget, tpath, **extra)


def loss_uniforms(key):
    """What ``DistillProposalMMSSRCNN.losses`` of the JAX package draws
    from ``key``: split six ways into the RPN sampler's, the ROI
    sampler's, the grid dropout's and the box dropout's keys (and two
    the deterministic heads do not use)."""
    r_rpn, r_sample, r_drop, r_box, _, _ = jax.random.split(key, 6)
    return {"rpn": jax_uniforms(r_rpn, LSM_B, N_ANCHORS),
            "roi": jax_uniforms(r_sample, LSM_B, N_ROI),
            "grid_drop": t(np.asarray(jax.random.uniform(
                r_drop, (LSM_B, N_GRID)))),
            "box_drop": t(np.asarray(jax.random.uniform(
                r_box, (LSM_B, N_SAMPLED))))}


@pytest.fixture(scope="module")
def lsm():
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    jbatch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                       jb.DetectionBatch, jnp.asarray)
    tbatch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                       tb.DetectionBatch, t)
    ce = arrays["class_emb"]
    jm = jbuild(_jcfg())
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jbatch, jnp.asarray(ce), key)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}

    def loss_fn(p, b, c, k):
        outputs, losses = jm.apply(p, b, c, k, method=jm.losses)
        return sum(jax.tree.leaves(losses)), (outputs, losses)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (outputs, losses)), grads = grad_fn(v, jbatch, jnp.asarray(ce), key)
    return dict(jm=jm, v=v, flat=flat, jbatch=jbatch, tbatch=tbatch, ce=ce,
                key=key, grad_fn=grad_fn, outputs=outputs, losses=losses,
                grads=grads)


def _torch_model(p, **extra):
    tm = tbuild(_tcfg(**extra), device="cpu")
    tm.load_state_dict(from_flax(p["flat"]), strict=True)
    return tm


# gradients that are 0 but for rounding, with the bound each side is
# held to: a key bias shifts a whole row of attention scores (its
# rounding noise is ~1e-13 here), and bi_seq_relationship's bias all of
# the B x B matching costs (its second column is never read; the noise of
# sums of B^2 order-1 terms is ~2e-6); softmaxes ignore both shifts
ZERO_BY_SHIFT = {"attention_self.key.bias": 1e-9,
                 "bi_seq_relationship.bias": 1e-5}


def _assert_close(got, want, what, rtol):
    for leaf, bound in ZERO_BY_SHIFT.items():
        if what.endswith(leaf):
            assert max(np.abs(got).max(), np.abs(want).max()) < bound, what
            return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err} vs scale {scale}"


def test_parameter_tree_is_jaxs(lsm):
    """The same keys as the JAX tree, one to one: the embeddings-only
    language backbone without an encoder or a LayerNorm, the grounding
    head without parameters (the projection is tied), the box predictor
    without ``emb_pred``."""
    tm = _torch_model(lsm)
    keys = set(tm.state_dict())
    assert set(from_flax(lsm["flat"])) == keys
    assert not any(".encoder." in k for k in keys
                   if k.startswith("language_backbone."))
    assert "language_backbone.bert_model.embeddings.norm.weight" not in keys
    assert not any(k.startswith("mmss_heads.grounding_head.") for k in keys)
    assert "mmss_heads.v2l_projection.weight" in keys
    assert not any("emb_pred" in k for k in keys)


def test_losses_and_outputs_match_jax(lsm):
    outputs, losses = _torch_model(lsm).losses(
        lsm["tbatch"], t(lsm["ce"]), uniforms=loss_uniforms(lsm["key"]))
    want_l, want_o = lsm["losses"], lsm["outputs"]
    assert set(losses) == set(want_l) and len(want_l) == 19
    assert set(outputs) == set(want_o) and len(want_o) == 14
    for k in want_l:
        assert np.isfinite(float(want_l[k])), k
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(want_l[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for k in want_o:
        np.testing.assert_allclose(float(outputs[k]), float(want_o[k]),
                                   rtol=1e-4, err_msg=k)
    # the MMSS losses are not degenerate: every one is positive
    assert all(float(want_l[k]) > 0 for k in want_l if k != "loss_cls")


def test_gradients_match_jax(lsm):
    want = from_flax({k: np.asarray(a) for k, a in flatten_params(
        jax.device_get(lsm["grads"]["params"])).items()})
    tm = _torch_model(lsm)
    _, losses = tm.losses(lsm["tbatch"], t(lsm["ce"]),
                          uniforms=loss_uniforms(lsm["key"]))
    sum(losses[k] for k in sorted(losses)).backward()
    checked = 0
    for name, p in tm.named_parameters():
        w = n(want[name])
        if not np.abs(w).max() > 0:
            assert p.grad is None or not p.grad.abs().max() > 0, name
            continue
        _assert_close(n(p.grad), w, name, rtol=2e-3)
        checked += 1
    # the trunk from the stem, the tied projection, the tied decoder's
    # word embeddings (frozen only by the optimizer) and the joint encoder
    for name in ("backbone.stem.conv1.weight",
                 "mmss_heads.v2l_projection.weight",
                 "language_backbone.bert_model.embeddings.word_embeddings",
                 "mmss_heads.transformer_head.encoder.layer_1.output.weight",
                 "roi_heads.res5.2.conv3.weight"):
        assert np.abs(n(want[name])).max() > 0, name
    assert checked > 100


def test_two_sgd_steps_match_jax(lsm):
    """Two steps of ``make_train_step`` (dropout live, but at rate 0),
    with clipping by value low enough to act; the frozen word embeddings
    and FrozenBN stay bit-identical on both sides."""
    extra = {"SOLVER.BASE_LR": 0.05, "SOLVER.WARMUP_ITERS": 0,
             "SOLVER.CLIP_GRADIENTS.ENABLED": True,
             "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "value",
             "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 0.05}
    jcfg = _jcfg(**extra)
    opt = jsolver.build_optimizer(
        jcfg, lsm["v"], frozen_fn=jsolver.default_frozen_fn(jcfg))[0]
    params, state = lsm["v"], opt.init(lsm["v"])
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    ce = jnp.asarray(lsm["ce"])
    for k in keys:
        _, grads = lsm["grad_fn"](params, lsm["jbatch"], ce, k)
        assert sum(int((jnp.abs(g) > 0.05).sum())
                   for g in jax.tree.leaves(grads)) > 0
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

    tcfg = _tcfg(**extra)
    tm = _torch_model(lsm, **extra)
    step = make_train_step(tm, *tsolver.build_optimizer(tcfg, tm))
    for k in keys:
        metrics = step(lsm["tbatch"], t(lsm["ce"]), None, loss_uniforms(k))
        assert np.isfinite(float(metrics["total_loss"]))
        assert "Box Batch Accuracy (Choose Image)" in metrics

    start = from_flax(lsm["flat"])
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
    assert frozen_fn(
        "language_backbone.bert_model.embeddings.word_embeddings")
    assert moved > 100


def test_inference_matches_jax(lsm):
    jm = lsm["jm"]
    want = jm.apply(lsm["v"], lsm["jbatch"], jnp.asarray(lsm["ce"]),
                    method=jm.inference)
    got = _torch_model(lsm).inference(lsm["tbatch"], t(lsm["ce"]))
    m = n(want.mask)
    assert m.sum() > 0 and (n(got.mask) == m).all()
    assert (n(got.classes)[m] == n(want.classes)[m]).all()
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], atol=1e-3)
    np.testing.assert_allclose(n(got.scores), n(want.scores), atol=1e-5)


def test_default_frozen_fn_names_match_jax():
    """The port's rules name the same parameters as JAX's on the LSM
    tree: the language backbone (all of it under FREEZE; all but the
    word embeddings without), the unused pooler and bi_seq_relationship
    under MMM_LOSS ''."""
    names = {
        "language_backbone/bert_model/embeddings/word_embeddings": True,
        "language_backbone/bert_model/embeddings/position_embeddings": True,
        "mmss_heads/transformer_head/pooler/dense/kernel": False,
        "mmss_heads/transformer_head/bi_seq_relationship/bias": False,
        "mmss_heads/v2l_projection/kernel": False,
        "backbone/stem/conv1/kernel": False,
        "roi_heads/box_predictor/bbox_pred/kernel": False,
    }
    settings = [{}, {"MODEL.LANGUAGE_BACKBONE.FREEZE": False},
                {"MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS": ""},
                {"MODEL.BACKBONE.FREEZE_AT": 2}]
    for extra in settings:
        jf = jsolver.default_frozen_fn(_jcfg(**extra))
        tf = tsolver.default_frozen_fn(_tcfg(**extra))
        for path in names:
            port = path.replace("/", ".").replace("kernel", "weight")
            assert tf(port) == jf(path), (extra, path)
    tf = tsolver.default_frozen_fn(_tcfg())
    assert all(tf(p.replace("/", ".")) == frozen
               for p, frozen in names.items() if "kernel" not in p)
    tf = tsolver.default_frozen_fn(
        _tcfg(**{"MODEL.LANGUAGE_BACKBONE.FREEZE": False}))
    assert not tf("language_backbone.bert_model.embeddings.word_embeddings")
    assert tf("language_backbone.bert_model.embeddings.norm.weight")


def test_settings_not_ported_yet_raise(lsm, monkeypatch):
    """``TPU.FUSED_MMSS_PASSES`` and the MLP head, which raised here
    before. The fused model gives the unfused model's losses (rtol 1e-5:
    the same weights and draws; tests/test_torch_fused_mmss.py holds it
    to JAX's fused model). The model with TYPES ("GroundingHead",
    "MLPHead") builds the MLP head's parameters under JAX's names and
    gives JAX's loss keys, JAX's head taken as it means to be
    (tests/test_torch_mlp_head.py:FixedMLPHead, which holds its numbers
    to the port's)."""
    from locov_tpu.models.mmss import mlp_head as jmlp
    from test_torch_mlp_head import FixedMLPHead
    u = loss_uniforms(lsm["key"])
    _, fused = _torch_model(lsm, **{"TPU.FUSED_MMSS_PASSES": True}).losses(
        lsm["tbatch"], t(lsm["ce"]), uniforms=u)
    assert set(fused) == set(lsm["losses"])
    for k, v in lsm["losses"].items():
        np.testing.assert_allclose(float(fused[k].detach()), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    _, unfused = _torch_model(lsm).losses(lsm["tbatch"], t(lsm["ce"]),
                                          uniforms=u)
    for k in unfused:
        assert float(fused[k].detach()) == pytest.approx(float(unfused[k]),
                                                rel=1e-5, abs=1e-7), k

    types = {"MODEL.MMSS_HEAD.TYPES": ("GroundingHead", "MLPHead")}
    monkeypatch.setattr(jmlp, "MLPHead", FixedMLPHead)
    jm = jbuild(_jcfg(**types))
    ce = jnp.asarray(lsm["ce"])

    def jax_side():
        v = jm.init(lsm["key"], lsm["jbatch"], ce, lsm["key"],
                    method=jm.losses)
        return v, jm.apply(v, lsm["jbatch"], ce, lsm["key"],
                           method=jm.losses)[1]
    v, want = jax.eval_shape(jax_side)
    tm = tbuild(_tcfg(**types), device="cpu")
    keys = set(tm.state_dict())
    assert keys == set(from_flax({k: np.zeros(a.shape, np.float32)
                                  for k, a in flatten_params(
                                      v["params"]).items()}))
    assert "mmss_heads.mlp_head.mlp_in.weight" in keys
    _, losses = tm.losses(lsm["tbatch"], t(lsm["ce"]), uniforms=u)
    assert set(losses) == set(want)
    assert all(np.isfinite(float(x)) for x in losses.values())


def test_same_seed_same_step_with_live_dropout():
    """Dropout on (0.1 in the joint encoder and the visual embedding):
    the step is a function of the generator's seed, and another seed
    gives other losses."""
    extra = {"MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG."
             "hidden_dropout_prob": 0.1,
             "MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG."
             "attention_probs_dropout_prob": 0.1}
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    batch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                      tb.DetectionBatch, t)
    cfg = _tcfg(**extra)
    from locov_torch.utils.weights import seeded_init_
    out = []
    for seed in (3, 3, 4):
        tm = seeded_init_(tbuild(cfg, device="cpu"), 0)
        step = make_train_step(tm, *tsolver.build_optimizer(cfg, tm))
        gen = torch.Generator().manual_seed(seed)
        out.append(step(batch, t(arrays["class_emb"]), gen))
    key = "Masked Language Modeling Loss"
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    assert not torch.equal(out[0][key], out[2][key])


@pytest.mark.parametrize("mode", ["lsm", "stt_eval"])
def test_bench_twin_prints_one_error_line_and_exits_1(capsys, mode):
    """On a device that does not exist the twin of bench.py prints one
    JSON line with its metric at 0 and the error, and returns 1."""
    import json
    from locov_torch.tools import bench
    assert bench.main(["--mode", mode, "--device", "cuda:99"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == bench.METRICS[mode] and line["value"] == 0.0
    assert line["error"]
