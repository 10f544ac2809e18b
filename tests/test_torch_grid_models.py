"""PyTorch port vs JAX: the grid models ``MMSSGridModel`` and
``DistillMMSSGridModel`` (``locov_torch/models/meta_arch/mmss_gcnn.py``),
their 'ovr' evaluation (``engine/trainer.py:test``) and the grid -> STT
hand-off (``utils/checkpoint.py:load_weights_standalone``), at tiny
widths (tests/torch_parity.py's ``TINY_LSM``), on the same numpy inputs
and Flax weights.

The models: ``MMSSGridModel`` without distillation, and
``DistillMMSSGridModel`` with ``kd_loss``, both on the trunk's res5 grid
(``MMSS_HEAD.IN_FEATURES`` "res5", the default: a fifth stage in
``backbone``); and the res4 grid with the grounding head's random
branches, JAX's draws handed to the port. The draws of JAX's key: the
spatial dropout's uniforms from ``split(rng)[0]``, the grounding head's
from ``split(split(rng)[1])[1]``.

Tolerances (tests/test_torch_lsm_step.py's): the loss dict and the
outputs rtol 1e-4 (on the res4 grid ``kd_loss`` also atol 1e-5: there
it is a KL of two nearly equal distributions, 7e-3 made of order-1
terms, each rounded in float32); each parameter's gradient within 2e-3 of its largest
JAX value; two SGD updates within 2e-3 of the largest JAX update of
each tensor, frozen state bit-identical. The 'ovr' evaluation: the
averaged losses and metrics rtol 1e-4 (tests/test_torch_trainer.py's),
with a spatial dropout that keeps every cell (the heads do not depend
on the regions' order, so the two packages' draws do not matter). The
hand-off: the STT model's state equal to JAX's renamed state but for
the ROI res5, which the port takes from the grid model's trunk res5 (the
reference's ``backbone.res5 <-> roi_heads.res5``; JAX's map has only
the roi_heads/res5 source and leaves it at init); detections within
tests/test_torch_stage_transfer.py's bounds."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import config_path as jpath
from locov_tpu.config import get_cfg as jget
from locov_tpu.data import DatasetCatalog as JCat
from locov_tpu.data import MetadataCatalog as JMeta
from locov_tpu.data import get_register_dataset as jregister
from locov_tpu.data import loader as jloader
from locov_tpu.data.mappers import DetectionMapper as JMapper
from locov_tpu.data.synthetic import micro_cfg as jmicro_cfg
from locov_tpu.engine import solver as jsolver
from locov_tpu.engine.trainer import build_tokenizer as jtokenizer
from locov_tpu.evaluation import evaluator as jev
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.parallel import get_mesh
from locov_tpu.parallel import make_eval_step as jmake_eval_step
from locov_tpu.parallel import make_loss_eval_step as jmake_loss_eval_step
from locov_tpu.structures import batches as jb
from locov_tpu.utils import checkpoint as jck
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.data import MetadataCatalog as TMeta
from locov_torch.data.synthetic import make_micro_coco
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.engine import solver as tsolver
from locov_torch.engine import trainer as ttrainer
from locov_torch.evaluation import evaluator as tev
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import make_eval_step as tmake_eval_step
from locov_torch.parallel.mesh import make_train_step
from locov_torch.structures import batches as tb
from locov_torch.utils import checkpoint as tck
from locov_torch.utils.weights import from_flax, torch_name
from test_torch_eval_helpers import fresh_catalogs
from test_torch_lsm_step import _assert_close
from test_torch_stage_transfer import (BOX_TOL, NAME, SCORE_TOL, _stt_cfg,
                                       seeded_flax)
from test_torch_trainer import lsm_cfg
from torch_parity import (LSM_B, LSM_L, flat_params, jax_grounding_draws,
                          lsm_batch, n, t, tiny_lsm_arrays, tiny_lsm_cfg,
                          two_threads)  # noqa: F401 (autouse)

N_GRID = {"res5": 3 * 4, "res4": 6 * 8}  # cells of a 96 x 128 canvas
ARCHS = {"grid": {"MODEL.META_ARCHITECTURE": "MMSSGridModel",
                  "MODEL.MMSS_HEAD.DISTILLATION_LOSS": False},
         "distill": {"MODEL.META_ARCHITECTURE": "DistillMMSSGridModel"}}


def _cfg(get, path, **extra):
    return tiny_lsm_cfg(get, path, **extra)


def grid_uniforms(key, gcfg=None, n_grid=N_GRID["res5"], k=8):
    """What the JAX grid model's ``losses`` draws from ``key``: the
    spatial dropout's keys, and (for ``gcfg``, a grounding config with a
    random branch) the grounding head's draws."""
    r_drop, r_heads = jax.random.split(key)
    u = {"grid_drop": t(np.asarray(jax.random.uniform(
        r_drop, (LSM_B, n_grid))))}
    if gcfg is not None:
        _, k_ground = jax.random.split(r_heads)
        u["grid_heads"] = jax_grounding_draws(gcfg, k_ground, LSM_B, LSM_L,
                                              k)
    return u


@pytest.fixture(scope="module", params=list(ARCHS))
def grid(request):
    extra = ARCHS[request.param]
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    jbatch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                       jb.DetectionBatch, jnp.asarray)
    tbatch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                       tb.DetectionBatch, t)
    ce = jnp.asarray(arrays["class_emb"])
    jm = jbuild(_cfg(jget, jpath, **extra))
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jbatch, ce, key)

    def loss_fn(p, b, k):
        outputs, losses = jm.apply(p, b, ce, k, method=jm.losses)
        return sum(jax.tree.leaves(losses)), (outputs, losses)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (outputs, losses)), grads = grad_fn(v, jbatch, key)
    return dict(name=request.param, extra=extra, jm=jm, v=v,
                flat=flat_params(v), jbatch=jbatch, tbatch=tbatch,
                ce=arrays["class_emb"], key=key, grad_fn=grad_fn,
                outputs=outputs, losses=losses, grads=grads)


def _torch_model(p, **extra):
    tm = tbuild(_cfg(tget, tpath, **p["extra"], **extra), device="cpu")
    tm.load_state_dict(from_flax(p["flat"]), strict=True)
    return tm


def test_parameter_tree_is_jaxs(grid):
    """The trunk with its res5 stage, the language backbone and the
    heads; no RPN and no ROI heads."""
    tm = _torch_model(grid)
    keys = set(tm.state_dict())
    assert set(from_flax(grid["flat"])) == keys
    assert "backbone.res5.2.conv3.weight" in keys
    assert not any(k.startswith(("roi_heads.", "rpn_head.")) for k in keys)
    assert tm.mmss_heads.v2l_projection.weight.shape == (16, 32 * 8)


def test_losses_and_outputs_match_jax(grid):
    outputs, losses = _torch_model(grid).losses(
        grid["tbatch"], t(grid["ce"]), uniforms=grid_uniforms(grid["key"]))
    want_l, want_o = grid["losses"], grid["outputs"]
    assert set(losses) == set(want_l) and set(outputs) == set(want_o)
    assert ("kd_loss" in want_l) == (grid["name"] == "distill")
    assert "Masked Language Modeling Loss" in want_l and len(want_o) == 7
    for k in want_l:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(want_l[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for k in want_o:
        np.testing.assert_allclose(float(outputs[k]), float(want_o[k]),
                                   rtol=1e-4, err_msg=k)


def test_gradients_match_jax(grid):
    want = from_flax(flat_params(grid["grads"]))
    tm = _torch_model(grid)
    _, losses = tm.losses(grid["tbatch"], t(grid["ce"]),
                          uniforms=grid_uniforms(grid["key"]))
    sum(losses[k] for k in sorted(losses)).backward()
    checked = 0
    for name, p in tm.named_parameters():
        w = n(want[name])
        if not np.abs(w).max() > 0:
            assert p.grad is None or not p.grad.abs().max() > 0, name
            continue
        _assert_close(n(p.grad), w, name, rtol=2e-3)
        checked += 1
    for name in ("backbone.stem.conv1.weight", "backbone.res5.2.conv3.weight",
                 "mmss_heads.v2l_projection.weight"):
        assert np.abs(n(want[name])).max() > 0, name
    assert checked > 80


def test_two_sgd_steps_match_jax(grid):
    """Two steps of ``make_train_step`` (the grid model's ``losses``
    takes the step's class embeddings and ignores them) against JAX's
    optimizer; the frozen word embeddings and FrozenBN stay put."""
    extra = {"SOLVER.BASE_LR": 0.05, "SOLVER.WARMUP_ITERS": 0}
    jcfg = _cfg(jget, jpath, **grid["extra"], **extra)
    opt = jsolver.build_optimizer(
        jcfg, grid["v"], frozen_fn=jsolver.default_frozen_fn(jcfg))[0]
    params, state = grid["v"], opt.init(grid["v"])
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    for k in keys:
        _, grads = grid["grad_fn"](params, grid["jbatch"], k)
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

    tcfg = _cfg(tget, tpath, **grid["extra"], **extra)
    tm = _torch_model(grid, **extra)
    step = make_train_step(tm, *tsolver.build_optimizer(tcfg, tm))
    for k in keys:
        metrics = step(grid["tbatch"], t(grid["ce"]), None,
                       grid_uniforms(k))
        assert np.isfinite(float(metrics["total_loss"]))
    start = from_flax(grid["flat"])
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
    for name, b in tm.named_buffers():
        assert torch.equal(b, start[name]), name
    assert moved > 80


def test_frozen_names_match_jax(grid):
    """``default_frozen_fn`` names JAX's frozen parameters on the grid
    tree, at FREEZE_AT 0, 2 and 5 (the trunk's res5 too). FrozenBN's
    tensors are buffers in the port, never parameters."""
    params = {k for k, _ in _torch_model(grid).named_parameters()}
    names = [k for k in grid["flat"] if torch_name(k) in params]
    assert len(names) == len(params)
    for freeze_at in (0, 2, 5):
        over = {**grid["extra"], "MODEL.BACKBONE.FREEZE_AT": freeze_at}
        jf = jsolver.default_frozen_fn(_cfg(jget, jpath, **over))
        tf = tsolver.default_frozen_fn(_cfg(tget, tpath, **over))
        for path in names:
            assert tf(torch_name(path)) == jf(path), (freeze_at, path)
        assert tf("backbone.res5.0.conv1.weight") == (freeze_at >= 5)


def test_res4_grid_and_random_grounding_match_jax():
    """IN_FEATURES res4 (v_dim 4 x RES2_OUT_CHANNELS, no res5 stage) with
    the ``random_top3`` alignment: the port, handed JAX's draws for the
    grounding head's key, gives JAX's losses (random negative mining,
    which JAX runs only eagerly, is held to JAX in
    tests/test_torch_grounding_random.py)."""
    extra = {**ARCHS["distill"], "MODEL.MMSS_HEAD.IN_FEATURES": "res4",
             "MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT": "random_top3"}
    arrays = tiny_lsm_arrays(np.random.RandomState(1))
    jbatch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                       jb.DetectionBatch, jnp.asarray)
    jcfg = _cfg(jget, jpath, **extra)
    jm = jbuild(jcfg)
    key = jax.random.PRNGKey(4)
    ce = jnp.asarray(arrays["class_emb"])

    def run(b, k):
        v = jm.init(k, b, ce, k, method=jm.losses)
        return v, jm.apply(v, b, ce, k, method=jm.losses)[1]
    v, want = jax.jit(run)(jbatch, key)
    tm = tbuild(_cfg(tget, tpath, **extra), device="cpu")
    tm.load_state_dict(from_flax(flat_params(v)), strict=True)
    assert not any(k.startswith("backbone.res5") for k in tm.state_dict())
    assert tm.mmss_heads.v2l_projection.weight.shape == (16, 32 * 4)
    from locov_tpu.models.mmss.grounding_head import GroundingConfig
    u = grid_uniforms(key, GroundingConfig.from_cfg(jcfg), N_GRID["res4"])
    assert set(u["grid_heads"]) == {"align_words", "align_regions"}
    _, got = tm.losses(lsm_batch(arrays, tb.ImageBatch, tb.GtBatch,
                                 tb.TextBatch, tb.DetectionBatch, t),
                       t(arrays["class_emb"]), uniforms=u)
    assert set(got) == set(want) and "kd_loss" in got
    for k in want:
        # kd_loss is a KL between nearly equal distributions here (the
        # matching loss sits at its uniform value 2 log 2): a difference
        # of order-1 terms, each rounded in float32 (the softmax and
        # hardmax alignments read 1.8e-4 and 2e-6 relative on this batch)
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-4,
                                   atol=1e-5 if k == "kd_loss" else 1e-7,
                                   err_msg=k)


# ------------------------------------------------------- on a micro tree
def _grid_cfg(micro_cfg, root):
    """tests/test_torch_trainer.py's image-caption model on the micro
    tree as the grid model, every grid cell kept."""
    cfg = lsm_cfg(micro_cfg, root, "grid_eval")
    cfg.MODEL.META_ARCHITECTURE = "DistillMMSSGridModel"
    cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = 100
    return cfg


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grid_micro"))
    make_micro_coco(root, n_val=12)
    fresh_catalogs()
    yield root
    fresh_catalogs()


def test_ovr_evaluation_matches_jax(micro):
    """``test`` of a grid model: the 'ovr' evaluator runs the loss-only
    pass and no detection evaluation; its averages are those of JAX's
    ``inference_on_caption_dataset`` over JAX's test loader (one device,
    the same batch of 4)."""
    jcfg, tcfg = _grid_cfg(jmicro_cfg, micro), _grid_cfg(tmicro_cfg, micro)
    name = tcfg.DATASETS.TEST[0]
    assert tev.select_evaluator_type(tcfg, name) == \
        jev.select_evaluator_type(jcfg, name) == "ovr"
    jregister(name)(name, micro)
    meta = JMeta.get(name)
    loader = jloader.DataLoader(
        JCat.get(name), JMapper(jcfg, meta, False, tokenizer=jtokenizer(jcfg),
                                mlm=False, seed=0),
        jloader.InferenceSampler(len(JCat.get(name))),
        jcfg.TEST.IMS_PER_BATCH, jloader.derive_buckets(jcfg, False),
        jcfg.TPU.MAX_GT_BOXES, has_text=True, is_train=False, seed=0,
        proposal_slots=jcfg.TPU.MAX_PRECOMPUTED_PROPOSALS)
    first = next(iter(loader))
    jm = jbuild(jcfg)
    ce = jnp.zeros((2, jcfg.MODEL.ROI_BOX_HEAD.EMB_DIM), jnp.float32)
    key = jax.random.PRNGKey(0)
    flat = seeded_flax(jax.eval_shape(
        lambda b: jm.init(key, b, ce, key, method=jm.losses), first), 3)
    v = {"params": jck.unflatten_params({k: jnp.asarray(a)
                                         for k, a in flat.items()})}
    jstep = jmake_loss_eval_step(jm, get_mesh(jax.devices()[:1]))
    want_m, want_l = jev.inference_on_caption_dataset(
        jstep, v, loader, ce, jax.random.PRNGKey(5))
    loader.close()

    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(from_flax(flat), strict=True)
    res = ttrainer.test(tcfg, tm, "cpu")[name]
    assert not any(k.startswith("AP") for k in res)
    want = {**want_m, **want_l}
    assert set(res) == set(want) and "Total Loss" in res
    assert "kd_loss" in res and len(res) > 10
    for k in want:
        assert res[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_grid_to_stt_handoff(micro):
    """A grid checkpoint into ``OvrRCNN`` (the OVR-CNN recipe): the
    trunk's stem to res4 by name, its res5 into the ROI res5, the tied
    projection into ``emb_pred``; the rest of JAX's renamed state alike;
    then the STT detections of the micro val images against JAX's on
    that state."""
    from test_torch_evaluator import TAME
    gcfg_j = _cfg(jget, jpath, **ARCHS["distill"])
    gcfg_t = _cfg(tget, tpath, **ARCHS["distill"])
    for cfg in (gcfg_j, gcfg_t):
        cfg.MODEL.ANCHOR_GENERATOR.SIZES = TAME[
            "MODEL.ANCHOR_GENERATOR.SIZES"]
    jgrid = jbuild(gcfg_j)
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    batch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                      jb.DetectionBatch, jnp.asarray)
    key = jax.random.PRNGKey(0)
    grid_flat = seeded_flax(jax.eval_shape(
        lambda: jgrid.init(key, batch, jnp.asarray(arrays["class_emb"]),
                           key, method=jgrid.losses)), 1)

    jcfg, tcfg = _stt_cfg(jmicro_cfg, micro), _stt_cfg(tmicro_cfg, micro)
    jregister(NAME)(NAME, micro)
    meta = JMeta.get(NAME)

    def jax_loader():
        return jloader.DataLoader(
            JCat.get(NAME), JMapper(jcfg, meta, False, seed=0),
            jloader.InferenceSampler(len(JCat.get(NAME))), 8,
            jloader.derive_buckets(jcfg, False), jcfg.TPU.MAX_GT_BOXES,
            has_text=False, is_train=False, seed=0)
    ce = jnp.asarray(meta.class_emb_mtx) * 0.1
    jstt = jbuild(jcfg)
    stt_flat = seeded_flax(jax.eval_shape(
        lambda: jstt.init(key, next(iter(jax_loader())), ce,
                          method=jstt.inference)), 2)
    merged, jrep = jck.load_with_rename_map(grid_flat, stt_flat,
                                            jck.STT_FROM_LSM_RENAME)
    # JAX's map leaves the ROI res5 at its init and the trunk's res5
    # unused; the port carries it over (the reference's fan-out)
    assert not any(k.startswith("roi_heads/res5") for k in jrep.loaded)
    assert any(k.startswith("backbone/res5") for k in jrep.unused_src)
    res5 = {k: grid_flat["backbone/res5" + k[len("roi_heads/res5"):]]
            for k in merged if k.startswith("roi_heads/res5")}
    assert len(res5) > 40
    merged.update(res5)

    tgrid = tbuild(gcfg_t, device="cpu")
    tgrid.load_state_dict(from_flax(grid_flat), strict=True)
    ck = tck.Checkpointer(os.path.join(micro, "grid_out"))
    ck.save_named("model_final", {"model": tgrid.state_dict(),
                                  "iteration": 0})
    ck.wait()
    tstt = tbuild(tcfg, device="cpu")
    tstt.load_state_dict(from_flax(stt_flat), strict=True)
    trep = tck.load_weights_standalone(
        tstt, os.path.join(micro, "grid_out", "model_final"))
    # the grid model has no RPN and no bbox_pred: the detector keeps its
    # own
    assert trep.mismatched == [] and trep.missing and all(
        k.startswith(("rpn_head.", "roi_heads.box_predictor.bbox_pred."))
        for k in trep.missing)
    got, want = tstt.state_dict(), from_flax(merged)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for leaf in ("weight", "bias"):
        assert torch.equal(got[f"roi_heads.box_predictor.emb_pred.{leaf}"],
                           tgrid.state_dict()[
                               f"mmss_heads.v2l_projection.{leaf}"])

    v = {"params": jck.unflatten_params({k: jnp.asarray(a)
                                         for k, a in merged.items()})}
    jflat, _ = jev.collect_detections(jmake_eval_step(jstt, get_mesh()), v,
                                      jax_loader(), ce,
                                      jev.dataset_id_lut(meta))
    with ttrainer.build_test_loader(tcfg, NAME, None, False) as tl:
        tflat, _ = tev.collect_detections(
            tmake_eval_step(tstt), None, tl, t(np.asarray(ce)),
            tev.dataset_id_lut(TMeta.get(NAME)))
    assert len(tf_img := tflat["img"]) > 100 and len(set(tf_img)) == 12
    np.testing.assert_array_equal(tflat["img"], jflat["img"])
    np.testing.assert_array_equal(tflat["cls"], jflat["cls"])
    np.testing.assert_allclose(tflat["box"], jflat["box"], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(tflat["score"], jflat["score"], rtol=0,
                               atol=SCORE_TOL)
