"""PyTorch port vs JAX: the trainer loop and what it is made of
(``locov_torch/engine/trainer.py:OVRTrainer``,
``parallel/mesh.py:make_loss_eval_step`` and ``DevicePrefetcher``,
``evaluation/evaluator.py:inference_on_caption_dataset``,
``engine/solver.py``'s overrides and restore, ``utils/events.py``).

Against JAX on the same inputs:

- the loss-only evaluation of the tiny image-caption model
  (tests/test_torch_lsm_step.py's model and batch, JAX's weights, the
  random draws of JAX's per-batch keys handed to the port as that file
  does): averages within rtol 1e-4 (the loss dict's bound there),
  "Total Loss" and the split into metrics and losses;
- the learning rate of every iteration, through warm-up and a step,
  and after a resume, as the optimizer applies it and as the loop logs
  it (read from the optimizer): JAX's schedule function within rtol
  1e-6;
- the logged metric keys of both stages: JAX's train step's keys
  (losses, outputs, ``total_loss``, from ``jax.eval_shape``) and its
  ``run_step``'s ``data_time``, ``time`` and ``lr``;
- the JSON, CSV and printer writers: the same bytes for the same
  storage.

The loop on the CPU, on a micro-COCO tree at the parity tests' narrow
widths: train -> periodic checkpoints with pruning -> the final
checkpoint and evaluation -> resume, where the model, the momentum
buffers, the FrozenBN buffers and the schedule equal the checkpoint's
bit for bit; the NaN tripwire one step late; the best-metric save; the
projection-only load; the raises on what is not ported.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import config_path as jpath
from locov_tpu.config import get_cfg as jget
from locov_tpu.data.synthetic import micro_cfg as jmicro_cfg
from locov_tpu.engine import solver as jsolver
from locov_tpu.evaluation import evaluator as jev
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.parallel import get_mesh
from locov_tpu.parallel import make_loss_eval_step as jmake_loss_eval_step
from locov_tpu.structures import batches as jb
from locov_tpu.utils import events as jevents
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.data.synthetic import make_micro_coco
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.engine import solver as tsolver
from locov_torch.engine.trainer import OVRTrainer
from locov_torch.evaluation import evaluator as tev
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import DevicePrefetcher, make_loss_eval_step
from locov_torch.structures import batches as tb
from locov_torch.structures.batches import to_torch
from locov_torch.utils import events as tevents
from locov_torch.utils.weights import from_flax, seeded_init_
from test_torch_eval_helpers import fresh_catalogs
from test_torch_lsm_step import loss_uniforms
from torch_parity import (lsm_batch, tiny_lsm_arrays, tiny_lsm_cfg,
                          two_threads)  # noqa: F401 (autouse)

NARROW = {"STEM_OUT_CHANNELS": 8, "RES2_OUT_CHANNELS": 32,
          "WIDTH_PER_GROUP": 8}


def narrow(cfg):
    """The parity tests' narrow trunk and a torchvision-like pixel std."""
    for k, v in NARROW.items():
        setattr(cfg.MODEL.RESNETS, k, v)
    cfg.MODEL.PIXEL_STD = [57.375, 57.12, 58.395]
    return cfg


def stt_cfg(root, out, **solver):
    cfg = narrow(tmicro_cfg(root, "OvrRCNN"))
    cfg.DATASETS.TRAIN = ("coco_zeroshot_train",)
    cfg.DATASETS.TEST = ("coco_zeroshot_val",)
    cfg.OUTPUT_DIR = os.path.join(root, out)
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (3,)
    cfg.SOLVER.MAX_ITER = 4
    for k, v in solver.items():
        setattr(cfg.SOLVER, k, v)
    return cfg


def lsm_cfg(micro_cfg, root, out=""):
    """The image-caption model of tests/test_integration.py's LSM step
    (both heads, distillation, MLM) on the micro tree, narrow."""
    cfg = narrow(micro_cfg(root, "DistillProposalMMSSRCNN"))
    cfg.DATASETS.TRAIN = ("coco_captions_train_seen_proposals",)
    cfg.DATASETS.TEST = ("coco_captions_val",)
    cfg.OUTPUT_DIR = os.path.join(root, out)
    cfg.MODEL.LOAD_OBJ_PROPOSALS = True
    cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = True
    cfg.MODEL.LANGUAGE_BACKBONE.TYPE = "build_bertemb_backbone"
    for k, v in dict(vocab_size=200, hidden_size=16, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=32).items():
        setattr(cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG, k, v)
    cfg.MODEL.MMSS_HEAD.TYPES = ("GroundingHead", "TransformerHead")
    cfg.MODEL.MMSS_HEAD.TIE_VL_PROJECTION_WEIGHTS = True
    cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS = True
    cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = 6
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING = True
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS = "cross_entropy"
    cfg.MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR = True
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.TEST.DO_EVAL = True
    cfg.TEST.IMS_PER_BATCH = 4
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("trainer_micro"))
    make_micro_coco(r)
    fresh_catalogs()
    yield r
    fresh_catalogs()


@pytest.fixture(scope="module")
def stt_run(root):
    """Four STT steps (checkpoints after iterations 1 and 3, the final
    one and the evaluation) with the learning rate and the total loss
    of each step."""
    cfg = stt_cfg(root, "stt", CHECKPOINT_PERIOD=2)
    cfg.TPU.ASYNC_CHECKPOINT = True
    tr = OVRTrainer(cfg, device="cpu")
    tr.resume_or_load(resume=False)
    lrs, losses, step = [], [], tr.train_step

    def recording_step(*a, **k):
        g = tr.optimizer.param_groups[0]
        lrs.append(g["lr"] / g["initial_lr"] * cfg.SOLVER.BASE_LR)
        metrics = step(*a, **k)
        losses.append(float(metrics["total_loss"]))
        return metrics
    tr.train_step = recording_step
    results = tr.train()
    return dict(cfg=cfg, tr=tr, lrs=lrs, losses=losses, results=results)


def test_loop_writes_checkpoints_metrics_and_results(stt_run):
    cfg, tr = stt_run["cfg"], stt_run["tr"]
    out = cfg.OUTPUT_DIR
    names = sorted(n for n in os.listdir(out) if n.startswith("model_"))
    assert names == ["model_0000001", "model_0000003", "model_final"]
    assert tr.checkpointer.last_checkpoint() == "model_0000003"
    rows = [json.loads(ln) for ln in open(os.path.join(out, "metrics.json"))]
    assert [r["iteration"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in rows[1:])
    res = stt_run["results"]["coco_zeroshot_val"]
    assert {"AP", "AP50", "images_per_second"} <= set(res)
    final = tr.checkpointer.load("model_final")
    assert final["iteration"] == 3
    for k, v in tr.model.state_dict().items():
        assert torch.equal(final["model"][k], v), k
    # the prefetch thread is stopped and joined by the teardown
    assert not tr._prefetcher._thread.is_alive()


def test_learning_rate_of_each_iteration_is_jaxs(stt_run):
    s = stt_run["cfg"].SOLVER
    sched = jsolver.warmup_multistep_lr(s.BASE_LR, s.STEPS, s.GAMMA,
                                        s.WARMUP_FACTOR, s.WARMUP_ITERS,
                                        s.WARMUP_METHOD)
    want = [float(sched(it)) for it in range(s.MAX_ITER)]
    np.testing.assert_allclose(stt_run["lrs"], want, rtol=1e-6)
    rows = [json.loads(ln) for ln in open(os.path.join(
        stt_run["cfg"].OUTPUT_DIR, "metrics.json"))]
    np.testing.assert_allclose([r["lr"] for r in rows], want, rtol=1e-6)
    assert want[0] < want[1] < want[2] and want[3] == pytest.approx(
        want[2] * s.GAMMA)


def test_resume_restores_the_state_bit_for_bit(stt_run, root):
    """A second trainer, resumed: the start iteration is the saved one
    plus 1, and before the first step the model (parameters and FrozenBN
    buffers), the momentum buffers and the schedule equal the
    checkpoint's; it then trains on at JAX's learning rate."""
    cfg = stt_run["cfg"]
    cfg2 = stt_cfg(root, "stt", CHECKPOINT_PERIOD=2, MAX_ITER=6)
    tr = OVRTrainer(cfg2, device="cpu")
    tr.resume_or_load(resume=True)
    assert tr.start_iter == 4 and tr.storage.iter == 4
    saved = tr.checkpointer.load("model_0000003")
    sd = tr.model.state_dict()
    assert set(sd) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(sd[k], v), k
    assert any("norm.running_var" in k for k in sd)
    st = tr.optimizer.state_dict()
    assert len(st["state"]) == len(saved["optimizer"]["state"]) > 10
    for i, s in saved["optimizer"]["state"].items():
        assert torch.equal(st["state"][i]["momentum_buffer"],
                           s["momentum_buffer"]), i
    assert tr.scheduler.last_epoch == 4
    s = cfg.SOLVER
    sched = jsolver.warmup_multistep_lr(s.BASE_LR, s.STEPS, s.GAMMA,
                                        s.WARMUP_FACTOR, s.WARMUP_ITERS,
                                        s.WARMUP_METHOD)
    g = tr.optimizer.param_groups[0]
    assert g["lr"] / g["initial_lr"] * s.BASE_LR == pytest.approx(
        float(sched(4)), rel=1e-6)
    tr.train()
    assert tr.checkpointer.last_checkpoint() == "model_0000005"
    # the logged lr is the optimizer's: the restored schedule goes on
    rows = [json.loads(ln) for ln in open(os.path.join(
        cfg2.OUTPUT_DIR, "metrics.json"))]
    resumed = [r["lr"] for r in rows if r["iteration"] >= 4]
    np.testing.assert_allclose(resumed, [float(sched(4)), float(sched(5))],
                               rtol=1e-6)


def test_nan_tripwire_fires_one_step_late(root):
    cfg = stt_cfg(root, "stt_nan")
    cfg.TPU.PREFETCH_BATCHES = 0
    tr = OVRTrainer(cfg, device="cpu")
    calls = []

    def step(batch, class_emb, gen):
        calls.append(1)
        v = float("nan") if len(calls) == 2 else 1.0
        return {"total_loss": torch.tensor(v), "loss_cls": torch.tensor(v)}
    tr.train_step = step
    try:
        for it in range(2):
            tr.storage.iter = it
            tr.run_step()  # iteration 1's NaN is not read yet
        tr.storage.iter = 2
        with pytest.raises(FloatingPointError, match="iteration=1"):
            tr.run_step()
    finally:
        tr.close()


def test_best_metric_save_and_projection_only_load(stt_run, root):
    tr = stt_run["tr"]
    cfg = stt_cfg(root, "stt")
    cfg.TEST.SAVE_MODEL_BEST_METRIC = "coco_zeroshot_val/bbox/AP50"
    tr.cfg = cfg
    tr._best_metric = None
    res = tr.test_and_maybe_save()
    side = json.load(open(os.path.join(cfg.OUTPUT_DIR, "model_best.json")))
    assert side["value"] == res["coco_zeroshot_val"]["AP50"]
    assert side["metric"] == "coco_zeroshot_val/bbox/AP50"
    # PROJECTION_WEIGHTS: only emb_pred moves
    cfg2 = stt_cfg(root, "stt_proj")
    cfg2.MODEL.PROJECTION_WEIGHTS = os.path.join(cfg.OUTPUT_DIR,
                                                 "model_final")
    cfg2.SEED = 5  # other seeded weights than the checkpoint's
    tr2 = OVRTrainer(cfg2, device="cpu")
    tr2.close()
    final = tr.checkpointer.load("model_final")["model"]
    fresh = seeded_init_(tbuild(cfg2, device="cpu"), 5).state_dict()
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(v, final[k] if "emb_pred" in k else fresh[k]), k
    w = "roi_heads.box_predictor.emb_pred.weight"
    assert not torch.equal(final[w], fresh[w])


@pytest.mark.parametrize("key,value,item", [
    ("MODEL.META_ARCHITECTURE", "MMSSGridModel", "item 3"),
    ("TEST.AUG.ENABLED", True, "item 8"),
    ("TPU.INT8_EVAL", True, "item 9")])
def test_trainer_raises_on_what_is_not_ported(root, key, value, item):
    """int8 serving (item 9), which raised here before, evaluates: the
    trainer's ``test`` under the static scheme calibrates the model on
    ``INT8_CALIB_BATCHES`` batches of the test loader once, and not
    again on a second ``test`` (every max-abs is positive then).
    Test-time augmentation (item 8), which raised here before too,
    evaluates: the trainer's ``test`` with
    TEST.AUG.ENABLED at the test size and its flip merges two passes
    (tests/test_torch_tta.py holds TTA to JAX's). The grid models (item
    3), which raised here before too, train: two steps
    of ``MMSSGridModel`` on the micro tree's captions, the final
    checkpoint, and its 'ovr' evaluation, the loss-only pass without a
    detection evaluation (tests/test_torch_grid_models.py holds its
    numbers to JAX's)."""
    if item == "item 3":
        cfg = lsm_cfg(tmicro_cfg, root, "grid_trainer")
        setattr(cfg.MODEL, key.split(".")[-1], value)
        cfg.SOLVER.MAX_ITER = 2
        tr = OVRTrainer(cfg, device="cpu")
        assert type(tr.model).__name__ == "MMSSGridModel"
        res = tr.train()[cfg.DATASETS.TEST[0]]
        assert "Total Loss" in res and not any(k.startswith("AP")
                                               for k in res)
        assert tr.checkpointer.load("model_final")["iteration"] == 1
        rows = [json.loads(ln) for ln in open(os.path.join(
            cfg.OUTPUT_DIR, "metrics.json"))]
        assert np.isfinite(rows[-1]["total_loss"])
        assert "CE_loss (Align Words, Choose Caption)" in rows[-1]
        return
    cfg = stt_cfg(root, "stt_raise")
    node = cfg
    *path, leaf = key.split(".")
    for p in path:
        node = getattr(node, p)
    setattr(node, leaf, value)
    if item == "item 8":
        cfg.TEST.AUG.MIN_SIZES = (cfg.INPUT.MIN_SIZE_TEST,)
        cfg.TEST.AUG.MAX_SIZE = cfg.INPUT.MAX_SIZE_TEST
        tr = OVRTrainer(cfg, device="cpu")
        try:
            res = tr.test(cfg)[cfg.DATASETS.TEST[0]]
        finally:
            tr.close()
        assert res["tta_passes"] == 2  # TEST.AUG.FLIP is on by default
        assert res["tta_merged"] <= res["tta_detections"]
        assert np.isfinite(res["AP50"])
        return
    cfg.TPU.INT8_SCHEME = "static"
    cfg.TPU.INT8_CALIB_BATCHES = 2
    tr = OVRTrainer(cfg, device="cpu")
    calls = []
    calibrate = tr.model.calibrate_int8
    tr.model.calibrate_int8 = lambda *a: calls.append(1) or calibrate(*a)
    try:
        res = tr.test(cfg)[cfg.DATASETS.TEST[0]]
        assert len(calls) == 2
        amax = {k: v.clone() for k, v in tr.model.amax_buffers().items()}
        assert len(amax) == 54 and all(float(v) > 0 for v in amax.values())
        again = tr.test(cfg)[cfg.DATASETS.TEST[0]]
        assert len(calls) == 2
        for k in ("AP", "AP50"):
            assert again[k] == res[k]
        assert all(torch.equal(v, amax[k])
                   for k, v in tr.model.amax_buffers().items())
    finally:
        tr.close()
    assert np.isfinite(res["AP50"])


def _first_steps(root, out, n_steps=2, **tpu):
    """The total loss of the first ``n_steps`` steps of an STT trainer of
    ``stt_cfg`` with the ``TPU`` options ``tpu``."""
    cfg = stt_cfg(root, out)
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    tr = OVRTrainer(cfg, device="cpu")
    try:
        losses = []
        for it in range(n_steps):
            tr.storage.iter = it
            losses.append(float(tr.train_step(
                to_torch(next(tr._train_iter), "cpu"), tr.class_emb,
                tr.generator)["total_loss"]))
        return tr, losses
    finally:
        tr.close()


def _accumulation_resumes(root):
    """k = 2 through the loop: a checkpoint an iteration, then a resume
    after iteration 2 (the first micro-step of the second update)."""
    cfg = stt_cfg(root, "stt_accum", CHECKPOINT_PERIOD=1, MAX_ITER=3,
                  GRADIENT_ACCUMULATION_STEPS=2)
    tr = OVRTrainer(cfg, device="cpu")
    assert isinstance(tr.optimizer, tsolver.MultiSteps)
    tr.resume_or_load(resume=False)
    tr.train()
    ck = tr.checkpointer
    saved1, saved2 = ck.load("model_0000001"), ck.load("model_0000002")
    # the micro-step after an update only accumulates
    for k, v in saved1["model"].items():
        assert torch.equal(v, saved2["model"][k]), k
    assert saved2["optimizer"]["multi_steps"]["mini_step"] == 1
    assert saved1["optimizer"]["multi_steps"]["mini_step"] == 0
    cfg2 = stt_cfg(root, "stt_accum", CHECKPOINT_PERIOD=1, MAX_ITER=4,
                   GRADIENT_ACCUMULATION_STEPS=2)
    tr2 = OVRTrainer(cfg2, device="cpu")
    tr2.resume_or_load(resume=True)
    assert tr2.start_iter == 3 and tr2.optimizer.mini_step == 1
    for a, b in zip(tr2.optimizer.acc,
                    saved2["optimizer"]["multi_steps"]["acc_grads"]):
        assert torch.equal(a, b)
    assert tr2.scheduler.last_epoch == 1
    tr2.train()
    moved = tr2.checkpointer.load("model_0000003")["model"]
    assert any(not torch.equal(v, saved2["model"][k])
               for k, v in moved.items() if "weight" in k)
    rows = [json.loads(ln) for ln in open(os.path.join(cfg.OUTPUT_DIR,
                                                       "metrics.json"))]
    jcfg = jget()
    for k in ("BASE_LR", "WARMUP_ITERS", "STEPS", "GAMMA", "WARMUP_FACTOR",
              "WARMUP_METHOD"):
        setattr(jcfg.SOLVER, k, getattr(cfg.SOLVER, k))
    jcfg.SOLVER.GRADIENT_ACCUMULATION_STEPS = 2
    _, sched = jsolver.build_optimizer(jcfg, {"w": jnp.zeros(1)})
    np.testing.assert_allclose([r["lr"] for r in rows],
                               [float(sched(r["iteration"])) for r in rows],
                               rtol=1e-6)
    assert [r["iteration"] for r in rows] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["debug_nans", "global_scope", "remat",
                                  "accumulation"])
def test_trainer_runs_what_was_not_ported(stt_run, root, case):
    """The options that raised here before (ROADMAP queue 1, items 6 and
    7b): NaN debugging turns on autograd's anomaly mode; the global
    scope on one process and the remat trunk give the losses of
    ``stt_run``'s first steps (rtol 1e-6: the same arithmetic); gradient
    accumulation updates every k-th iteration, resumes in the middle of
    an accumulation bit for bit and logs JAX's learning rate."""
    if case == "accumulation":
        _accumulation_resumes(root)
        return
    if case == "debug_nans":
        try:
            tr, _ = _first_steps(root, "stt_nans", 1, DEBUG_NANS=True)
            assert torch.is_anomaly_enabled()
        finally:
            torch.autograd.set_detect_anomaly(False)
        return
    tpu = ({"CONTRASTIVE_SCOPE": "global"} if case == "global_scope"
           else {"REMAT_BACKBONE": True})
    tr, losses = _first_steps(root, f"stt_{case}", **tpu)
    if case == "remat":
        assert tr.model.backbone.remat
    np.testing.assert_allclose(losses, stt_run["losses"][:2], rtol=1e-6)


def test_build_optimizer_overrides(root):
    """JAX's ``overrides``: a name substring sets an absolute lr and a
    weight decay; a Flax path's ``/`` reads as ``.``."""
    cfg = stt_cfg(root, "unused")
    model = tbuild(cfg, device="cpu")
    opt, _ = tsolver.build_optimizer(cfg, model, overrides={
        "box_predictor/bbox_pred": {"lr": 0.5, "weight_decay": 0.0},
        "rpn_head": {"weight_decay": 0.25}})
    by_param = {id(p): g for g in opt.param_groups for p in g["params"]}
    s = cfg.SOLVER
    for name, p in model.named_parameters():
        if id(p) not in by_param:
            continue
        g = by_param[id(p)]
        if "bbox_pred" in name:
            assert (g["initial_lr"], g["weight_decay"]) == (0.5, 0.0), name
        elif name.startswith("rpn_head."):
            assert g["weight_decay"] == 0.25, name
            assert g["initial_lr"] == pytest.approx(s.BASE_LR * (
                s.BIAS_LR_FACTOR if name.endswith("bias") else 1.0)), name


def test_prefetcher_keeps_the_bytes_and_closes():
    rng = np.random.RandomState(0)
    batches = [tb.DetectionBatch(images=tb.ImageBatch(
        image=rng.rand(2, 8, 8, 3).astype(np.float32),
        hw=np.full((2, 2), 8, np.int32), orig_hw=np.full((2, 2), 8, np.int32),
        image_id=np.arange(2, dtype=np.int64))) for _ in range(3)]
    got = list(DevicePrefetcher(iter(batches), "cpu", depth=2))
    assert len(got) == 3
    for g, b in zip(got, batches):
        want = to_torch(b, "cpu")
        for x, y in zip(g.images, want.images):
            assert x.dtype == y.dtype and torch.equal(x, y)

    def forever():
        while True:
            yield batches[0]
    pf = DevicePrefetcher(forever(), "cpu", depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_writers_write_jaxs_bytes(tmp_path):
    lines = {"j": [], "t": []}
    for tag, ev in (("j", jevents), ("t", tevents)):
        st = ev.EventStorage(0)
        writers = [ev.JSONWriter(str(tmp_path / tag / "metrics.json")),
                   ev.CSVWriter(str(tmp_path / tag / "metrics.csv"),
                                epoch_size=2),
                   ev.MetricPrinter(5, logger=lines[tag].append)]
        for it in range(4):
            st.iter = it
            st.put_scalars(total_loss=1.0 / (it + 1), lr=0.1 * it,
                           time=0.5, data_time=0.25)
            st.put_scalar("loss_cls", 2.0)  # repeated: suppressed in CSV
            if it == 2:  # a metric group that appears late
                st.put_scalar("coco_zeroshot_val/AP50", 12.5)
            for w in writers:
                w.write(st)
    for f in ("metrics.json", "metrics.csv"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    assert lines["t"] == lines["j"] and len(lines["t"]) == 4


def _lsm_keys_jax(root):
    """JAX's train-step metric keys of ``lsm_cfg``'s model, from the
    shapes of its loss function (no compilation)."""
    jm = jbuild(lsm_cfg(jmicro_cfg, root))
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    batch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                      jb.DetectionBatch, jnp.asarray)
    ce = jnp.asarray(arrays["class_emb"])
    key = jax.random.PRNGKey(0)

    def keys():
        v = jm.init(key, batch, ce, key, method=jm.losses)
        outputs, losses = jm.apply(v, batch, ce, key, method=jm.losses)
        return {**losses, **outputs, "total_loss": 0.0}
    return set(jax.eval_shape(keys))


@pytest.mark.parametrize("stage", ["stt", "lsm"])
def test_logged_metric_keys_are_jaxs(request, root, stage):
    """A row of metrics.json holds JAX's keys: its train step's metrics
    and its ``run_step``'s timers and learning rate."""
    if stage == "stt":
        cfg = request.getfixturevalue("stt_run")["cfg"]
        want = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
                "total_loss"}
    else:
        cfg = lsm_cfg(tmicro_cfg, root, "keys_lsm")
        cfg.SOLVER.MAX_ITER = 2
        cfg.DATASETS.TEST = ()
        want = _lsm_keys_jax(root)
        assert {"CE_loss (Align Words, Choose Caption)",
                "Masked Language Modeling Loss", "kd_loss", "box_kd_loss",
                "mixbox_kd_loss", "loss_rpn_cls"} <= want
        OVRTrainer(cfg, device="cpu").train()
    rows = [json.loads(ln) for ln in open(os.path.join(cfg.OUTPUT_DIR,
                                                       "metrics.json"))]
    assert set(rows[-1]) == want | {"iteration", "data_time", "time", "lr"}


@pytest.fixture(scope="module")
def lsm_loss_eval():
    """The tiny LSM model of tests/test_torch_lsm_step.py with JAX's
    weights, and two batches."""
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    flipped = dict(arrays, image=arrays["image"][:, :, ::-1].copy())
    jm = jbuild(tiny_lsm_cfg(jget, jpath))
    jbatches = [lsm_batch(a, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                          jb.DetectionBatch, jnp.asarray)
                for a in (arrays, flipped)]
    key = jax.random.PRNGKey(1)
    ce = jnp.asarray(arrays["class_emb"])
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jbatches[0], ce, key)
    from torch_parity import flat_params
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    from locov_tpu.utils.checkpoint import unflatten_params
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}
    tm = tbuild(tiny_lsm_cfg(tget, tpath), device="cpu")
    tm.load_state_dict(from_flax(flat), strict=True)
    tbatches = [lsm_batch(a, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                          tb.DetectionBatch, np.asarray)
                for a in (arrays, flipped)]
    return dict(jm=jm, v=v, jbatches=jbatches, tm=tm, tbatches=tbatches,
                ce=arrays["class_emb"])


def test_loss_only_evaluation_matches_jax(lsm_loss_eval):
    """``inference_on_caption_dataset`` over two batches: JAX's through
    its loss step on a one-device mesh (its per-batch key folded with
    device 0), the port's through ``make_loss_eval_step`` with the draws
    of those keys."""
    p = lsm_loss_eval
    rng = jax.random.PRNGKey(3)
    jstep = jmake_loss_eval_step(p["jm"], get_mesh(jax.devices()[:1]))
    want_m, want_l = jev.inference_on_caption_dataset(
        jstep, p["v"], p["jbatches"], jnp.asarray(p["ce"]), rng)

    draws = []
    for _ in p["tbatches"]:
        rng, k = jax.random.split(rng)
        draws.append(loss_uniforms(jax.random.fold_in(k, 0)))
    tstep = make_loss_eval_step(p["tm"])
    seen = iter(draws)

    def step(batch, class_emb, generator):
        return tstep(batch, class_emb, generator, uniforms=next(seen))
    got_m, got_l = tev.inference_on_caption_dataset(
        step, None, p["tbatches"], torch.from_numpy(p["ce"]),
        torch.Generator())
    assert set(got_m) == set(want_m) and set(got_l) == set(want_l)
    assert "Total Loss" in got_l and len(got_l) > 15 and len(got_m) > 10
    for want, got in ((want_m, got_m), (want_l, got_l)):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert got_l["Total Loss"] == pytest.approx(
        sum(v for k, v in got_l.items() if k != "Total Loss"), rel=1e-12)


def test_loss_eval_step_has_no_autograd_and_uses_the_generator(
        lsm_loss_eval):
    step = make_loss_eval_step(lsm_loss_eval["tm"])
    ce = torch.from_numpy(lsm_loss_eval["ce"])
    a = step(lsm_loss_eval["tbatches"][0], ce,
             torch.Generator().manual_seed(7))
    b = step(lsm_loss_eval["tbatches"][0], ce,
             torch.Generator().manual_seed(7))
    assert all(not v.requires_grad for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)  # the same draws
    assert step.device == torch.device("cpu")
