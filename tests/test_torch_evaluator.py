"""PyTorch port vs JAX: detection evaluation end to end
(``locov_torch/evaluation/evaluator.py``, ``parallel/mesh.py:
make_eval_step``, ``engine/trainer.py:test``).

A tiny float32 OvrRCNN (the parity tests' narrow trunk on ``micro_cfg``)
gets JAX's weights through ``from_flax``. JAX's
``inference_on_detection_dataset`` runs through its ``make_eval_step``
on the 8-device CPU mesh; the port's through its own step, one device,
on the same micro-COCO tree (12 val images in two orientations, so two
buckets, each ending in a padded batch).

The random-init model is tamed as in tests/test_torch_ovr_rcnn.py: the
RPN's anchor deltas are zero (proposals are anchors, here 16 and 32 px
to suit 64-72 px images), a torchvision-like pixel std, and class
embeddings x0.1 (written so into the tree's embedding files) so that
the class scores spread; 50 detections an image keep every class in play.

Tolerances: flat detections (image ids and dataset class ids equal,
boxes atol 1e-3 px, scores atol 1e-5, as test_torch_ovr_rcnn.py); the
port's evaluator on JAX's detections gives JAX's summary exactly; the
end-to-end AP keys agree within 1e-6 AP points: the two packages' scores
differ by ~1e-6 and their boxes by ~1e-5 px here, too little to reorder
a ranking or move an IoU across a threshold, so the summaries are the
same numbers.
"""
import json
import multiprocessing as mp
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.data import DatasetCatalog as JCat
from locov_tpu.data import MetadataCatalog as JMeta
from locov_tpu.data import get_register_dataset as jregister
from locov_tpu.data import loader as jloader
from locov_tpu.data.mappers import DetectionMapper as JMapper
from locov_tpu.data.synthetic import micro_cfg as jmicro_cfg
from locov_tpu.evaluation import evaluator as jev
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.parallel import get_mesh
from locov_tpu.parallel import make_eval_step as jmake_eval_step
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.data import DatasetCatalog as TCat
from locov_torch.data import MetadataCatalog as TMeta
from locov_torch.data.synthetic import make_micro_coco
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.engine import trainer as ttrainer
from locov_torch.evaluation import evaluator as tev
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import make_eval_step as tmake_eval_step
from locov_torch.structures.batches import Detections
from locov_torch.utils.weights import from_flax
from test_torch_eval_helpers import (fresh_catalogs, gloo_caption_worker,
                                     gloo_eval_worker, synth_eval_step,
                                     synthetic_caption_eval, synthetic_eval)
from torch_parity import flat_params

NAME = "coco_zeroshot_val"
AP_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10",
           "AR@100", "AP50-seen", "AP50-unseen", "AP-seen", "AP-unseen")
LVIS_KEYS = ("AP", "AP50", "AP75", "APr", "APc", "APf", "AR@300")
AP_TOL = 1e-6
TAME = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.PIXEL_STD": [57.375, 57.12, 58.395],
    "MODEL.ANCHOR_GENERATOR.SIZES": [[16, 32]],
    "MODEL.RPN.POST_NMS_TOPK_TEST": 32,
    "TEST.DETECTIONS_PER_IMAGE": 50,
}


def eval_cfg(micro_cfg, root, datasets=(NAME,)):
    cfg = micro_cfg(root)
    for key, value in TAME.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    cfg.DATASETS.TEST = tuple(datasets)
    return cfg


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_micro"))
    make_micro_coco(root, n_val=12)
    for kind in ("coco", "lvis_v1"):
        emb = os.path.join(root, "datasets_data", "embeddings",
                           f"{kind}_nouns_bertemb.json")
        with open(emb) as f:
            vecs = json.load(f)
        with open(emb, "w") as f:
            json.dump({k: [0.1 * x for x in v] for k, v in vecs.items()},
                      f)
    return root


@pytest.fixture(scope="module")
def pair(micro):
    """Both packages' models (JAX's weights in the port), steps and
    loaders on ``NAME``, and each package's flat detections."""
    fresh_catalogs()
    jcfg, tcfg = eval_cfg(jmicro_cfg, micro), eval_cfg(tmicro_cfg, micro)
    jregister(NAME)(NAME, micro)
    records, meta = JCat.get(NAME), JMeta.get(NAME)

    def jax_loader(name=NAME):
        jregister(name)(name, micro)
        return jloader.DataLoader(
            JCat.get(name), JMapper(jcfg, JMeta.get(name), False, seed=0),
            jloader.InferenceSampler(len(JCat.get(name))), 8,
            jloader.derive_buckets(jcfg, False), jcfg.TPU.MAX_GT_BOXES,
            has_text=False, is_train=False, seed=0)

    ce = jnp.asarray(meta.class_emb_mtx)
    jm = jbuild(jcfg)
    first = next(iter(jax_loader()))
    v = jax.jit(lambda b, c: jm.init(jax.random.PRNGKey(0), b, c,
                                     method=jm.inference))(first, ce)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}
    jstep = jmake_eval_step(jm, get_mesh())
    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(from_flax(flat), strict=True)
    tstep = tmake_eval_step(tm)
    jflat, _ = jev.collect_detections(jstep, v, jax_loader(), ce,
                                      jev.dataset_id_lut(meta))
    with ttrainer.build_test_loader(tcfg, NAME, None, False) as tl:
        tflat, _ = tev.collect_detections(
            tstep, None, tl, ttrainer.load_embeddings(tcfg, NAME, "cpu"),
            tev.dataset_id_lut(TMeta.get(NAME)))
    yield dict(jcfg=jcfg, tcfg=tcfg, jm=jm, v=v, jstep=jstep, tm=tm,
               tstep=tstep, jflat=jflat, tflat=tflat, ce=ce,
               records=records, jax_loader=jax_loader)
    fresh_catalogs()


def _assert_ap_keys(want, got, keys):
    for k in keys:
        if k not in want:
            assert k not in got, k
        elif np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])


def test_flat_detections_match_jax(pair):
    jf, tf = pair["jflat"], pair["tflat"]
    assert len(tf["img"]) > 300  # every real image, many detections
    np.testing.assert_array_equal(tf["img"], jf["img"])
    np.testing.assert_array_equal(tf["cls"], jf["cls"])
    np.testing.assert_allclose(tf["box"], jf["box"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tf["score"], jf["score"], rtol=0, atol=1e-5)
    assert set(tf["img"]) == {r["image_id"] for r in pair["records"]}
    assert {tf[k].dtype for k in tf} == {np.dtype(np.int64),
                                         np.dtype(np.float64)}
    assert set(np.unique(tf["cls"])) <= {1, 2, 3}  # dataset ids


def test_port_evaluator_on_jax_detections_equals_jax(pair):
    """The scoring half alone: JAX's flat detections through each
    package's evaluator and seen/unseen summary give the same dict."""
    out = []
    for ev, meta in ((jev, JMeta.get(NAME)), (tev, TMeta.get(NAME))):
        evaluator = ev.build_evaluator_for(NAME)
        ev.score_detections(evaluator, pair["jflat"])
        out.append(ev.add_seen_unseen_summary(
            evaluator.summarize(per_category=True), meta))
    want, got = out
    assert set(want) == set(got)
    for k, v in want.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, k


def test_end_to_end_ap_matches_jax(pair):
    """``engine/trainer.py:test`` on the CPU against JAX's
    ``inference_on_detection_dataset`` through its mesh step."""
    want = jev.inference_on_detection_dataset(
        pair["jstep"], pair["v"], pair["jax_loader"](), pair["ce"], NAME)
    got = ttrainer.test(pair["tcfg"], pair["tm"], "cpu")[NAME]
    _assert_ap_keys(want, got, AP_KEYS)
    assert got["AP50"] > 0 and got["AP50-unseen"] > 0
    assert got["images_per_second"] > 0
    parts = [got[f"seconds_{k}"] for k in ("loader_wait", "h2d",
                                            "inference", "d2h",
                                            "evaluator")]
    assert all(p >= 0 for p in parts)
    assert sum(parts) <= got["seconds_total"]


def test_end_to_end_lvis_matches_jax(pair, micro):
    """The LVIS protocol through the same steps (the micro tree's LVIS
    annotations are over the same val images)."""
    name = "lvis_v1_generalized_val"
    jregister(name)(name, micro)
    ce = jnp.asarray(JMeta.get(name).class_emb_mtx)
    want = jev.inference_on_detection_dataset(
        pair["jstep"], pair["v"], pair["jax_loader"](name), ce, name)
    tcfg = eval_cfg(tmicro_cfg, micro, (name,))
    got = ttrainer.test(tcfg, pair["tm"], "cpu")[name]
    assert ttrainer.load_embeddings(tcfg, name, "cpu").shape == (4, 16)
    _assert_ap_keys(want, got, LVIS_KEYS)


def test_gt_oracle_reads_100(pair):
    """The gt boxes as detections (score 1, dataset ids) through
    ``score_detections`` and ``add_seen_unseen_summary``."""
    name = "coco_generalized_zeroshot_val"
    ttrainer.load_embeddings(pair["tcfg"], name, "cpu")  # registers
    meta = TMeta.get(name)
    inv = tev.dataset_id_lut(meta)
    img, box, cls = [], [], []
    for r in TCat.get(name):
        for a in r["annotations"]:
            img.append(r["image_id"])
            box.append(a["bbox"])
            cls.append(inv[a["category_id"]])
    flat = {"img": np.asarray(img, np.int64),
            "box": np.asarray(box, np.float64),
            "score": np.ones(len(img)), "cls": np.asarray(cls, np.int64)}
    evaluator = tev.build_evaluator_for(name)
    tev.score_detections(evaluator, flat)
    res = tev.add_seen_unseen_summary(
        evaluator.summarize(per_category=True), meta)
    for k in ("AP", "AP50", "AP75", "AP50-seen", "AP50-unseen"):
        assert res[k] == pytest.approx(100.0, abs=1e-9), k


def test_make_eval_step_moves_the_batch(pair):
    """The step takes a numpy batch (moved to the model's device) and
    gives the model's detections, without autograd state."""
    batch = next(iter(pair["jax_loader"]()))
    ce = torch.from_numpy(np.array(pair["ce"]))
    dets = pair["tstep"](batch, ce)
    assert isinstance(dets, Detections) and dets.boxes.shape == (8, 50, 4)
    assert not dets.scores.requires_grad and dets.scores.is_inference()
    assert pair["tstep"].device == torch.device("cpu")


def test_gather_fn_merges_shards_like_one_process(micro):
    """As tests/test_multihost_eval.py does for JAX: two shards' local
    detections, merged by an injected ``gather_fn``, give the single
    process's metrics on each shard."""
    fresh_catalogs()
    name = "coco_generalized_zeroshot_val"
    single = synthetic_eval(micro, name, 4)
    recs = TCat.get(name)
    step = synth_eval_step(recs, len(TMeta.get(name).thing_classes))
    shards = [recs[:5], recs[5:]]

    def loader(shard):  # batches of 4, the last one padded
        from locov_torch.data.loader import collate
        out = []
        for i in range(0, len(shard), 4):
            chunk = [dict(image=np.zeros((8, 8, 3), np.uint8),
                          hw=np.array([8, 8], np.int32),
                          orig_hw=np.array([8, 8], np.int32),
                          image_id=np.int64(r["image_id"]),
                          gt_boxes=np.zeros((0, 4), np.float32),
                          gt_classes=np.zeros(0, np.int32))
                     for r in shard[i:i + 4]]
            while len(chunk) < 4:
                chunk.append({**chunk[-1], "image_id": np.int64(-1)})
            out.append(collate(chunk, (8, 8), 2, False))
        return out

    local = []
    for shard in shards:
        tev.inference_on_detection_dataset(
            step, None, loader(shard), None, name,
            gather_fn=lambda f: local.append(f) or {k: v[:0]
                                                    for k, v in f.items()})
    merged = {k: np.concatenate([f[k] for f in local]) for k in local[0]}
    for shard in shards:
        res = tev.inference_on_detection_dataset(
            step, None, loader(shard), None, name,
            gather_fn=lambda f: merged)
        _assert_ap_keys(single, res, AP_KEYS)
    assert single["AP"] > 0
    fresh_catalogs()


def test_gather_host_detections_is_identity_in_one_process():
    flat = {"img": np.arange(3), "box": np.zeros((3, 4))}
    assert tev.gather_host_detections(flat) is flat
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_eval_equals_single_process(micro, tmp_path):
    """Two processes (``torch.distributed``, gloo) each evaluate their
    shard of the loader (``build_test_loader`` shards by rank) and merge
    the detections in ``gather_host_detections``: each gets the single
    process's metrics."""
    fresh_catalogs()
    name = "coco_generalized_zeroshot_val"
    single = synthetic_eval(micro, name, 4)
    fresh_catalogs()
    ctx = mp.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=gloo_eval_worker,
                         args=(r, 2, port, micro, name, 4, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0
    for out in outs:
        with open(out) as f:
            res = json.load(f)
        _assert_ap_keys(single, res, AP_KEYS)
    assert single["AP"] > 0


def test_select_evaluator_type_matches_jax():
    for arch in ("OvrRCNN", "DistillProposalMMSSRCNN", "MMSSGridModel"):
        for name in ("coco_zeroshot_val", "lvis_v1_novel_val"):
            jc, tc = jmicro_cfg("."), tmicro_cfg(".")
            jc.MODEL.META_ARCHITECTURE = tc.MODEL.META_ARCHITECTURE = arch
            assert tev.select_evaluator_type(tc, name) == \
                jev.select_evaluator_type(jc, name)


def test_test_raises_on_what_is_not_ported(pair, micro):
    # test-time augmentation (item 8), which raised here before, runs:
    # one pass at the test size, unflipped (tests/test_torch_tta.py holds
    # TTA to JAX's)
    cfg = eval_cfg(tmicro_cfg, micro)
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES = (cfg.INPUT.MIN_SIZE_TEST,)
    cfg.TEST.AUG.MAX_SIZE = cfg.INPUT.MAX_SIZE_TEST
    cfg.TEST.AUG.FLIP = False
    res = ttrainer.test(cfg, pair["tm"], "cpu")[NAME]
    assert res["tta_passes"] == 1 and res["AP50"] > 0
    # the int8 serving mode (item 9), which raised here before, evaluates:
    # the dynamic scheme on the port's model with JAX's weights
    # (tests/test_torch_int8_*.py hold it to JAX's)
    cfg = eval_cfg(tmicro_cfg, micro)
    cfg.TPU.INT8_EVAL = True
    tm8 = tbuild(cfg, device="cpu")
    tm8.load_state_dict(pair["tm"].state_dict(), strict=True)
    res = ttrainer.test(cfg, tm8, "cpu")[NAME]
    assert np.isfinite(res["AP"]) and res["AP50"] > 0
    # the grid models, which raised here before: their 'ovr' evaluation
    # is the loss-only pass alone, no detection evaluation
    # (tests/test_torch_grid_models.py holds its numbers to JAX's)
    from test_torch_trainer import lsm_cfg
    cfg = lsm_cfg(tmicro_cfg, micro)
    cfg.MODEL.META_ARCHITECTURE = "DistillMMSSGridModel"
    cfg.TEST.IMS_PER_BATCH = 4
    model = tbuild(cfg, device="cpu")
    res = ttrainer.test(cfg, model, "cpu")
    name = cfg.DATASETS.TEST[0]
    assert tev.select_evaluator_type(cfg, name) == "ovr"
    assert not any(k.startswith("AP") for k in res[name])
    assert {"Total Loss", "kd_loss"} <= set(res[name])
    assert all(np.isfinite(v) for v in res[name].values()
               if isinstance(v, float))


def test_two_rank_loss_evaluation_is_the_union(micro, tmp_path):
    """Two gloo processes each run the loss-only evaluation over their
    shard of the captions loader (batch 1) and merge their sums and
    batch counts: each gets the one-process averages over all the
    images, within rtol 1e-12 (float64 sums in another order)."""
    fresh_catalogs()
    name = "coco_captions_val"
    single = synthetic_caption_eval(micro, name)
    fresh_catalogs()
    ctx = mp.get_context("spawn")
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=gloo_caption_worker,
                         args=(r, 2, port, micro, name, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0
    for out in outs:
        with open(out) as f:
            metrics, losses = json.load(f)
        for got, want in ((metrics, single[0]), (losses, single[1])):
            assert set(got) == set(want) and want
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           err_msg=k)
