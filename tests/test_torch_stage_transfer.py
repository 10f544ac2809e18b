"""PyTorch port vs JAX: the LSM -> STT stage hand-off
(``locov_torch/utils/checkpoint.py:load_weights_standalone`` with
``STT_FROM_LSM_RENAME``; JAX: ``load_with_rename_map`` as
``OVRTrainer.load_pretrained`` applies it).

One set of tiny LSM parameters (coco_lsm.yaml at the parity tests'
narrow widths, seeded, in Flax names) is handed to the tiny STT model
by each package: JAX renames them over its STT parameters; the port
loads them into its LSM model (``from_flax``), saves a checkpoint with
its ``Checkpointer`` and imports that file into its STT model. The STT
detections over the micro-COCO val images must agree within the bounds
of the evaluation tests (tests/test_torch_evaluator.py): the same image
and class ids, boxes within 1e-3 px, scores within 1e-5. Both trunks
sum float32 convolutions in their own orders; here the boxes differ by
up to 6.9e-5 px and the scores not at all (the evaluation tests' own
model: 7.6e-6 px and 6.0e-7, which are not bounds: another seeding of
these weights gave 1.9e-5 px and 1.0e-5). The import reports agree (JAX's names through
``from_flax``'s naming), res5 and the projection are the LSM's bit for
bit, and the STT model has no ``backbone.res5`` (the C4 trunk stops at
res4 in both packages), so the fan-out's first destination is absent.

The STT model is tamed as in tests/test_torch_evaluator.py: zero RPN
anchor deltas, 16 and 32 px anchors, a torchvision-like pixel std and
class embeddings x0.1.
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
from locov_tpu.structures import batches as jb
from locov_tpu.utils import checkpoint as jck
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.data import MetadataCatalog as TMeta
from locov_torch.data.synthetic import make_micro_coco
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.engine import trainer as ttrainer
from locov_torch.evaluation import evaluator as tev
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import make_eval_step as tmake_eval_step
from locov_torch.utils import checkpoint as tck
from locov_torch.utils.weights import from_flax, torch_name
from test_torch_eval_helpers import fresh_catalogs
from test_torch_evaluator import TAME, eval_cfg
from torch_parity import (lsm_batch, tiny_lsm_arrays, tiny_lsm_cfg,
                          two_threads)  # noqa: F401 (autouse)

NAME = "coco_zeroshot_val"
BOX_TOL, SCORE_TOL = 1e-3, 1e-5  # tests/test_torch_evaluator.py's


def seeded_flax(shapes, seed):
    """Flax-named arrays for the shapes of ``jax.eval_shape(init)``, at
    the scales of JAX's initialisers: conv kernels He-normal over
    fan-out, the RPN's N(0, 0.01), ``bbox_pred`` N(0, 0.001), other
    dense kernels over fan-in, embedding tables N(0, 0.02), norms the
    identity, biases 0; the RPN's anchor deltas 0 (the proposals are
    the anchors)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in sorted(jck.flatten_params(shapes["params"]).items()):
        leaf = k.rsplit("/", 1)[-1]
        if "anchor_deltas" in k:
            v = np.zeros(s.shape)
        elif leaf == "kernel" and ("rpn_head/" in k or "bbox_pred/" in k):
            v = rng.randn(*s.shape) * (0.001 if "bbox_pred" in k else 0.01)
        elif leaf == "kernel" and len(s.shape) == 4:
            std = (2.0 / (s.shape[0] * s.shape[1] * s.shape[3])) ** 0.5
            v = rng.randn(*s.shape) * std
        elif leaf == "kernel":
            v = rng.randn(*s.shape) * s.shape[0] ** -0.5
        elif leaf in ("scale", "running_var") or (
                leaf == "weight" and "_norm/" in k):
            v = np.ones(s.shape)
        elif "embeddings" in leaf:
            v = rng.randn(*s.shape) * 0.02
        else:
            v = np.zeros(s.shape)
        out[k] = v.astype(np.float32)
    return out


def _lsm_cfg(get_cfg, config_path, root):
    cfg = tiny_lsm_cfg(get_cfg, config_path)
    cfg.DATASETS.ROOT = root
    # the STT model's anchors, so that the RPN head (same names in both
    # models) is handed over too
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = TAME["MODEL.ANCHOR_GENERATOR.SIZES"]
    return cfg


def _stt_cfg(micro_cfg, root):
    cfg = eval_cfg(micro_cfg, root)
    cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = True
    cfg.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED = True
    return cfg


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage_micro"))
    make_micro_coco(root, n_val=12)
    emb = os.path.join(root, "datasets_data", "embeddings",
                       "coco_nouns_bertemb.json")
    with open(emb) as f:
        vecs = json.load(f)
    with open(emb, "w") as f:
        json.dump({k: [0.1 * x for x in v] for k, v in vecs.items()}, f)
    fresh_catalogs()

    # one set of LSM parameters, in Flax names
    jlsm = jbuild(_lsm_cfg(jget, jpath, root))
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    batch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                      jb.DetectionBatch, jnp.asarray)
    key = jax.random.PRNGKey(0)
    lsm_flat = seeded_flax(jax.eval_shape(
        lambda: jlsm.init(key, batch, jnp.asarray(arrays["class_emb"]),
                          key, method=jlsm.losses)), 1)

    # the STT model's own parameters, tamed
    jcfg, tcfg = _stt_cfg(jmicro_cfg, root), _stt_cfg(tmicro_cfg, root)
    jregister(NAME)(NAME, root)
    meta = JMeta.get(NAME)

    def jax_loader():
        return jloader.DataLoader(
            JCat.get(NAME), JMapper(jcfg, meta, False, seed=0),
            jloader.InferenceSampler(len(JCat.get(NAME))), 8,
            jloader.derive_buckets(jcfg, False), jcfg.TPU.MAX_GT_BOXES,
            has_text=False, is_train=False, seed=0)
    ce = jnp.asarray(meta.class_emb_mtx)
    jstt = jbuild(jcfg)
    first = next(iter(jax_loader()))
    stt_flat = seeded_flax(jax.eval_shape(
        lambda: jstt.init(key, first, ce, method=jstt.inference)), 2)

    # JAX: the rename fan-out over its STT parameters
    merged, jrep = jck.load_with_rename_map(lsm_flat, stt_flat,
                                            jck.STT_FROM_LSM_RENAME)
    v = {"params": jck.unflatten_params({k: jnp.asarray(a)
                                         for k, a in merged.items()})}
    jflat, _ = jev.collect_detections(jmake_eval_step(jstt, get_mesh()), v,
                                      jax_loader(), ce,
                                      jev.dataset_id_lut(meta))

    # the port: LSM model -> checkpoint file -> STT model
    tlsm = tbuild(_lsm_cfg(tget, tpath, root), device="cpu")
    tlsm.load_state_dict(from_flax(lsm_flat), strict=True)
    ck = tck.Checkpointer(os.path.join(root, "lsm_out"))
    ck.save_named("model_final", {"model": tlsm.state_dict(),
                                  "iteration": 0})
    ck.wait()
    tstt = tbuild(tcfg, device="cpu")
    tstt.load_state_dict(from_flax(stt_flat), strict=True)
    trep = tck.load_weights_standalone(
        tstt, os.path.join(root, "lsm_out", "model_final"),
        report_dir=os.path.join(root, "stt_out"))
    with ttrainer.build_test_loader(tcfg, NAME, None, False) as tl:
        tflat, _ = tev.collect_detections(
            tmake_eval_step(tstt), None, tl,
            ttrainer.load_embeddings(tcfg, NAME, "cpu"),
            tev.dataset_id_lut(TMeta.get(NAME)))
    yield dict(root=root, lsm_flat=lsm_flat, jrep=jrep, trep=trep,
               jflat=jflat, tflat=tflat, tlsm=tlsm, tstt=tstt)
    fresh_catalogs()


def test_handoff_detections_match_jax(handoff):
    jf, tf = handoff["jflat"], handoff["tflat"]
    assert len(tf["img"]) > 200 and len(set(tf["img"])) == 12
    np.testing.assert_array_equal(tf["img"], jf["img"])
    np.testing.assert_array_equal(tf["cls"], jf["cls"])
    np.testing.assert_allclose(tf["box"], jf["box"], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(tf["score"], jf["score"], rtol=0,
                               atol=SCORE_TOL)


def test_handoff_report_matches_jax(handoff):
    jrep, trep = handoff["jrep"], handoff["trep"]
    for f in ("loaded", "missing", "unused_src"):
        assert sorted(getattr(trep, f)) == \
            sorted(torch_name(k) for k in getattr(jrep, f)), f
    assert trep.mismatched == jrep.mismatched == []
    with open(os.path.join(handoff["root"], "stt_out",
                           "import_report.json")) as f:
        assert json.load(f) == trep.asdict(os.path.join(
            handoff["root"], "lsm_out", "model_final"))


def test_handoff_takes_res5_and_the_projection(handoff):
    lsm, stt = handoff["tlsm"].state_dict(), handoff["tstt"].state_dict()
    res5 = [k for k in lsm if k.startswith("roi_heads.res5.")]
    assert len(res5) > 40
    for k in res5:
        assert torch.equal(stt[k], lsm[k]), k
        assert stt[k].data_ptr() != lsm[k].data_ptr()
    for leaf in ("weight", "bias"):
        assert torch.equal(stt[f"roi_heads.box_predictor.emb_pred.{leaf}"],
                           lsm[f"mmss_heads.v2l_projection.{leaf}"])
    # the C4 trunk has no res5: the fan-out's backbone destination is
    # absent in both packages, and nothing else of the trunk moved
    assert not any(k.startswith("backbone.res5") for k in stt)
    assert not any(k.startswith("backbone/res5")
                   for k in handoff["jrep"].loaded)
    # the detector's other parts share their names and come along
    loaded = set(handoff["trep"].loaded)
    assert set(res5) <= loaded
    assert {"roi_heads.box_predictor.bbox_pred.weight",
            "rpn_head.conv.weight", "backbone.stem.conv1.weight"} <= loaded
    assert handoff["trep"].missing == []


def test_same_arch_checkpoint_loads_without_renaming(handoff, tmp_path):
    """A port checkpoint of the same model loads key for key (no
    rename), every key loaded; the file has no ``.pth`` suffix, so it is
    never read as d2 names."""
    ck = tck.Checkpointer(str(tmp_path))
    path = ck.save_named("model_final", {"model": handoff["tstt"].state_dict()})
    ck.wait()
    assert not path.endswith((".pth", ".pkl"))
    fresh = tbuild(_stt_cfg(tmicro_cfg, handoff["root"]), device="cpu")
    rep = tck.load_weights_standalone(fresh, path)
    assert rep.missing == [] and rep.unused_src == []
    want = handoff["tstt"].state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
