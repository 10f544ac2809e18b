"""PyTorch port vs JAX: checkpoints and weight import
(``locov_torch/utils/checkpoint.py``).

The ``Checkpointer`` cases of tests/test_checkpoint.py on torch state
(round trip, ``max_to_keep`` pruning, the async commit barrier,
``save_named`` beside a pending save, the best-metric sidecar,
``resume_iteration``), plus what the torch version adds: the state is
copied before the caller may change it, a failed write leaves no file
under its final name and the pointer where it was, and the pointer moves
only once a save has committed.

The converters are JAX's: on the same numpy state dicts (the complete
synthetic R-50-C4 LSM surface of tests/test_weight_import.py, a
Caffe2-named ResNet, a random-init ``transformers.BertModel`` built from
a ``BertConfig`` in the process) each package's gives the same keys and
the same arrays, bit for bit. Through ``load_weights_standalone`` the
d2-named LSM surface lands in the port's full-width STT model as JAX's
lands in its own tree: the same import report (JAX's names mapped by
``from_flax``) and the same values.
"""
import json
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import config_path as jpath
from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.structures import batches as jb
from locov_tpu.utils import checkpoint as jck
from locov_tpu.utils import misc as jmisc
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.utils import checkpoint as tck
from locov_torch.utils import misc as tmisc
from locov_torch.utils.weights import from_flax, torch_name
from test_weight_import import _fake_torch_lsm_state
from torch_parity import two_threads  # noqa: F401 (autouse)


def _state(fill=None):
    w = torch.arange(6.0).reshape(2, 3) if fill is None \
        else torch.full((2, 3), float(fill))
    return {"model": {"a.w": w, "b.x": torch.ones(4)}}


@pytest.mark.parametrize("use_async", [True, False])
def test_save_load_roundtrip(tmp_path, use_async):
    ck = tck.Checkpointer(str(tmp_path), max_to_keep=2, use_async=use_async)
    ck.save_periodic(7, {**_state(), "iteration": 7})
    assert ck.has_checkpoint()
    name = ck.last_checkpoint()
    assert name == "model_0000007"
    loaded = ck.load(name)
    np.testing.assert_array_equal(loaded["model"]["a.w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert loaded["iteration"] == 7
    assert ck.resume_iteration(name) == 8
    (rec,) = ck.saves
    assert rec["name"] == name
    assert rec["bytes"] == os.path.getsize(tmp_path / name)
    assert 0 <= rec["caller_s"] <= rec["total_s"]


def test_merge_over_template_new_statistic():
    """A checkpoint written before the model gained a buffer restores
    complete: the new key keeps its init, keys the checkpoint has win,
    keys only in the checkpoint are carried through (JAX's rule on
    collections, here on a ``state_dict``)."""
    template = {"a.w": torch.zeros(2),
                "quant.roi_heads.pooled_amax": torch.zeros(()),
                "quant.roi_heads.roialign_amax": torch.zeros(())}
    restored = {"a.w": torch.ones(2),
                "quant.roi_heads.pooled_amax": torch.tensor(3.5),
                "batch_stats.m": torch.tensor(1.0)}
    out = tck.merge_over_template(template, restored)
    assert torch.equal(out["a.w"], torch.ones(2))
    assert float(out["quant.roi_heads.pooled_amax"]) == 3.5
    assert float(out["quant.roi_heads.roialign_amax"]) == 0.0
    assert float(out["batch_stats.m"]) == 1.0


@pytest.mark.parametrize("use_async", [True, False])
def test_max_to_keep_pruning(tmp_path, use_async):
    ck = tck.Checkpointer(str(tmp_path), max_to_keep=2, use_async=use_async)
    for it in [1, 2, 3, 4]:
        ck.save_periodic(it, _state())
    ck.wait()  # commit the in-flight async save before inspecting disk
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("model_"))
    assert names == ["model_0000003", "model_0000004"]


def test_async_readers_barrier_on_pending_save(tmp_path):
    """Every reader must see the just-dispatched async save committed."""
    ck = tck.Checkpointer(str(tmp_path), max_to_keep=2, use_async=True)
    ck.save_periodic(1, {**_state(), "iteration": 1})
    ck.save_periodic(2, {**_state(5), "iteration": 2})
    assert ck.last_checkpoint() == "model_0000002"
    loaded = ck.load("model_0000002")
    assert torch.equal(loaded["model"]["a.w"], torch.full((2, 3), 5.0))


def test_async_save_named_while_pending(tmp_path):
    """save_named (model_final/model_best) right after a periodic save
    serializes with the in-flight save and never moves the pointer."""
    ck = tck.Checkpointer(str(tmp_path), use_async=True)
    ck.save_periodic(9, {**_state(), "iteration": 9})
    ck.save_named("model_final", {**_state(), "iteration": 9})
    ck.wait()
    assert os.path.isfile(tmp_path / "model_0000009")
    assert os.path.isfile(tmp_path / "model_final")
    assert ck.last_checkpoint() == "model_0000009"


def test_best_metric_sidecar(tmp_path):
    ck = tck.Checkpointer(str(tmp_path))
    ck.save_best(42, _state(), "coco_zeroshot_val/bbox/AP", 17.2)
    side = json.load(open(tmp_path / "model_best.json"))
    assert side == {"iteration": 42, "metric": "coco_zeroshot_val/bbox/AP",
                    "value": 17.2}
    assert ck.resume_iteration("model_best") == 43


@pytest.mark.parametrize("name", ["model_0000007", "model_final",
                                  "model_best", "other"])
def test_resume_iteration_matches_jax(tmp_path, name):
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
        with open(tmp_path / d / "model_best.json", "w") as f:
            json.dump({"iteration": 11, "metric": "m", "value": 1.0}, f)
    # JAX's constructor opens an orbax checkpointer; the name parsing
    # reads only the output dir
    jc = object.__new__(jck.Checkpointer)
    jc.output_dir = str(tmp_path / "j")
    want = jck.Checkpointer.resume_iteration(jc, name)
    got = tck.Checkpointer(str(tmp_path / "t")).resume_iteration(name)
    assert got == want


def test_async_save_copies_before_returning(tmp_path):
    """The caller may change the state in place as soon as ``save``
    returns (the next training step): the file holds the values of the
    call."""
    ck = tck.Checkpointer(str(tmp_path), use_async=True)
    state = _state()
    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        gate.wait(10)
        real_save(obj, path)
    try:
        torch.save = slow_save
        ck.save_periodic(3, state)
        state["model"]["a.w"].add_(100.0)  # the next step, in place
        # not committed yet: no file under the final name, no pointer
        assert not os.path.exists(tmp_path / "model_0000003")
        assert not os.path.exists(tmp_path / "last_checkpoint")
        gate.set()
        ck.wait()
    finally:
        torch.save = real_save
    loaded = ck.load("model_0000003")["model"]["a.w"]
    np.testing.assert_array_equal(loaded.numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert ck.last_checkpoint() == "model_0000003"


def test_failed_write_leaves_no_file_and_keeps_the_pointer(tmp_path):
    ck = tck.Checkpointer(str(tmp_path), use_async=True)
    ck.save_periodic(1, _state())
    ck.wait()
    real_save = torch.save

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")
    try:
        torch.save = broken_save
        ck.save_periodic(2, _state())
        with pytest.raises(RuntimeError, match="model_0000002"):
            ck.wait()
    finally:
        torch.save = real_save
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint",
                                            "model_0000001"]
    assert ck.last_checkpoint() == "model_0000001"


def test_rename_fanout_matches_jax_and_owns_its_memory():
    """The one-to-many fan-out on numpy (Flax names) gives JAX's dict
    and report; on tensors (``state_dict`` names) each destination gets
    memory of its own."""
    src = {"roi_heads/res5/0/conv1/kernel": np.ones((1, 1, 4, 4), np.float32),
           "mmss_heads/v2l_projection/kernel": np.full((4, 2), 3.0,
                                                       np.float32),
           "unmatched/y": np.zeros(2, np.float32),
           "untouched/x": np.zeros(5, np.float32)}
    dst = {"backbone/res5/0/conv1/kernel": np.zeros((1, 1, 4, 4), np.float32),
           "roi_heads/res5/0/conv1/kernel": np.zeros((1, 1, 4, 4),
                                                     np.float32),
           "roi_heads/box_predictor/emb_pred/kernel": np.zeros((4, 2),
                                                               np.float64),
           "untouched/x": np.zeros(3, np.float32)}
    want, jrep = jck.load_with_rename_map(src, dst, jck.STT_FROM_LSM_RENAME)
    got, trep = tck.load_with_rename_map(src, dst, tck.STT_FROM_LSM_RENAME)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for f in ("missing", "loaded", "mismatched", "unused_src"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert list(trep) == list(jrep)

    tsrc = {torch_name(k): torch.from_numpy(v) for k, v in src.items()}
    tdst = {torch_name(k): torch.from_numpy(v) for k, v in dst.items()}
    out, rep = tck.load_with_rename_map(
        tsrc, tdst, tck.torch_rename_map(tck.STT_FROM_LSM_RENAME))
    a, b = out["backbone.res5.0.conv1.weight"], \
        out["roi_heads.res5.0.conv1.weight"]
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert a.data_ptr() != tsrc["roi_heads.res5.0.conv1.weight"].data_ptr()
    a.add_(1.0)  # training one copy leaves the other where it was
    assert float(b.sum()) == 16.0
    assert out["roi_heads.box_predictor.emb_pred.weight"].dtype == \
        torch.float64
    assert rep.mismatched == [("untouched.x", (5,), (3,))]


@pytest.fixture(scope="module")
def lsm_surface():
    return _fake_torch_lsm_state()


def _assert_same_flat(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_d2_state_dict_matches_jax(lsm_surface):
    want = jck.convert_d2_state_dict(lsm_surface)
    _assert_same_flat(tck.convert_d2_state_dict(lsm_surface), want)
    assert len(want) > 300
    assert want["backbone/stem/conv1/kernel"].shape == (7, 7, 3, 64)


def test_convert_lsm_extras_and_leaf_layout_match_jax(lsm_surface):
    _assert_same_flat(tck.convert_lsm_extras(lsm_surface),
                      jck.convert_lsm_extras(lsm_surface))
    v = np.random.RandomState(1).randn(5, 3, 2, 2).astype(np.float32)
    for key in ("a/kernel", "a/bias"):
        for arr in (v, v[:, :, 0, 0], v[0, 0]):
            np.testing.assert_array_equal(
                tck.torch_to_flax_leaf("t", arr, key),
                jck.torch_to_flax_leaf("t", arr, key))


def _caffe2_resnet(rng):
    s = {"conv1_w": rng.randn(8, 3, 7, 7)}
    for suf in ("bn_s", "bn_b", "bn_rm", "bn_riv"):
        s[f"conv1_{suf}"] = rng.randn(8)
    for stage, blocks in (("res2", 2), ("res3", 1)):
        for b in range(blocks):
            for br, cout in (("branch2a", 4), ("branch2b", 4),
                             ("branch2c", 16), ("branch1", 16)):
                if br == "branch1" and b:
                    continue
                s[f"{stage}_{b}_{br}_w"] = rng.randn(cout, 8, 1, 1)
                for suf in ("bn_s", "bn_b", "bn_rm", "bn_riv"):
                    s[f"{stage}_{b}_{br}_{suf}"] = rng.randn(cout)
    s["res2_0_branch2a_momentum"] = rng.randn(4)  # not a weight: skipped
    s["fc1000_w"] = rng.randn(10, 16)             # not in the trunk
    return {k: v.astype(np.float32) for k, v in s.items()}


def test_caffe2_pkl_and_d2_pth_files_match_jax(tmp_path, lsm_surface):
    pkl = str(tmp_path / "r50.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": 0, "model": _caffe2_resnet(
            np.random.RandomState(2))}, f)
    want = jck.convert_caffe2_resnet(jck.load_torch_file(pkl))
    got = tck.convert_caffe2_resnet(tck.load_torch_file(pkl))
    _assert_same_flat(got, want)
    assert "backbone/res2/0/shortcut/kernel" in want
    assert "backbone/stem/conv1_norm/running_var" in want
    # as in JAX, the greedy ``branch\w+`` takes "branch1_bn" and leaves
    # "riv": the blocks' FrozenBN blobs are not imported (ROADMAP §3)
    assert not any("_norm/" in k for k in want if "/res" in k)
    # d2 names in a .pth (the published checkpoints' container)
    pth = str(tmp_path / "lsm.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          list(lsm_surface.items())[:40]}}, pth)
    _assert_same_flat(tck.load_torch_file(pth), jck.load_torch_file(pth))
    # d2-named state routed through convert_caffe2_resnet
    _assert_same_flat(
        tck.convert_caffe2_resnet(tck.load_torch_file(pth)),
        jck.convert_caffe2_resnet(jck.load_torch_file(pth)))


def test_hf_bert_conversion_matches_jax():
    """A random-init ``transformers.BertModel`` from a ``BertConfig``
    (no download), bare and under the LSM checkpoint's prefix."""
    import transformers
    torch.manual_seed(0)
    bert = transformers.BertModel(transformers.BertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=16))
    sd = {k: v.numpy() for k, v in bert.state_dict().items()}
    for prefix, dest in (("bert.", ""), ("language_backbone.body."
                                         "bert_model.", "lb/")):
        state = {prefix + k: v for k, v in sd.items()}
        want = jck.convert_bert_state_dict(state, dest_prefix=dest)
        _assert_same_flat(tck.convert_bert_state_dict(state,
                                                      dest_prefix=dest),
                          want)
        assert dest + "encoder/layer_1/output_norm/scale" in want
        assert dest + "pooler/dense/kernel" in want


def test_flatten_and_parameter_table_match_jax():
    rng = np.random.RandomState(3)
    tree = {"params": {"a": {"w": rng.randn(2, 3)}, "b": {"x": rng.randn(4),
                                                          "y": rng.randn(1)}}}
    flat = tck.flatten_params(tree)
    assert flat.keys() == jck.flatten_params(tree).keys()
    back = tck.unflatten_params(flat)
    np.testing.assert_array_equal(back["params"]["a"]["w"],
                                  tree["params"]["a"]["w"])
    assert tmisc.parameter_count_table(tree) == \
        jmisc.parameter_count_table(tree)
    # a state_dict's dotted names group as the Flax paths do
    sd = {k.replace("/", "."): v for k, v in flat.items()}
    assert tmisc.parameter_count_table(sd) == \
        jmisc.parameter_count_table(tree)
    for fn in ("l2_normalize_np", "dot_similarity_np"):
        args = (rng.randn(3, 4),) + ((rng.randn(5, 4),)
                                     if fn == "dot_similarity_np" else ())
        np.testing.assert_array_equal(getattr(tmisc, fn)(*args),
                                      getattr(jmisc, fn)(*args))
    rec, prec = np.linspace(0, 1, 7), rng.rand(7)
    for use_07 in (False, True):
        assert tmisc.voc_ap(rec, prec, use_07) == \
            jmisc.voc_ap(rec, prec, use_07)


def _stt_cfg(get_cfg, config_path):
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 16  # the surface's hidden width
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_d2_lsm_checkpoint_into_the_stt_model_matches_jax(tmp_path,
                                                          lsm_surface):
    """``load_weights_standalone`` of a d2-named LSM ``.pth`` into the
    full-width STT model (the stage hand-off from a published
    checkpoint), against JAX's on its own tree: the report's lists
    (JAX's names through ``from_flax``'s naming) and every value."""
    pth = str(tmp_path / "lsm_coco.pth")
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in lsm_surface.items()}}, pth)
    jm = jbuild(_stt_cfg(jget, jpath))
    b = jb.DetectionBatch(images=jb.ImageBatch(
        image=jnp.zeros((1, 512, 512, 3)),
        hw=jnp.full((1, 2), 512, jnp.int32),
        orig_hw=jnp.full((1, 2), 512, jnp.int32)))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), b, jnp.zeros((4, 16)),
                        method=jm.inference))
    init = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    out = jck.load_weights_standalone(init, pth,
                                      report_dir=str(tmp_path / "j"))
    jrep = json.load(open(tmp_path / "j" / "import_report.json"))

    tm = tbuild(_stt_cfg(tget, tpath), device="cpu")
    rep = tck.load_weights_standalone(tm, pth, report_dir=str(tmp_path / "t"))
    trep = json.load(open(tmp_path / "t" / "import_report.json"))
    for f in ("loaded", "missing", "unused_src"):
        assert sorted(trep[f]) == sorted(torch_name(k) for k in jrep[f]), f
    assert trep["mismatched"] == jrep["mismatched"] == []
    assert rep.missing == []  # every parameter and buffer of the model
    assert "roi_heads.res5.2.conv3.weight" in rep.loaded
    assert "roi_heads.box_predictor.emb_pred.weight" in rep.loaded
    want = from_flax(jck.flatten_params(jax.device_get(out["params"])))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    # the stage hand-off: res5 and the projection come from the LSM
    np.testing.assert_array_equal(
        got["roi_heads.box_predictor.emb_pred.weight"].numpy(),
        lsm_surface["mmss_heads.GroundingHead.v2l_projection.weight"])
    np.testing.assert_array_equal(
        got["roi_heads.res5.1.conv2.weight"].numpy(),
        lsm_surface["roi_heads.res5.1.conv2.weight"])
