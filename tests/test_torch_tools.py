"""The port's tool twins (locov_torch/tools/) against the repository's
tools (tools/*.py, which run the JAX package).

- ``make_synthetic_dataset``, ``convert_annotations_to_ov_sets`` and
  ``coco_bert_embeddings``: the same arguments write the same files,
  byte for byte.
- ``export_serving``: the CLI writes a complete artifact for a tiny
  config on the CPU; ``--n-devices`` above the devices PyTorch sees
  exits with argparse's code 2; ``TPU.INT8_EVAL``, which raised here
  before, exports: under the static scheme the max-abs buffers ride
  among the variables (tests/test_torch_int8_engine.py holds a loaded
  int8 program to the eager model).
- ``demo``: the JSON equals JAX's demo's at JAX's test's tiny overrides
  (tests/test_demo.py, on the tiny trunk of tests/torch_parity.py),
  both on the same tamed weights (JAX's init, zero RPN anchor deltas,
  written as a JAX checkpoint and as the port's) and class embeddings
  (x0.1), within tests/test_torch_ovr_rcnn.py's tolerances: the same
  detections in the same order, classes equal, boxes atol 1e-3 px,
  scores atol 1e-5.
"""
import importlib.util
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.structures.batches import DetectionBatch as JBatch
from locov_tpu.structures.batches import ImageBatch as JImages
from locov_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import get_cfg as tget_cfg
from locov_torch.data.synthetic import make_micro_coco
from locov_torch.data.tokenization import build_tiny_vocab
from locov_torch.tools import (coco_bert_embeddings, demo, export_serving,
                               make_synthetic_dataset)
from locov_torch.tools import convert_annotations_to_ov_sets as convert
from locov_torch.utils.weights import from_flax
from torch_parity import TINY, flat_params, tiny_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STT = os.path.join(REPO, "configs", "coco_stt.yaml")


def _jax_tool(name):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    _jax_tool(name).main()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("arch", ["OvrRCNN", "DistillProposalMMSSRCNN",
                                  "MMSSGridModel", "DistillMMSSGridModel"])
def test_make_synthetic_dataset_byte_equal(tmp_path, monkeypatch, arch):
    """Every ``--arch`` writes JAX's tool's files, and its ``micro.yaml``
    merges into the port's config."""
    out = str(tmp_path / "demo")
    argv = ["--out", out, "--n-train", "3", "--n-val", "2", "--seed", "5",
            "--arch", arch]
    _run_jax_tool(monkeypatch, "make_synthetic_dataset", argv)
    want = _tree(out)
    shutil.rmtree(out)
    make_synthetic_dataset.main(argv)
    got = _tree(out)
    assert "micro.yaml" in got and len(got) > 10
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    cfg = tget_cfg()
    cfg.merge_from_file(os.path.join(out, "micro.yaml"))
    assert cfg.MODEL.META_ARCHITECTURE == arch


def test_convert_annotations_byte_equal(tmp_path, monkeypatch):
    root = str(tmp_path / "micro")
    make_micro_coco(root, n_train=4, n_val=3)
    ann = os.path.join(root, "datasets_data", "zero-shot", "coco",
                       "instances_val2017_all_2.json")
    with open(ann) as f:
        data = json.load(f)
    # a full-COCO-like file: the 65 OVD categories and one more
    data["categories"].append({"id": 90, "name": "toothbrush"})
    data["annotations"].append(dict(data["annotations"][0], id=10 ** 6,
                                    category_id=90))
    data["info"] = {"description": "synthetic"}
    src = str(tmp_path / "instances_val2017.json")
    with open(src, "w") as f:
        json.dump(data, f)
    trees = {}
    for who in ("jax", "torch"):
        argv = ["--ann", src, "--out-dir", str(tmp_path / who), "--split",
                "val"]
        if who == "jax":
            _run_jax_tool(monkeypatch, "convert_annotations_to_ov_sets",
                          argv)
        else:
            convert.main(argv)
        trees[who] = _tree(str(tmp_path / who))
    assert len(trees["torch"]) == 4
    assert trees["torch"] == trees["jax"]


@pytest.mark.parametrize("with_weights", [False, True])
def test_coco_bert_embeddings_byte_equal(tmp_path, monkeypatch,
                                         with_weights):
    vocab = build_tiny_vocab(["person", "bicycle", "traffic", "light",
                              "hair", "drier", "cup"])
    vpath = str(tmp_path / "vocab.txt")
    with open(vpath, "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    argv = ["--vocab", vpath]
    if with_weights:
        wpath = str(tmp_path / "bert.pth")
        torch.save({"bert.embeddings.word_embeddings.weight":
                    torch.from_numpy(np.random.RandomState(1).randn(
                        len(vocab), 16).astype(np.float32))}, wpath)
        argv += ["--weights", wpath]
    outs = {}
    for who in ("jax", "torch"):
        out = str(tmp_path / f"{who}.json")
        if who == "jax":
            _run_jax_tool(monkeypatch, "coco_bert_embeddings",
                          argv + ["--out", out])
        else:
            coco_bert_embeddings.main(argv + ["--out", out])
        with open(out, "rb") as f:
            outs[who] = f.read()
    assert len(json.loads(outs["torch"])) == 65
    assert outs["torch"] == outs["jax"]


def _tiny_opts(extra=()):
    opts = []
    for k, v in TINY.items():
        opts += [k, repr(v) if isinstance(v, (list, tuple)) else str(v)]
    return opts + ["MODEL.PIXEL_STD", "[57.375, 57.12, 58.395]",
                   "MODEL.WEIGHTS", "''"] + list(extra)


def test_export_serving_cli(tmp_path):
    out = str(tmp_path / "art")
    path = export_serving.main(["--config-file", STT, "--out", out,
                                "--batch", "2", "--height", "64",
                                "--width", "64", "--device", "cpu"]
                               + _tiny_opts())
    assert path == os.path.join(out, "inference.pt2")
    with open(os.path.join(out, "signature.json")) as f:
        sig = json.load(f)
    assert sig["platforms"] == ["cpu"] and sig["nr_devices"] == 1
    assert sig["inputs"]["image"]["shape"] == [2, 64, 64, 3]
    assert sig["inputs"]["class_emb"]["shape"] == [6, 8]
    assert os.path.isfile(os.path.join(out, "params", "variables"))
    with pytest.raises(SystemExit) as e:
        export_serving.main(["--config-file", STT, "--out", out,
                             "--device", "cpu", "--n-devices", "2"]
                            + _tiny_opts())
    assert e.value.code == 2
    out8 = str(tmp_path / "art8")
    export_serving.main(["--config-file", STT, "--out", out8, "--batch",
                         "2", "--height", "64", "--width", "64", "--device",
                         "cpu"] + _tiny_opts(["TPU.INT8_EVAL", "True",
                                              "TPU.INT8_SCHEME", "static"]))
    from locov_torch.serving import load_exported
    _, variables, _ = load_exported(out8)
    amax = [k for k in variables if k.endswith("amax")]
    assert len(amax) == 54 and "model.roi_heads.pooled_amax" in amax
    with open(os.path.join(out8, "inference.graph.txt")) as f:
        graph = f.read()
    assert "locov.conv_int8" in graph and "locov.roi_align_int8" in graph


DEMO_OPTS = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "64",
             "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
             "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
             "TEST.DETECTIONS_PER_IMAGE", "10"]


def test_demo_json_matches_jax(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    src = str(tmp_path / "in.jpg")
    cv2.imwrite(src, (rng.rand(96, 128, 3) * 255).astype("uint8"))
    names = ["apple", "bird", "cat", "dog", "egg"]
    emb = str(tmp_path / "emb.json")
    with open(emb, "w") as f:
        json.dump({k: (rng.randn(8) * 0.1).tolist() for k in names}, f)
    # tamed weights: JAX's init with zero RPN anchor deltas
    jm = jbuild(tiny_cfg(jget, **{"MODEL.PIXEL_STD":
                                  [57.375, 57.12, 58.395]}))
    b = JBatch(images=JImages(image=jnp.zeros((1, 64, 64, 3)),
                              hw=jnp.full((1, 2), 64, jnp.int32),
                              orig_hw=jnp.full((1, 2), 64, jnp.int32)))
    v = jax.jit(lambda bb: jm.init(jax.random.PRNGKey(0), bb,
                                   jnp.zeros((6, 8)),
                                   method=jm.inference))(b)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    jw = JCheckpointer(str(tmp_path / "ck"), use_async=False).save_named(
        "tamed", {"params": unflatten_params(
            {k: jnp.asarray(a) for k, a in flat.items()})})
    tw = str(tmp_path / "tamed_torch")
    torch.save({"model": from_flax(flat)}, tw)
    dets = {}
    for who, weights in (("jax", jw), ("torch", tw)):
        out = str(tmp_path / who)
        argv = ["--config-file", STT, "--weights", weights, "--embeddings",
                emb, "--input", src, "--output", out,
                "--confidence-threshold", "0.0"]
        opts = _tiny_opts(DEMO_OPTS)
        if who == "jax":
            _run_jax_tool(monkeypatch, "demo", argv + opts)
        else:
            demo.main(argv + ["--device", "cpu"] + opts)
        assert os.path.isfile(os.path.join(out, "in.jpg"))
        with open(os.path.join(out, "in.json")) as f:
            dets[who] = json.load(f)
    got, want = dets["torch"], dets["jax"]
    assert got["file"] == want["file"] == src
    assert len(want["detections"]) > 0
    assert len(got["detections"]) == len(want["detections"])
    for g, w in zip(got["detections"], want["detections"]):
        assert set(g) == {"bbox_xyxy", "score", "class_index", "class_name"}
        assert (g["class_index"], g["class_name"]) == \
            (w["class_index"], w["class_name"])
        np.testing.assert_allclose(g["bbox_xyxy"], w["bbox_xyxy"],
                                   atol=1e-3)
        assert abs(g["score"] - w["score"]) <= 1e-5
