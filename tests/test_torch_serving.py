"""Serving export of the port (locov_torch/serving.py) against the JAX
package's (locov_tpu/serving.py), the twin of tests/test_serving.py.

The tiny OvrRCNN with the JAX model's weights (``from_flax``), tamed as
tests/test_torch_ovr_rcnn.py tames it (zero RPN anchor deltas, a
torchvision-like pixel std, class embeddings x0.1), exported by both
packages at batch 2, 64 x 64 on the CPU. The port's artifact is
complete; its ``signature.json`` equals JAX's; the loaded program is
bit-equal to the port's eager inference and within
tests/test_torch_ovr_rcnn.py's tolerances of JAX's loaded program
(identical masks and classes, boxes atol 1e-3 px, scores atol 1e-5);
inputs of other shapes raise; a consumer process runs the artifact
without importing ``locov_torch.models``; a two-device artifact on two
CPU "devices" equals the one-device artifact, a batch of another size
than the artifact's raises, and a batch that does not divide by the
devices raises.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.serving import export_inference as jexport
from locov_tpu.serving import load_exported as jload
from locov_tpu.structures.batches import DetectionBatch as JBatch
from locov_tpu.structures.batches import ImageBatch as JImages
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.serving import export_inference, load_exported
from locov_torch.structures.batches import DetectionBatch as TBatch
from locov_torch.structures.batches import ImageBatch as TImages
from locov_torch.utils.weights import from_flax
from torch_parity import flat_params, n, t, tiny_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = {"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]}
B, H, W = 2, 64, 64
KEYS = ("boxes", "scores", "classes", "mask")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    rng = np.random.RandomState(0)
    img = (rng.rand(B, H, W, 3) * 255).astype(np.float32)
    hw = np.array([[64, 64], [48, 56]], np.int32)
    ohw = np.array([[128, 128], [96, 112]], np.int32)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
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
    root = tmp_path_factory.mktemp("serving")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jexport(jm, v, jnp.asarray(ce), jdir, batch=B, height=H, width=W)
    export_inference(tm, t(ce), tdir, batch=B, height=H, width=W)
    return dict(tm=tm, img=img, hw=hw, ohw=ohw, ce=ce, jdir=jdir,
                tdir=tdir, root=root)


def _args(p):
    return t(p["img"]), t(p["hw"]), t(p["ohw"])


def test_artifact_complete(exported):
    out = exported["tdir"]
    for f in ("inference.pt2", "inference.graph.txt", "signature.json"):
        assert os.path.isfile(os.path.join(out, f)), f
    assert os.path.isfile(os.path.join(out, "params", "variables"))
    graph = open(os.path.join(out, "inference.graph.txt")).read()
    for op in ("torch.ops.locov.relu_maxpool", "torch.ops.locov.roi_align",
               "torch.ops.locov.nms_mask"):
        assert op in graph, op


def test_signature_equals_jax(exported):
    with open(os.path.join(exported["tdir"], "signature.json")) as f:
        got = json.load(f)
    with open(os.path.join(exported["jdir"], "signature.json")) as f:
        want = json.load(f)
    assert got == want


def test_loaded_program_bit_equal_to_eager_and_close_to_jax(exported):
    call, variables, class_emb = load_exported(exported["tdir"])
    got = call(variables, *_args(exported), class_emb)
    assert set(got) == set(KEYS)
    want = exported["tm"].inference(
        TBatch(images=TImages(*_args(exported))), t(exported["ce"]))
    for k, w in zip(KEYS, want):
        assert torch.equal(got[k], w.to(got[k].dtype)), k
    assert got["classes"].dtype == torch.int32
    jcall, jv, jce = jload(exported["jdir"])
    jgot = {k: np.asarray(x) for k, x in jcall(
        jv, *(jnp.asarray(exported[k]) for k in ("img", "hw", "ohw")),
        jce).items()}
    m = jgot["mask"]
    assert m.sum() > 0
    np.testing.assert_array_equal(n(got["mask"]), m)
    np.testing.assert_array_equal(n(got["classes"])[m], jgot["classes"][m])
    np.testing.assert_allclose(n(got["boxes"])[m], jgot["boxes"][m],
                               atol=1e-3)
    np.testing.assert_allclose(n(got["scores"]), jgot["scores"], atol=1e-5)


def test_loaded_program_takes_other_weights(exported):
    """The weights are an argument, as in JAX: other variables give
    other detections, the artifact's give the eager model's."""
    call, variables, class_emb = load_exported(exported["tdir"])
    base = call(variables, *_args(exported), class_emb)
    other = {k: (v * 1.5 if k.endswith("emb_pred.weight") else v)
             for k, v in variables.items()}
    moved = call(other, *_args(exported), class_emb)
    assert not torch.equal(moved["scores"], base["scores"])


def test_wrong_shapes_raise(exported):
    call, variables, class_emb = load_exported(exported["tdir"])
    _, hw, ohw = _args(exported)
    with pytest.raises(Exception):
        call(variables, torch.zeros((B, 32, 32, 3)), hw, ohw, class_emb)
    with pytest.raises(Exception):
        call(variables, torch.zeros((B + 1, H, W, 3)), hw, ohw, class_emb)


_CONSUMER = """
import json, sys
import numpy as np, torch
from locov_torch.serving import load_exported
call, v, ce = load_exported(sys.argv[1])
a = np.load(sys.argv[2])
out = call(v, *(torch.from_numpy(a[k]) for k in ("img", "hw", "ohw")), ce)
np.savez(sys.argv[3], **{k: x.numpy() for k, x in out.items()})
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("locov_torch"))))
"""


def test_consumer_process_never_imports_the_model_code(exported, tmp_path):
    inputs, outs = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inputs, img=exported["img"], hw=exported["hw"],
             ohw=exported["ohw"])
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _CONSUMER, exported["tdir"],
                        inputs, outs], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    modules = json.loads(r.stdout.strip().splitlines()[-1])
    assert "locov_torch.serving" in modules
    assert not [m for m in modules if m.startswith("locov_torch.models")]
    assert "jax" not in r.stdout
    call, variables, class_emb = load_exported(exported["tdir"])
    want = call(variables, *_args(exported), class_emb)
    got = np.load(outs)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], n(want[k]))


def test_two_devices_equal_one(exported):
    tdir2 = str(exported["root"] / "torch2")
    export_inference(exported["tm"], t(exported["ce"]), tdir2, batch=2 * B,
                     height=H, width=W, n_devices=2)
    with open(os.path.join(tdir2, "signature.json")) as f:
        sig = json.load(f)
    assert sig["nr_devices"] == 2
    assert sig["mesh"] == {"axis_names": ["data"], "shape": [2]}
    assert sig["inputs"]["image"]["shape"] == [2 * B, H, W, 3]
    assert sig["outputs"]["boxes"]["shape"][0] == 2 * B
    call2, v2, ce2 = load_exported(tdir2)
    call1, v1, ce1 = load_exported(exported["tdir"])
    img, hw, ohw = _args(exported)
    flip = torch.flip(img, [0]), torch.flip(hw, [0]), torch.flip(ohw, [0])
    got = call2(v2, *(torch.cat([a, b]) for a, b in
                      zip((img, hw, ohw), flip)), ce2)
    one = call1(v1, img, hw, ohw, ce1)
    two = call1(v1, *flip, ce1)
    for k in KEYS:
        assert torch.equal(got[k], torch.cat([one[k], two[k]])), k
    with pytest.raises(ValueError):  # the batch of one device, not two
        call2(v2, img, hw, ohw, ce2)
    with pytest.raises(ValueError):
        export_inference(exported["tm"], t(exported["ce"]),
                         str(exported["root"] / "bad"), batch=3, height=H,
                         width=W, n_devices=2)



def test_vitdet_exports_and_reloads(tmp_path):
    """ViTDetRCNN (the tiny model of ``test_torch_vitdet.py``, float32)
    through ``export_inference``: the program traces through the
    multi-level ROIAlign's op by its fake implementation (the attention
    takes its plain route in float32), and the reloaded program gives the
    eager model's detections bit for bit."""
    from locov_torch.structures import batches as types
    from locov_torch.utils.weights import seeded_init_
    from test_torch_vitdet import _arrays
    from test_torch_vitdet import tiny_cfg as vit_cfg
    model = seeded_init_(tbuild(vit_cfg(), device="cpu"), 3).eval()
    emb = torch.randn(7, 16, generator=torch.Generator().manual_seed(2))
    export_inference(model, emb, str(tmp_path), 2, 160, 160)
    with open(tmp_path / "inference.graph.txt") as f:
        graph = f.read()
    assert "locov.roi_align_levels" in graph
    call, variables, _ = load_exported(str(tmp_path))
    a = _arrays()
    got = call(variables, torch.from_numpy(a["image"]),
               torch.from_numpy(a["hw"]), torch.from_numpy(a["orig_hw"]),
               emb)
    want = model.inference(types.to_torch(types.DetectionBatch(
        images=types.ImageBatch(**a)), "cpu"), emb)
    for k in KEYS:
        assert torch.equal(got[k], getattr(want, k)), k
