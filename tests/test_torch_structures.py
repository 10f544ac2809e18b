"""PyTorch port vs JAX: box algebra, batch containers, vector
normalizations, the config tree, and the port's import boundary.

Tolerance: atol 1e-5 (box coordinates of order 1e2 in float32 on both
sides, differing only in the rounding of fused vs unfused ops)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.ops import losses as jlosses
from locov_tpu.structures import boxes as jboxes
from locov_torch.ops import losses as tlosses
from locov_torch.structures import boxes as tboxes
from locov_torch.structures.batches import (DetectionBatch, ImageBatch,
                                            ProposalBatch, to_torch)
from torch_parity import n, t

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boxes(rng, shape, neg=True):
    lo = rng.uniform(-20 if neg else 0, 80, shape + (2,))
    wh = rng.uniform(-5, 60, shape + (2,))  # some empty / inverted boxes
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["area", "nonempty"])
def test_unary_box_ops(rng, fn):
    b = _boxes(rng, (3, 17))
    got = getattr(tboxes, fn)(t(b))
    want = getattr(jboxes, fn)(jnp.asarray(b))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_clip_and_scale(rng):
    b = _boxes(rng, (2, 9))
    hw = np.array([[50, 70], [64, 40]], np.int32)
    for i in range(2):
        np.testing.assert_allclose(
            n(tboxes.clip(t(b[i]), t(hw[i]))),
            n(jboxes.clip(jnp.asarray(b[i]), jnp.asarray(hw[i]))),
            atol=ATOL)
    # batched clip with per-image (h, w) columns, as the models call it
    got = tboxes.clip(t(b), (t(hw[:, 0:1]), t(hw[:, 1:2])))
    for i in range(2):
        np.testing.assert_allclose(
            n(got[i]), n(jboxes.clip(jnp.asarray(b[i]), jnp.asarray(hw[i]))),
            atol=ATOL)
    sx = np.array([[1.5], [0.5]], np.float32)
    sy = np.array([[2.0], [0.25]], np.float32)
    np.testing.assert_allclose(
        n(tboxes.scale(t(b), t(sx), t(sy))),
        n(jboxes.scale(jnp.asarray(b), jnp.asarray(sx), jnp.asarray(sy))),
        atol=ATOL)


def test_pairwise_iou(rng):
    a, b = _boxes(rng, (2, 11)), _boxes(rng, (2, 7))
    np.testing.assert_allclose(
        n(tboxes.pairwise_iou(t(a), t(b))),
        n(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_apply_deltas(rng, weights):
    b = _boxes(rng, (2, 13), neg=False)
    # includes deltas past the exp clamp
    d = (rng.randn(2, 13, 4) * 3).astype(np.float32)
    np.testing.assert_allclose(
        n(tboxes.apply_deltas(t(d), t(b), weights)),
        n(jboxes.apply_deltas(jnp.asarray(d), jnp.asarray(b), weights)),
        rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("fn", ["normalize_vec", "standardize_vec"])
def test_vector_normalizations(rng, fn):
    x = rng.randn(4, 6, 16).astype(np.float32)
    np.testing.assert_allclose(n(getattr(tlosses, fn)(t(x))),
                               n(getattr(jlosses, fn)(jnp.asarray(x))),
                               rtol=1e-5, atol=ATOL)


def test_to_torch_converts_nested_batches(rng):
    img = rng.rand(2, 8, 8, 3).astype(np.float32)
    batch = DetectionBatch(
        images=ImageBatch(image=img, hw=np.array([[8, 8], [6, 7]], np.int32),
                          orig_hw=np.array([[16, 16], [12, 14]], np.int32)),
        proposals=ProposalBatch(boxes=np.zeros((2, 3, 4), np.float32),
                                objectness=np.zeros((2, 3), np.float32),
                                mask=np.ones((2, 3), bool)))
    out = to_torch(batch, "cpu")
    assert isinstance(out.images.image, torch.Tensor)
    assert out.images.image_id is None and out.gt is None
    assert out.images.hw.dtype == torch.int32
    assert out.proposals.mask.dtype == torch.bool
    np.testing.assert_array_equal(n(out.images.image), img)


def test_config_tree_matches_jax():
    """The port's own config copy gives the JAX package's keys and
    values, defaults and after merging coco_stt.yaml."""
    from locov_tpu.config import config_path as jpath
    from locov_tpu.config import get_cfg as jget
    from locov_torch.config import config_path as tpath
    from locov_torch.config import get_cfg as tget
    a, b = jget(), tget()
    assert a == b
    assert tpath("coco_stt.yaml") == jpath("coco_stt.yaml")
    a.merge_from_file(jpath("coco_stt.yaml"))
    b.merge_from_file(tpath("coco_stt.yaml"))
    assert a == b
    assert b.MODEL.META_ARCHITECTURE == "OvrRCNN"
    assert b.TPU.COMPUTE_DTYPE == "bfloat16"


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|locov_tpu)\b", re.M)


def test_port_imports_no_jax_and_no_locov_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "locov_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    # the image-caption stage's modules, the evaluation path's host
    # data layer and evaluators, and the trainer's checkpoints, writers
    # and CLI (framework-free copies among them) are checked
    names = {os.path.relpath(f, REPO) for f in files}
    assert {f"locov_torch/{m}.py" for m in (
        "models/bert", "models/language", "models/mmss/__init__",
        "models/mmss/grounding_head", "models/mmss/transformer_head",
        "models/mmss/distill", "models/meta_arch/mmss_gcnn",
        "ops/matmul", "tools/bench", "data/__init__", "data/catalog",
        "data/transforms", "data/tokenization", "data/mappers",
        "data/loader", "data/synthetic", "data/datasets/coco",
        "data/datasets/lvis", "evaluation/coco_eval",
        "evaluation/lvis_eval", "evaluation/evaluator",
        "engine/trainer", "engine/solver", "parallel/mesh",
        "utils/native", "utils/checkpoint", "utils/events",
        "utils/metric_logger", "utils/misc", "train_ovnet", "serving",
        "evaluation/tta", "tools/export_serving", "tools/demo",
        "tools/coco_bert_embeddings", "tools/convert_annotations_to_ov_sets",
        "tools/make_synthetic_dataset")} <= names
    for path in files:
        with open(path) as f:
            hit = _FORBIDDEN.search(f.read())
        assert hit is None, f"{path} imports {hit.group(1)}"
