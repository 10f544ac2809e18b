"""PyTorch port vs JAX: COCO and LVIS bbox evaluation
(``locov_torch/evaluation/{coco_eval,lvis_eval}.py`` and the native
matcher ``locov_torch/native/cocoeval.cpp``).

On seeded gt and detections (crowd and ignored gt, boxes in every area
range, images with more than 100 and more than 300 detections, images
with no gt and images with no detections, LVIS negative and
not-exhaustive sets and frequency groups), ``summarize(per_category=
True)`` of the port's ``COCOEvaluator`` and ``LVISEvaluator`` equals
JAX's exactly (every key, NaN where NaN), on the native matcher and on
the numpy matcher. The port builds its native library under
``build/native/``; each test asserts which matcher ran.
"""
import json
import os

import numpy as np
import pytest

from locov_tpu.evaluation import coco_eval as jcoco
from locov_tpu.evaluation import lvis_eval as jlvis
from locov_torch.evaluation import coco_eval as tcoco
from locov_torch.evaluation import lvis_eval as tlvis
from locov_torch.utils import native

CATS = [1, 3, 7, 9, 12]
NAMES = ["cat", "dog", "car", "bus", "cup"]


def _box(rng, area_kind, w_img=640, h_img=480):
    side = {"small": (4, 30), "medium": (34, 90), "large": (100, 300)}[
        area_kind]
    w, h = rng.uniform(*side, 2)
    x0 = rng.uniform(0, w_img - w)
    y0 = rng.uniform(0, h_img - h)
    return [x0, y0, x0 + w, y0 + h]


def _case(seed, n_images=14):
    """gts (xyxy, dataset ids) and per-image detections."""
    rng = np.random.RandomState(seed)
    gts, dets = [], {}
    kinds = ["small", "medium", "large"]
    for img in range(1, n_images + 1):
        n_gt = 0 if img % 5 == 0 else rng.randint(1, 9)
        boxes = []
        for _ in range(n_gt):
            b = _box(rng, kinds[rng.randint(3)])
            g = {"image_id": img, "category_id": int(rng.choice(CATS)),
                 "bbox": b, "area": (b[2] - b[0]) * (b[3] - b[1]),
                 "iscrowd": int(rng.rand() < 0.1),
                 "ignore": int(rng.rand() < 0.05)}
            gts.append(g)
            boxes.append((b, g["category_id"]))
        n_det = {1: 0, 2: 150, 3: 320}.get(img, rng.randint(0, 40))
        d_boxes, d_scores, d_cls = [], [], []
        for k in range(n_det):
            if boxes and rng.rand() < 0.5:
                b, c = boxes[rng.randint(len(boxes))]
                b = list(np.asarray(b) + rng.uniform(-6, 6, 4))
                c = c if rng.rand() < 0.8 else int(rng.choice(CATS))
            else:
                b, c = _box(rng, kinds[rng.randint(3)]), \
                    int(rng.choice(CATS))
            d_boxes.append(b)
            # ties among scores exercise the stable sort
            d_scores.append(round(rng.rand(), 2))
            d_cls.append(c)
        dets[img] = (np.asarray(d_boxes, np.float64).reshape(-1, 4),
                     np.asarray(d_scores, np.float64),
                     np.asarray(d_cls, np.int64))
    return gts, dets


def _lvis_sets(seed, n_images=14):
    rng = np.random.RandomState(seed + 100)
    neg = {i: [int(c) for c in rng.choice(CATS, 2, replace=False)]
           for i in range(1, n_images + 1)}
    nel = {i: [int(rng.choice(CATS))] for i in range(1, n_images + 1)
           if i % 2}
    freq = {"r": [1, 12], "c": [3], "f": [7, 9]}
    return neg, nel, freq


def _summaries(kind, seed):
    gts, dets = _case(seed)
    images = sorted(dets)
    out = []
    classes = {"coco": (jcoco.COCOEvaluatorTPU, tcoco.COCOEvaluator),
               "lvis": (jlvis.LVISEvaluatorTPU, tlvis.LVISEvaluator)}[kind]
    for cls in classes:
        if kind == "coco":
            ev = cls(gts, images, CATS, NAMES)
        else:
            neg, nel, freq = _lvis_sets(seed)
            ev = cls(gts, images, CATS, NAMES, neg_category_ids=neg,
                     not_exhaustive_category_ids=nel, freq_groups=freq)
        for img in images:
            ev.process(img, *dets[img])
        out.append(ev.summarize(per_category=True))
    return out


def _assert_same_summary(want, got):
    assert set(want) == set(got)
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.fixture(params=["native", "numpy"])
def matcher(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(jcoco, "_NATIVE", False)
        monkeypatch.setattr(tcoco, "_NATIVE", False)
        assert tcoco._load_native() is None
    else:
        lib = tcoco._load_native()
        assert lib is not None, "the native matcher did not build"
        assert lib._name == native.lib_path("cocoeval")
        assert lib._name.startswith(native.BUILD_DIR + os.sep)
        assert jcoco._load_native() is not None
    return request.param


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["coco", "lvis"])
def test_summary_equals_jax(matcher, kind, seed):
    want, got = _summaries(kind, seed)
    _assert_same_summary(want, got)
    assert 0 < got["AP"] < 100  # neither trivial nor perfect
    if kind == "coco":
        assert {"APs", "APm", "APl", "AR@100", "AP50-cup"} <= set(got)
    else:
        assert {"APr", "APc", "APf", "AR@300"} <= set(got)


def test_native_and_numpy_matchers_agree():
    """The port's two matchers on random cells (crowd, ignored gt, area
    ranges, IoU ties at thresholds), and JAX's numpy matcher."""
    rng = np.random.RandomState(7)
    rngs = np.array(list(tcoco.AREA_RNGS.values()))
    for _ in range(30):
        d, g = rng.randint(0, 12), rng.randint(0, 9)
        ious = np.round(rng.rand(d, g), 1)  # ties, and exact 0.5 ... 0.9
        gig = rng.rand(4, g) < 0.3
        crowd = rng.rand(g) < 0.2
        d_area = rng.uniform(0, 200 ** 2, d)
        args = (ious, gig, crowd, d_area, rngs[:, 0], rngs[:, 1])
        want = jcoco._match_cell_numpy(*args)
        for got in (tcoco._match_cell_numpy(*args), tcoco._match_cell(*args)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_from_coco_json_equals_jax(tmp_path):
    gts, dets = _case(3)
    images = [{"id": i, "height": 480, "width": 640} for i in sorted(dets)]
    anns = [{"id": k, "image_id": g["image_id"],
             "category_id": g["category_id"],
             "bbox": [g["bbox"][0], g["bbox"][1], g["bbox"][2] - g["bbox"][0],
                      g["bbox"][3] - g["bbox"][1]],
             "area": g["area"], "iscrowd": g["iscrowd"]}
            for k, g in enumerate(gts)]
    path = str(tmp_path / "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": n}
                                  for c, n in zip(CATS, NAMES)]}, f)
    out = []
    for mod in (jcoco, tcoco):
        ev = mod.from_coco_json(path)
        for img in sorted(dets):
            ev.process(img, *dets[img])
        out.append(ev.summarize(per_category=True))
    _assert_same_summary(*out)
    assert type(tcoco.from_coco_json(path)) is tcoco.COCOEvaluator
    # the port's names carry no TPU, and no alias keeps the old ones
    assert not hasattr(tcoco, "COCOEvaluatorTPU")
    assert not hasattr(tlvis, "LVISEvaluatorTPU")
