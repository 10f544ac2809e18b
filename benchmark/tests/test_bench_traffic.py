"""Each traffic generator is determined by its seed."""
import collections

import numpy as np
import pytest
import torch

from benchmark import build
from benchmark.tests.tiny import CELLS, tiny_cell
from benchmark.traffic.detection import Traffic, draw_shapes, draws


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests(cell):
    p = tiny_cell(cell)["traffic"]
    seed = 2 ** 31 + 12345  # past 32 signed bits
    a, b, c = Traffic(p, seed), Traffic(p, seed), Traffic(p, seed + 1)
    assert a.order[:200] == b.order[:200]
    assert same(a.class_emb, b.class_emb)
    for i in range(12):
        assert a.request(i)[0] == b.request(i)[0]
        assert same(a.request(i)[1], b.request(i)[1])
    assert not same(a.request(0)[1], c.request(0)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_sends_the_same_mix(cell):
    p = build.load_cell(cell)["traffic"]
    p = dict(p, pool=1, buckets={k: dict(v, valid=[8, 8], padded=[8, 8])
                                 for k, v in p["buckets"].items()})
    block = sum(p["block"].values())
    first = len(p["first"])
    counts = []
    for seed in (1, 2, 3):
        order = Traffic(p, seed).order
        assert order[:first] == p["first"]
        counts.append(collections.Counter(order[first:first + block]))
    assert counts[0] == counts[1] == counts[2] == collections.Counter(
        p["block"])


def test_draws_follow_their_generator():
    cell = tiny_cell("lsm_global_b32")
    cfg = build.program_cfg(cell["config"])
    shapes = draw_shapes(cfg, 2, 64, 96, 6)
    assert shapes == {"anchors": 4 * 6 * 15, "rois": 24 + 6, "grid": 2 * 3,
                      "sampled": 12}
    one = draws(shapes, 2, torch.Generator().manual_seed(9), "cpu")
    two = draws(shapes, 2, torch.Generator().manual_seed(9), "cpu")
    assert all(torch.equal(x, y) for k in one for x, y in zip(
        one[k] if isinstance(one[k], tuple) else (one[k],),
        two[k] if isinstance(two[k], tuple) else (two[k],)))


def test_captions_and_gt_are_well_formed():
    p = build.load_cell("lsm_global_b32")["traffic"]
    t = Traffic(dict(p, pool=1, buckets={
        k: v for k, v in p["buckets"].items() if k == "square"},
        first=["square"], block={"square": 1}), 7)
    arrays = t.request(0)[1]
    text, gt = arrays["text"], arrays["gt"]
    words = (text["attention_mask"].sum(1) - 2)
    assert ((words >= 8) & (words <= 24)).all()
    assert (text["mlm_mask"].sum(1) >= 1).all()
    assert not (text["mlm_mask"] & text["special_tokens_mask"]).any()
    boxes = gt["boxes"]
    assert boxes.shape == (32, 200, 4)
    assert (boxes[..., 2:] <= 800).all() and (boxes[..., :2] >= 0).all()
    assert (arrays["images"]["hw"] == [800, 800]).all()
