"""Test-time augmentation of the port (locov_torch/evaluation/tta.py,
``engine/trainer.py:test`` with TEST.AUG.ENABLED) against the JAX
package's (locov_tpu/evaluation/tta.py), the twin of tests/test_tta.py.

The host merge (``greedy_nms``, ``merge_tta_detections``) gives JAX's
indices and arrays on seeded random sets; a perfect fake detector, run
unflipped and flipped, merges to AP 100; ``build_tta_loaders`` gives one
loader a size and flip; ``test`` with two sizes and the flip on the
micro-COCO tree (the tiny tamed model of tests/test_torch_evaluator.py,
JAX's weights) matches JAX's TTA evaluation (its ``build_tta_loaders``
and ``inference_with_tta`` over its mesh step) within that file's
bounds (AP keys within 1e-6 points); and TTA with the one test size and
no flip gives the plain evaluation's AP keys, where the merge, which
re-runs the per-class NMS at the threshold inference already applied
(float64, on boxes rescaled to the original image), removes the
detections it is asserted to remove.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from locov_tpu.data import get_register_dataset as jregister
from locov_tpu.data.synthetic import micro_cfg as jmicro_cfg
from locov_tpu.evaluation import tta as jtta
from locov_tpu.parallel import get_mesh
from locov_torch.data import DatasetCatalog as TCat
from locov_torch.data import get_register_dataset as tregister
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.engine import trainer as ttrainer
from locov_torch.evaluation import tta as ttta
from locov_torch.structures.batches import Detections
from test_torch_eval_helpers import fresh_catalogs
from test_torch_evaluator import (AP_KEYS, NAME, _assert_ap_keys,  # noqa
                                  eval_cfg, micro, pair)


def _random_sets(rng, n_sets=6, n=80):
    for _ in range(n_sets):
        xy = rng.rand(n, 2) * 60
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * 30 + 1], 1)
        yield {"img": rng.randint(0, 4, n).astype(np.int64),
               "box": boxes,
               "score": np.round(rng.rand(n), 2),  # ties among scores
               "cls": rng.randint(1, 4, n).astype(np.int64)}


def test_greedy_nms_and_merge_match_jax():
    rng = np.random.RandomState(0)
    for flat in _random_sets(rng):
        for thresh in (0.3, 0.5, 0.7):
            for classes in (None, flat["cls"]):
                np.testing.assert_array_equal(
                    ttta.greedy_nms(flat["box"], flat["score"], thresh,
                                    classes),
                    jtta.greedy_nms(flat["box"], flat["score"], thresh,
                                    classes))
            for topk in (3, 100):
                got = ttta.merge_tta_detections(flat, thresh, topk)
                want = jtta.merge_tta_detections(flat, thresh, topk)
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
                    assert got[k].dtype == want[k].dtype


K = 8


class FakeLoader:
    def __init__(self, records, mirror=False):
        self.records = records
        self.mirror = mirror

    def __len__(self):
        return len(self.records)

    def __iter__(self):
        for r in self.records:
            yield SimpleNamespace(
                images=SimpleNamespace(
                    image_id=np.asarray([r["image_id"]]),
                    orig_hw=np.asarray([[r["height"], r["width"]]])),
                _rec=r, _mirror=self.mirror)


def _fake_eval_step():
    """A perfect detector, the port's step signature: the records' gt
    boxes (XYXY) and contiguous class ids, mirrored when the loader is
    the flipped augmentation."""
    def step(batch, class_emb):
        r = batch._rec
        boxes = []
        for a in r["annotations"]:
            b = np.asarray(a["bbox"], np.float64)
            if batch._mirror:
                b = np.array([r["width"] - b[2], b[1], r["width"] - b[0],
                              b[3]])
            boxes.append(b)
        n = len(boxes)
        out_b = np.zeros((1, K, 4), np.float32)
        out_b[0, :n] = np.stack(boxes)[:K]
        out_s = np.zeros((1, K), np.float32)
        out_s[0, :n] = 0.9
        out_c = np.zeros((1, K), np.int64)
        out_c[0, :n] = [a["category_id"]
                        for a in r["annotations"]][:K]
        mask = np.zeros((1, K), bool)
        mask[0, :n] = True
        return Detections(boxes=out_b, scores=out_s, classes=out_c,
                          mask=mask)
    return step


def test_tta_flip_merge_equals_perfect_ap(micro):
    """Normal and flipped passes give duplicate (mirrored) detections;
    after the mirror back and the merge, the AP is the perfect 100."""
    fresh_catalogs()
    tregister(NAME)(NAME, micro)
    recs = TCat.get(NAME)
    loaders = [(FakeLoader(recs, mirror=False), False),
               (FakeLoader(recs, mirror=True), True)]
    res = ttta.inference_with_tta(_fake_eval_step(), None, loaders,
                                  None, NAME, nms_thresh=0.5, topk=10)
    assert res["AP"] == pytest.approx(100.0, abs=1e-6)
    assert res["AP50"] == pytest.approx(100.0, abs=1e-6)
    n_gt = sum(min(len(r["annotations"]), K) for r in recs)
    assert (res["tta_passes"], res["tta_detections"], res["tta_merged"]) \
        == (2, 2 * n_gt, n_gt)


def _tta_cfg(micro_cfg, root, sizes, flip, max_size=96):
    cfg = eval_cfg(micro_cfg, root)
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES = sizes
    cfg.TEST.AUG.MAX_SIZE = max_size
    cfg.TEST.AUG.FLIP = flip
    return cfg


def test_build_tta_loaders_one_per_size_and_flip(micro):
    fresh_catalogs()
    cfg = _tta_cfg(tmicro_cfg, micro, (64, 96), True, 128)
    loaders = ttta.build_tta_loaders(cfg, NAME)
    try:
        assert len(loaders) == 4
        assert [f for _, f in loaders] == [False, True, False, True]
        assert [ld.mapper.flip_mode for ld, _ in loaders] == \
            ["none", "horizontal_always"] * 2
        assert [ld.mapper.min_sizes for ld, _ in loaders] == \
            [(64,), (64,), (96,), (96,)]
        assert {ld.mapper.max_size for ld, _ in loaders} == {128}
        plain, flipped = (next(iter(ld)) for ld, _ in loaders[:2])
        np.testing.assert_array_equal(plain.images.image_id,
                                      flipped.images.image_id)
        i = 0
        h, w = plain.images.hw[i]
        np.testing.assert_array_equal(
            flipped.images.image[i, :h, :w],
            plain.images.image[i, :h, :w][:, ::-1])
    finally:
        for ld, _ in loaders:
            ld.close()


def test_tta_evaluation_matches_jax(pair, micro):
    """``test`` with sizes 64 and 80 and the flip (4 passes; the tiny
    random-init model's AP50 is small but not 0 there) against JAX's TTA
    evaluation: its ``build_tta_loaders`` (through the test loader of
    its trainer) and ``inference_with_tta`` over its mesh step."""
    jcfg = _tta_cfg(jmicro_cfg, micro, (64, 80), True)
    tcfg = _tta_cfg(tmicro_cfg, micro, (64, 80), True)

    class JaxLoaders:
        tokenizer = None
        needs_text = False
        mesh = get_mesh()

        def build_test_loader(self, c, ds):
            from locov_tpu.engine.trainer import OVRTrainer
            return OVRTrainer.build_test_loader(self, c, ds)

    jregister(NAME)(NAME, micro)
    want = jtta.inference_with_tta(
        pair["jstep"], pair["v"],
        jtta.build_tta_loaders(JaxLoaders(), jcfg, NAME), pair["ce"], NAME,
        jcfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, jcfg.TEST.DETECTIONS_PER_IMAGE)
    got = ttrainer.test(tcfg, pair["tm"], "cpu")[NAME]
    _assert_ap_keys(want, got, AP_KEYS)
    assert got["tta_passes"] == 4
    assert got["AP50"] > 0


def test_one_size_without_flip_is_the_plain_evaluation(pair, micro):
    """TTA at the test size alone, unflipped: the same detections as the
    plain evaluation, then the merge's per-class NMS at the threshold
    inference applied. It removes exactly the detections that
    ``merge_tta_detections`` removes from the plain evaluation's flat
    detections (pairs whose float64 IoU on the rescaled boxes exceeds the
    threshold though the float32 IoU in inference did not); where it
    removes none, the AP keys are the plain evaluation's."""
    tcfg = pair["tcfg"].clone()
    cfg = _tta_cfg(tmicro_cfg, micro, (tcfg.INPUT.MIN_SIZE_TEST,), False,
                   tcfg.INPUT.MAX_SIZE_TEST)
    plain = ttrainer.test(tcfg, pair["tm"], "cpu")[NAME]
    tta = ttrainer.test(cfg, pair["tm"], "cpu")[NAME]
    flat = pair["tflat"]
    merged = ttta.merge_tta_detections(
        flat, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        cfg.TEST.DETECTIONS_PER_IMAGE)
    removed = len(flat["img"]) - len(merged["img"])
    assert tta["tta_passes"] == 1
    assert tta["tta_detections"] == len(flat["img"])
    assert tta["tta_detections"] - tta["tta_merged"] == removed
    print(f"the merge removed {removed} of {len(flat['img'])} detections")
    if removed == 0:
        _assert_ap_keys(plain, tta, AP_KEYS)
    assert removed <= len(flat["img"]) // 100


def test_tta_flip_flips_the_precomputed_proposals_horizontally(micro):
    """The TTA flip ("horizontal_always") mirrors the image and its
    precomputed proposals left to right, as the random horizontal flip
    does. (JAX's mapper flips the proposals vertically there: ROADMAP
    §3; the port does what it means.)"""
    from locov_torch.data.mappers import DetectionMapper
    fresh_catalogs()
    name = "coco_captions_train_seen_proposals"
    tregister(name)(name, micro)
    cfg = tmicro_cfg(micro)
    cfg.MODEL.LOAD_OBJ_PROPOSALS = True
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    from locov_torch.data import MetadataCatalog
    mapper = DetectionMapper(cfg, MetadataCatalog.get(name), False, seed=0)
    rec = TCat.get(name)[0]
    plain = mapper(rec)
    mapper.flip_mode = "horizontal_always"
    flipped = mapper(rec)
    w = plain["image"].shape[1]
    np.testing.assert_array_equal(flipped["image"], plain["image"][:, ::-1])
    want = plain["proposal_boxes"].copy()
    want[:, 0] = w - plain["proposal_boxes"][:, 2]
    want[:, 2] = w - plain["proposal_boxes"][:, 0]
    assert len(want) > 0
    np.testing.assert_allclose(flipped["proposal_boxes"], want, atol=1e-4)
