"""The FLOP counts of ``benchmark/work/`` against torch's own count
(``FlopCounterMode``) of the plain reference's modules at a tiny size."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import build
from benchmark.tests.tiny import tiny_cell
from benchmark.traffic import common
from benchmark.work import flops as F
from benchmark.work import roi_align as R


@pytest.fixture(scope="module")
def tiny():
    from benchmark.reference.locov_ref.models import build_meta_arch
    cell = tiny_cell("lsm_global_b32")
    cfg = build.reference_cfg(cell["config"])
    model = build_meta_arch(cfg, device="cpu")
    model.load_state_dict(build.make_weights(model, 1, "cpu", True))
    return cell, cfg, model, F.dims_from_cfg(cfg, 81)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return fc.get_total_flops(), out


@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (72, 72)])
def test_trunk_and_rpn_head(tiny, hw):
    _, _, model, d = tiny
    x = torch.randn(2, *hw, 3)
    n, feats = counted(lambda: model.backbone(x)["res4"])
    parts, (h16, w16) = F.trunk(d, *hw)
    assert n == 2 * sum(parts.values())
    assert tuple(feats.shape[1:3]) == (h16, w16)
    n, _ = counted(lambda: model.rpn_head(feats))
    assert n == 2 * F.rpn_head(d, h16, w16)


def test_res5_on_rois_and_on_the_grid(tiny):
    _, _, model, d = tiny
    c4 = d.res2_out * 4
    n, _ = counted(lambda: model.roi_heads.res5(
        torch.randn(5, d.pooled, d.pooled, c4)))
    assert n == F.res5(d, 5, d.pooled, d.pooled)
    n, _ = counted(lambda: model.roi_heads.grid_features(
        torch.randn(2, 4, 6, c4)))
    assert n == F.res5(d, 2, 4, 6)


def test_mmss_pass(tiny):
    from benchmark.reference.locov_ref.structures import batches as T
    cell, _, model, d = tiny
    b, words = 2, cell["traffic"]["text"]["slots"]
    text = T.to_torch(T.TextBatch(**common.captions(
        np.random.default_rng(0), b, cell["traffic"]["text"])), "cpu")
    caption = model.language_backbone(text, deterministic=True)
    regions = T.RegionFeatures(
        features=torch.randn(b, d.regions, d.res2_out * 8),
        mask=torch.ones(b, d.regions, dtype=torch.bool),
        loc=torch.rand(b, d.regions, 2))
    n, _ = counted(lambda: model.mmss_heads(
        regions, caption, model.language_backbone.word_embedding_matrix(),
        True, None))
    assert n == sum(F.mmss_pass(d, b, words).values())


def test_box_predictor(tiny):
    _, _, model, d = tiny
    x = torch.randn(7, d.res2_out * 8)
    n, _ = counted(lambda: model.roi_heads.predict(
        x, torch.randn(d.classes, d.emb_dim),
        model.mmss_heads.project(x)))
    assert n == F.box_predictor(d, 7)  # the shared projection included


def test_full_width_counts():
    """The counts at the cells' shapes, as PERF.md quotes them."""
    d = F.Dims()
    assert F.lsm_step(d, 32, 800, 1344, 200, 70) == pytest.approx(
        99.774e12, rel=1e-4)
    assert F.stt_inference(d._replace(classes=66, freeze_at=2), 8, 800,
                           1344, 1000) == pytest.approx(13.451e12,
                                                        rel=1e-4)
    parts, side = F.trunk(d, 800, 1344)
    assert side == (50, 84)


def test_roi_align_bytes_count_each_byte_once():
    b, h, w, c, n, p = 2, 50, 84, 1024, 1000, 14
    fwd = R.forward_bytes(b, h, w, c, n, p, 2)
    assert fwd == 2 * (b * h * w * c + b * n * p * p * c) + 16 * b * n
    assert R.backward_bytes(b, h, w, c, n, p, 2) == fwd
