"""ViTDetRCNN (``locov_torch/models/meta_arch/vitdet_rcnn.py``) on the CPU
at a tiny size, against the benchmark's plain float32 reference
(``benchmark/reference/locov_ref``), with the same seeded weights.

The tiny model: width 64, 4 heads of 16, depth 4 with one global block
(block 1), windows of 4 on a 10 x 10 grid (padded to 12 x 12), a
pyramid of three levels (P3, P4 and P5 from the top block), the RPN over
the three, ROIAlign on P3 and P4. Tolerances: the trunk, the levels and
the RPN logits within 1e-5 of the largest value (float32 sums in
another order); the proposals equal bit for bit (the same selection);
the detections matched by box (IoU 0.99, the same class, scores within
1e-5). Dropping the relative-position bias (the tables zeroed here)
moves the levels by more than ten times that tolerance.
"""
import math

import numpy as np
import pytest
import torch

from benchmark.reference.locov_ref.config import get_cfg as ref_get_cfg
from benchmark.reference.locov_ref.models import build_meta_arch as ref_build
from benchmark.reference.locov_ref.models.meta_arch import \
    vitdet_rcnn as ref_vitdet
from benchmark.reference.locov_ref.models import rpn as ref_rpn
from benchmark.reference.locov_ref.ops.roi_align import \
    roi_align_batched as ref_roi_align
from benchmark.reference.locov_ref.structures import batches as ref_types
from locov_torch.config import config_path, get_cfg
from locov_torch.models import build_meta_arch, rpn
from locov_torch.models.box_head import assign_boxes_to_levels
from locov_torch.models.meta_arch import vitdet_rcnn
from locov_torch.ops import nms as nms_ops
from locov_torch.ops.rel_attention import (rel_attention_plain,
                                           rel_pos_terms)
from locov_torch.ops.roi_align import roi_align_batched, roi_align_levels
from locov_torch.structures import boxes as box_ops
from locov_torch.structures import batches as types
from locov_torch.utils.weights import seeded_init_

TINY = {
    "MODEL.VIT.EMBED_DIM": 64, "MODEL.VIT.DEPTH": 4,
    "MODEL.VIT.NUM_HEADS": 4, "MODEL.VIT.WINDOW_SIZE": 4,
    "MODEL.VIT.WINDOW_BLOCK_INDEXES": [0, 2, 3],
    "MODEL.VIT.PRETRAIN_IMG_SIZE": 64,
    "MODEL.SIMPLE_FPN.SCALE_FACTORS": [2.0, 1.0],
    "MODEL.SIMPLE_FPN.OUT_CHANNELS": 32,
    "MODEL.SIMPLE_FPN.SQUARE_PAD": 160,
    "MODEL.ANCHOR_GENERATOR.SIZES": [[32], [64], [128]],
    "MODEL.RPN.IN_FEATURES": ["p3", "p4", "p5"],
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 100, "MODEL.RPN.POST_NMS_TOPK_TEST": 60,
    "MODEL.ROI_HEADS.IN_FEATURES": ["p3", "p4"],
    "MODEL.ROI_BOX_HEAD.EMB_DIM": 16,
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 4,
    "MODEL.ROI_BOX_HEAD.NUM_CONV": 2, "MODEL.ROI_BOX_HEAD.CONV_DIM": 32,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64, "TEST.DETECTIONS_PER_IMAGE": 20,
    "TPU.COMPUTE_DTYPE": "float32",
}
TOL = 1e-5


def _set(cfg, key, value):
    node = cfg
    *path, leaf = key.split(".")
    for part in path:
        node = getattr(node, part)
    setattr(node, leaf, value)


def tiny_cfg(get=get_cfg):
    cfg = get()
    cfg.merge_from_file(config_path("vitdet_b_stt.yaml"))
    for key, value in TINY.items():
        _set(cfg, key, value)
    return cfg


def _arrays():
    rng = np.random.default_rng(3)
    img = np.zeros((2, 160, 160, 3), np.float32)
    img[0, :120, :160] = rng.integers(0, 256, (120, 160, 3))
    img[1, :160, :120] = rng.integers(0, 256, (160, 120, 3))
    return dict(image=img, hw=np.array([[120, 160], [160, 120]], np.int32),
                orig_hw=np.array([[90, 120], [120, 90]], np.int32))


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    prog = seeded_init_(build_meta_arch(tiny_cfg(), device="cpu"), 5).eval()
    # the RPN's seeded logits are ~1e-3: a wider objectness filter makes
    # the proposals' order depend on the image
    with torch.no_grad():
        prog.rpn_head.objectness_logits.weight.mul_(100.0)
    ref = ref_build(tiny_cfg(ref_get_cfg), device="cpu").eval()
    ref.load_state_dict(prog.state_dict())
    arrays = _arrays()
    batch = types.to_torch(types.DetectionBatch(
        images=types.ImageBatch(**arrays)), "cpu")
    ref_batch = ref_types.to_torch(ref_types.DetectionBatch(
        images=ref_types.ImageBatch(**arrays)), "cpu")
    emb = torch.randn(7, 16, generator=torch.Generator().manual_seed(1)) * 3
    return prog, ref, batch, ref_batch, emb


def _close(got, want, tol=TOL):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_state_dicts_share_detectron2_names(models):
    prog, ref = models[:2]
    assert list(prog.state_dict()) == list(ref.state_dict())
    keys = set(prog.state_dict())
    assert {"backbone.net.pos_embed", "backbone.net.blocks.1.attn.rel_pos_h",
            "backbone.simfp_3.0.weight", "backbone.simfp_3.1.norm.weight",
            "rpn_head.conv.conv1.weight",
            "roi_heads.box_head.conv2.norm.bias",
            "roi_heads.box_head.fc1.weight",
            "roi_heads.box_predictor.emb_pred.weight"} <= keys
    # a windowed block's tables have 2 * 4 - 1 rows, the global one's
    # 2 * 10 - 1
    sd = prog.state_dict()
    assert sd["backbone.net.blocks.0.attn.rel_pos_h"].shape == (7, 16)
    assert sd["backbone.net.blocks.1.attn.rel_pos_w"].shape == (19, 16)


def test_trunk_levels_and_rpn_match_the_reference(models):
    prog, ref, batch, ref_batch, _ = models
    with torch.no_grad():
        x = prog.preprocess(batch.images)
        trunk = prog.backbone.net(x)
        want = ref.backbone.net(x)
        assert trunk.shape == (2, 10, 10, 64)
        assert _close(trunk, want)
        got, exp = prog.levels(batch.images), ref.levels(ref_batch.images)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            "p3": (2, 20, 20, 32), "p4": (2, 10, 10, 32),
            "p5": (2, 5, 5, 32)}
        for k in got:
            assert _close(got[k], exp[k]), k
        _, logits, deltas = prog.run_rpn(got)
        _, ref_logits, ref_deltas = ref.run_rpn(exp)
    assert logits.shape == (2, 3 * (400 + 100 + 25))
    assert _close(logits, ref_logits) and _close(deltas, ref_deltas)


def test_proposals_equal_exactly(models):
    prog, ref, batch = models[:3]
    with torch.no_grad():
        anchors, logits, deltas = prog.run_rpn(prog.levels(batch.images))
        got = vitdet_rcnn.select_proposals(anchors, logits, deltas,
                                           batch.images.hw, prog.rpn_cfg)
        want = ref_vitdet.select_proposals(anchors, logits, deltas,
                                           batch.images.hw, ref.rpn_cfg)
    assert got.boxes.shape == (2, 60, 4) and bool(got.mask.all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_detections_match_the_reference_by_box(models):
    prog, ref, batch, ref_batch, emb = models
    props = []
    orig = vitdet_rcnn.select_proposals

    def keep(*args):
        props.append(orig(*args))
        return props[-1]
    vitdet_rcnn.select_proposals = keep
    try:
        dets = prog.inference(batch, emb)
    finally:
        vitdet_rcnn.select_proposals = orig
    want = ref.detect_from_proposals(ref_batch, emb, props[0])
    assert int(dets.mask.sum()) == 40 == int(want["det_mask"].sum())
    for i in range(2):
        iou = box_ops.pairwise_iou(dets.boxes[i], want["det_boxes"][i])
        same = dets.classes[i][:, None] == want["det_classes"][i][None]
        close = (dets.scores[i][:, None] -
                 want["det_scores"][i][None]).abs() <= 1e-5
        assert bool(((iou >= 0.99) & same & close).any(dim=1).all())


def test_dropping_the_bias_fails_the_tolerance(models):
    """The tolerance sees the mechanism: the port's model with its
    position tables zeroed (here only, then restored), so that every
    bias term is 0 on the path the model runs, leaves the reference's
    levels by far more than ten times 1e-5."""
    prog, ref, batch, ref_batch, _ = models
    tables = [t for name, t in prog.named_parameters()
              if name.endswith(("rel_pos_h", "rel_pos_w"))]
    assert len(tables) == 2 * len(prog.backbone.net.blocks)
    saved = [t.detach().clone() for t in tables]
    try:
        with torch.no_grad():
            for t in tables:
                t.zero_()
            got, want = prog.levels(batch.images), ref.levels(ref_batch.images)
    finally:
        with torch.no_grad():
            for t, kept in zip(tables, saved):
                t.copy_(kept)
    for k in got:
        gap = float((got[k] - want[k]).abs().max())
        assert gap > 10 * TOL * float(want[k].abs().max()), k


GRIDS = pytest.mark.parametrize("grid", [(4, 4), (10, 10), (3, 5)],
                                ids=["window", "global", "oblong"])


def _qkv_tables(grid, n=2, nh=2, hd=8):
    kh, kw = grid
    gen = torch.Generator().manual_seed(kh * 100 + kw)
    l = kh * kw
    qkv = torch.randn(n, l, 3 * nh * hd, generator=gen, dtype=torch.float64)
    rh = torch.randn(2 * kh - 1, hd, generator=gen, dtype=torch.float64)
    rw = torch.randn(2 * kw - 1, hd, generator=gen, dtype=torch.float64)
    return qkv, rh, rw


@GRIDS
def test_decomposed_bias_against_the_direct_formula(grid):
    """s_ij = q_i . k_j / sqrt(hd) + q_i . Rh[i_h - j_h + kh - 1] +
    q_i . Rw[i_w - j_w + kw - 1], evaluated entry by entry, then the
    softmax and the context."""
    kh, kw = grid
    n, nh, hd = 2, 2, 8
    l = kh * kw
    qkv, rh, rw = _qkv_tables(grid, n, nh, hd)
    q, k, v = (t.reshape(n, l, nh, hd).transpose(1, 2)
               for t in qkv.split(nh * hd, dim=-1))
    s = torch.empty(n, nh, l, l, dtype=torch.float64)
    for i in range(l):
        ih, iw = divmod(i, kw)
        for j in range(l):
            jh, jw = divmod(j, kw)
            s[:, :, i, j] = ((q[:, :, i] * k[:, :, j]).sum(-1) / math.sqrt(hd)
                             + (q[:, :, i] * rh[ih - jh + kh - 1]).sum(-1)
                             + (q[:, :, i] * rw[iw - jw + kw - 1]).sum(-1))
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(n, l, -1)
    rel_h, rel_w = rel_pos_terms(q, rh, rw, grid)
    got = rel_attention_plain(qkv.float(), rh.float(), rw.float(), nh, grid)
    assert rel_h.shape == (n, nh, l, kh) and rel_w.shape == (n, nh, l, kw)
    assert float((got.double() - want).abs().max()) < 1e-5


@GRIDS
def test_plain_entry_is_the_terms_then_the_attention(grid):
    """The plain entry, given the tables, equals ``rel_pos_terms`` (the
    terms in float32) followed by the attention on those terms, the
    scores materialized, in float64: the card's kernel and the CPU route
    keep one meaning of the tables."""
    kh, kw = grid
    n, nh, hd = 2, 2, 8
    l = kh * kw
    qkv, rh, rw = (t.float() for t in _qkv_tables(grid, n, nh, hd))
    q, k, v = (t.reshape(n, l, nh, hd).transpose(1, 2).double()
               for t in qkv.split(nh * hd, dim=-1))
    rel_h, rel_w = rel_pos_terms(q.float(), rh, rw, grid)
    assert rel_h.dtype == torch.float32 and rel_w.dtype == torch.float32
    s = (q / math.sqrt(hd)) @ k.transpose(-1, -2)
    s = (s.view(n, nh, l, kh, kw) + rel_h.double()[..., :, None]
         + rel_w.double()[..., None, :]).view(n, nh, l, l)
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(n, l, -1)
    got = rel_attention_plain(qkv, rh, rw, nh, grid)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("side,level", [
    (111.99, 2), (112.0, 3), (223.99, 3), (224.0, 4), (447.98, 4),
    (448.0, 5), (8.0, 2), (2000.0, 5)])
def test_level_assignment_at_the_area_boundaries(side, level):
    boxes = torch.tensor([[10.0, 20.0, 10.0 + side, 20.0 + side]])
    assert int(assign_boxes_to_levels(boxes, 2, 5)[0]) == level - 2
    assert int(ref_vitdet.box_levels(boxes, 2, 5)[0]) == level - 2


def test_multi_level_roi_align_against_each_levels_boxes():
    gen = torch.Generator().manual_seed(2)
    sides, b, n, c = (32, 16, 8, 4), 2, 24, 8
    feats = [torch.randn(b, s, s, c, generator=gen) for s in sides]
    xy = torch.rand(b, n, 2, generator=gen) * 100
    wh = torch.rand(b, n, 2, generator=gen) * 60 + 2
    boxes = torch.cat([xy, xy + wh], -1)
    levels = torch.randint(0, 4, (b, n), generator=gen, dtype=torch.int32)
    scales = [2.0 ** -k for k in (2, 3, 4, 5)]
    got = roi_align_levels(feats, boxes, levels, scales, 7, 0)
    assert got.shape == (b, n, 7, 7, c)
    for i in range(b):
        for lvl in range(4):
            sel = torch.nonzero(levels[i] == lvl).flatten()
            if not sel.numel():
                continue
            want = ref_roi_align(feats[lvl][i:i + 1], boxes[i:i + 1, sel],
                                 scales[lvl], 7, 0)[0]
            assert _close(got[i, sel], want, 1e-6)
            same = roi_align_batched(feats[lvl][i:i + 1],
                                     boxes[i:i + 1, sel], scales[lvl], 7, 0)
            assert _close(got[i, sel], same[0], 1e-6)


def _greedy_nms(boxes, scores, thresh):
    """Plain greedy NMS of one set, by score (stable), as a keep list."""
    order = sorted(range(len(scores)), key=lambda i: -float(scores[i]))
    keep = []
    for i in order:
        if all(float(box_ops.pairwise_iou(boxes[i:i + 1],
                                          boxes[j:j + 1])[0, 0]) <= thresh
               for j in keep):
            keep.append(i)
    return keep


def test_per_level_topk_and_nms_against_a_loop_over_levels():
    gen = torch.Generator().manual_seed(4)
    cfg = tiny_cfg()
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 40
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 50
    sides = (8, 4, 2)
    rcfg = rpn.PyramidRPNConfig.from_cfg(cfg, (8, 16, 32), sides)
    cells = rpn.level_cell_anchors(rcfg.level_anchor_sizes,
                                   (0.5, 1.0, 2.0))
    anchors = torch.cat([rpn.grid_anchors(cells[i], s, s, st, 0.0)
                         for i, (s, st) in enumerate(zip(sides, (8, 16,
                                                                 32)))])
    b = 2
    logits = torch.randn(b, anchors.shape[0], generator=gen)
    deltas = torch.randn(b, anchors.shape[0], 4, generator=gen) * 0.2
    hw = torch.tensor([[64, 60], [50, 64]], dtype=torch.int32)
    got = rpn.select_level_proposals(anchors, logits, deltas, hw, rcfg)
    for i in range(b):
        boxes, scores, off = [], [], 0
        for n in rcfg.level_sizes:
            s, j = torch.sort(logits[i, off:off + n], descending=True,
                              stable=True)
            s, j = s[:40], j[:40] + off
            bx = box_ops.apply_deltas(deltas[i, j], anchors[j],
                                      rcfg.rpn.bbox_reg_weights)
            bx = box_ops.clip(bx[None], (hw[i:i + 1, 0:1],
                                         hw[i:i + 1, 1:2]))[0]
            ok = box_ops.nonempty(bx)
            bx, s = bx[ok], s[ok]
            keep = _greedy_nms(bx, s, rcfg.rpn.nms_thresh)
            boxes.append(bx[keep])
            scores.append(s[keep])
            off += n
        boxes, scores = torch.cat(boxes), torch.cat(scores)
        top = torch.sort(scores, descending=True, stable=True).indices[:50]
        m = got.mask[i]
        assert int(m.sum()) == min(50, len(scores))
        assert torch.equal(got.objectness[i][m], scores[top])
        assert torch.allclose(got.boxes[i][m], boxes[top])


def test_c4_rpn_config_and_selection_unchanged():
    """On coco_stt.yaml the RPN's config is the single-level one it was,
    and its selection gives the reference's (the C4 code's copy) bits."""
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    rcfg = rpn.RPNConfig.from_cfg(cfg)
    assert type(rcfg) is rpn.RPNConfig
    assert rcfg.stride == 16 and rcfg.sizes == (32, 64, 128, 256, 512)
    assert rcfg._fields[:4] == ("sizes", "aspect_ratios", "stride", "offset")
    assert (rcfg.pre_nms_topk_test, rcfg.post_nms_topk_test) == (6000, 1000)
    assert tuple(ref_rpn.RPNConfig.from_cfg(cfg)) == tuple(rcfg)
    gen = torch.Generator().manual_seed(6)
    cells = rpn.generate_cell_anchors(rcfg.sizes, rcfg.aspect_ratios)
    anchors = rpn.grid_anchors(cells, 12, 16, 16, 0.0)
    logits = torch.randn(2, anchors.shape[0], generator=gen)
    deltas = torch.randn(2, anchors.shape[0], 4, generator=gen) * 0.1
    hw = torch.tensor([[180, 250], [190, 240]], dtype=torch.int32)
    small = rcfg._replace(pre_nms_topk_test=600, post_nms_topk_test=100)
    got = rpn.select_proposals(anchors, logits, deltas, hw, small)
    want = ref_rpn.select_proposals(anchors, logits, deltas, hw,
                                    ref_rpn.RPNConfig(*small))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_losses_raise_and_the_nms_counts_levels_apart(models):
    prog = models[0]
    with pytest.raises(NotImplementedError):
        prog.losses(None, None)
    # two identical boxes on two levels both survive the level-wise NMS
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 10.0]]])
    keep = nms_ops.batched_nms_mask_batched(
        boxes, torch.tensor([[2.0, 1.0]]), torch.tensor([[0, 1]]),
        torch.ones(1, 2, dtype=torch.bool), 0.7)
    assert bool(keep.all())


def test_profile_step_splits_a_vitdet_call_by_stage():
    from locov_torch.tools import profile_step
    assert "ViTDetRCNN." in profile_step.STAGE_PREFIXES
    assert {s: profile_step.BUCKET_OF_STAGE[s] for s in (
        "window_attention", "global_attention", "pyramid", "box_head",
        "backbone", "select_proposals")} == {
        "window_attention": "window_attn", "global_attention": "global_attn",
        "pyramid": "pyramid", "box_head": "box_head",
        "backbone": "backbone", "select_proposals": "rpn+nms"}
    assert profile_step.hand_kernel(
        "(anonymous namespace)::rel_attention_kernel(__nv_bfloat16 const*)"
    ) == "rel_attention_kernel"
