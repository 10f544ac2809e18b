"""The work of one ViTDet inference call (``ViTDetRCNN.inference``),
from the cell's configuration: the model FLOPs (2 per multiply-add of
every convolution, transposed convolution, matrix product and attention
product, as ``work/flops.py`` counts them), ROIAlign's bytes across the
pyramid's levels, and the attention's own work (``attention_work``:
KA2's products and bytes and the bias terms' products), for the
roofline of the ``window_attn`` and ``global_attn`` buckets."""
from __future__ import annotations

import math

from .flops import conv
from .roi_align import forward_bytes


def _shapes(cfg):
    v, f = cfg.MODEL.VIT, cfg.MODEL.SIMPLE_FPN
    grid = f.SQUARE_PAD // v.PATCH_SIZE
    return v, f, grid


def _attention_blocks(cfg):
    """(blocks, maps a image, tokens a map, grid side) of the windowed
    blocks, then of the global ones."""
    v, _, grid = _shapes(cfg)
    windowed = len(set(v.WINDOW_BLOCK_INDEXES))
    ws = v.WINDOW_SIZE
    nw = math.ceil(grid / ws) ** 2
    return ((windowed, nw, ws * ws, ws), (v.DEPTH - windowed, 1,
                                          grid * grid, grid))


def attention_work(cfg, b: int) -> dict:
    """The attention of one call of ``b`` images, in the stage ranges
    ``window_attention`` and ``global_attention``: ``attn_flops``, the
    two products q . k and p . v of every map and head and the bias
    terms q . Rh and q . Rw; ``attn_bytes``, KA2's reads of qkv (bf16)
    and of the two bias terms (float32) and its write of the context
    (bf16)."""
    v = cfg.MODEL.VIT
    c, heads = v.EMBED_DIM, v.NUM_HEADS
    flops = nbytes = 0.0
    for blocks, maps, l, k in _attention_blocks(cfg):
        n = b * maps
        flops += blocks * n * (2 * 2.0 * l * l * c + 2 * 2.0 * l * k * c)
        nbytes += blocks * n * (2.0 * l * 3 * c + 2.0 * l * c +
                                4.0 * heads * l * 2 * k)
    return {"attn_flops": flops, "attn_bytes": nbytes}


def request_work(cfg, classes: int, b: int, hw, words: int = 0) -> dict:
    """Model FLOPs and ROIAlign bytes of one call of ``b`` images on the
    square canvas (every image is padded to ``SQUARE_PAD``; ``hw`` is
    the bucket's canvas, at most that), and the attention's own work
    (``attention_work``)."""
    v, f, grid = _shapes(cfg)
    h = cfg.MODEL.ROI_BOX_HEAD
    c, t = v.EMBED_DIM, grid * grid
    mlp = int(c * v.MLP_RATIO)
    n = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    out, p = f.OUT_CHANNELS, h.POOLER_RESOLUTION
    a = len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]) * \
        len(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0])
    # the trunk: the patch embedding, each block's four products, the
    # attention
    trunk = conv(f.SQUARE_PAD, f.SQUARE_PAD, 3, c, v.PATCH_SIZE,
                 v.PATCH_SIZE)[0]
    trunk += v.DEPTH * 2.0 * t * (c * 3 * c + c * c + 2 * c * mlp)
    trunk += attention_work(cfg, 1)["attn_flops"]
    # the pyramid: transposed convs as per-pixel products, 1x1 and 3x3
    pyramid, sides, roi_bytes = 0.0, {}, 0.0
    for s in f.SCALE_FACTORS:
        d, side = c, grid
        if s == 4.0:
            pyramid += 2.0 * side * side * d * 4 * (d // 2)
            side, d = side * 2, d // 2
            pyramid += 2.0 * side * side * d * 4 * (d // 2)
            side, d = side * 2, d // 2
        elif s == 2.0:
            pyramid += 2.0 * side * side * d * 4 * (d // 2)
            side, d = side * 2, d // 2
        elif s == 0.5:
            side //= 2
        pyramid += conv(side, side, d, out, 1)[0] + \
            conv(side, side, out, out, 3, 1, 1)[0]
        sides[f"p{int(round(math.log2(v.PATCH_SIZE / s)))}"] = side
    last = max(sides, key=lambda k: int(k[1:]))  # the top level: P6
    sides[f"p{int(last[1:]) + 1}"] = -(-sides[last] // 2)
    rpn = 0.0
    for name in cfg.MODEL.RPN.IN_FEATURES:
        side = sides[name]
        rpn += len(cfg.MODEL.RPN.CONV_DIMS) * \
            conv(side, side, out, out, 3, 1, 1)[0] + \
            conv(side, side, out, 5 * a, 1)[0]
    # the box head on every proposal, then the predictor
    head, d = 0.0, out
    for _ in range(h.NUM_CONV):
        head += conv(p, p, d, h.CONV_DIM, 3, 1, 1)[0]
        d = h.CONV_DIM
    d *= p * p
    for _ in range(h.NUM_FC):
        head += 2.0 * d * h.FC_DIM
        d = h.FC_DIM
    e = h.EMB_DIM
    head += 2.0 * (d * e + e * classes + d * 4)
    # ROIAlign: every level of the ROI heads read once, each box's
    # pooled map written once, whatever level it takes. An upper bound:
    # the harness hands this function no box, so a level that few boxes
    # take is counted whole (with the seeded RPN, nearly every box takes
    # P2, and P3-P5 add 88 MB to the 469 MB a call of 8 moves)
    for name in cfg.MODEL.ROI_HEADS.IN_FEATURES:
        roi_bytes += forward_bytes(b, sides[name], sides[name], out, 0, p, 2)
    roi_bytes += forward_bytes(b, 0, 0, out, n, p, 2)
    return {"flops": b * (trunk + pyramid + rpn + n * head),
            "roi_bytes": roi_bytes, **attention_work(cfg, b)}
