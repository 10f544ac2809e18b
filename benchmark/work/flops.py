"""Model FLOPs of the cells' steps, from their shapes: 2 per
multiply-add of every convolution, matrix product and attention
product; normalisations, activations, NMS and ROIAlign's interpolation
are not counted (ROIAlign is held to its bytes, ``work/roi_align.py``).

A training step counts the forward and the backward of the parts it
trains: the backward is twice the forward (the gradients of the inputs
and of the weights), once where only one of them is needed (the stem,
whose input is the image; the MLM decoder, whose word embeddings are
frozen). Frozen parts count their forward alone, and a recompute under
remat is not counted.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Dims(NamedTuple):
    """The widths and counts the FLOPs depend on (``dims_from_cfg``)."""
    stem_out: int = 64
    res2_out: int = 256
    bottleneck: int = 64          # num_groups * width_per_group at res2
    pooled: int = 14              # ROIAlign's output side
    anchors: int = 15             # anchors a location
    emb_dim: int = 768            # the box predictor's embedding
    classes: int = 81             # class-embedding rows, background too
    hidden: int = 768             # joint encoder
    layers: int = 6
    intermediate: int = 768
    vocab: int = 30522
    regions: int = 100            # SPATIAL_DROPOUT
    freeze_at: int = 0


def dims_from_cfg(cfg, classes: int) -> Dims:
    r, t = cfg.MODEL.RESNETS, cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG
    lang = cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG
    a = cfg.MODEL.ANCHOR_GENERATOR
    return Dims(stem_out=r.STEM_OUT_CHANNELS, res2_out=r.RES2_OUT_CHANNELS,
                bottleneck=r.NUM_GROUPS * r.WIDTH_PER_GROUP,
                pooled=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
                anchors=len(a.SIZES[0]) * len(a.ASPECT_RATIOS[0]),
                emb_dim=cfg.MODEL.ROI_BOX_HEAD.EMB_DIM, classes=classes,
                hidden=t.hidden_size, layers=t.num_hidden_layers,
                intermediate=t.intermediate_size, vocab=lang.vocab_size,
                regions=cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT,
                freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT)


def conv(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1,
         pad: int = 0) -> Tuple[float, int, int]:
    """(FLOPs, out h, out w) of one k x k convolution."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return 2.0 * ho * wo * cout * cin * k * k, ho, wo


def stage(h: int, w: int, cin: int, width: int, cout: int, blocks: int,
          stride: int) -> Tuple[float, int, int]:
    """(FLOPs, out h, out w) of a ResNet stage of Caffe bottlenecks
    (the stride on the first 1x1, a 1x1 shortcut where the width
    changes)."""
    total = 0.0
    for i in range(blocks):
        s = stride if i == 0 else 1
        c_in = cin if i == 0 else cout
        f1, ho, wo = conv(h, w, c_in, width, 1, s)
        f2, _, _ = conv(ho, wo, width, width, 3, 1, 1)
        f3, _, _ = conv(ho, wo, width, cout, 1)
        total += f1 + f2 + f3
        if c_in != cout:
            total += conv(h, w, c_in, cout, 1, s)[0]
        h, w = ho, wo
    return total, h, w


def trunk(d: Dims, h: int, w: int) -> Dict[str, float]:
    """FLOPs a image of the C4 trunk on an h x w canvas, by part (the
    stem, res2, res3, res4), and the res4 map's side (h16, w16)."""
    out = {}
    out["stem"], h, w = conv(h, w, 3, d.stem_out, 7, 2, 3)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # the 3x3/2 pool
    width, c = d.bottleneck, d.res2_out
    out["res2"], h, w = stage(h, w, d.stem_out, width, c, 3, 1)
    out["res3"], h, w = stage(h, w, c, width * 2, c * 2, 4, 2)
    out["res4"], h, w = stage(h, w, c * 2, width * 4, c * 4, 6, 2)
    return out, (h, w)


def res5(d: Dims, n: int, h: int, w: int) -> float:
    """res5 on ``n`` maps of h x w (the ROIs' pooled maps, or the grid)."""
    c4 = d.res2_out * 4
    return n * stage(h, w, c4, d.bottleneck * 8, d.res2_out * 8, 3, 2)[0]


def rpn_head(d: Dims, h16: int, w16: int) -> float:
    c4 = d.res2_out * 4
    return (conv(h16, w16, c4, c4, 3, 1, 1)[0] +
            conv(h16, w16, c4, d.anchors * 5, 1)[0])


def box_predictor(d: Dims, n: int) -> float:
    """The embedding projection, the class scores and the box deltas of
    ``n`` ROIs."""
    c5 = d.res2_out * 8
    return 2.0 * n * (c5 * d.emb_dim + d.emb_dim * d.classes + c5 * 4)


def encoder(d: Dims, seqs: int, tokens: int) -> float:
    """The joint encoder over ``seqs`` sequences of ``tokens``: per
    layer the four D x D projections, the two attention products and
    the feed-forward pair."""
    dd, t = d.hidden, tokens
    per_layer = (4 * t * dd * dd + 2 * t * t * dd +
                 2 * t * dd * d.intermediate)
    return 2.0 * seqs * d.layers * per_layer


def mmss_pass(d: Dims, b: int, words: int) -> Dict[str, float]:
    """One MMSS pass (grid or box regions) over a batch of ``b``: the
    shared projection of the regions, the grounding head's B x B local
    similarities (its alignments and distances are not products), the
    transformer head's visual embedding, the encoder over the B^2 pairs
    with its pooler and matching score, and the MLM head on the B
    diagonal captions (its decoder apart)."""
    r, dd, c5 = d.regions, d.hidden, d.res2_out * 8
    pairs = b * b
    return {
        "projection": 2.0 * b * r * c5 * dd,
        "grounding": 2.0 * pairs * words * r * dd,
        "visual_emb": 2.0 * b * r * (dd * dd + 2 * dd),
        "encoder": encoder(d, pairs, words + r) +
        2.0 * pairs * (dd * dd + dd * 2),
        "mlm_transform": 2.0 * b * words * dd * dd,
        "mlm_decoder": 2.0 * b * words * dd * d.vocab,
    }


def lsm_step(d: Dims, b: int, h: int, w: int, rois: int,
             words: int) -> float:
    """Model FLOPs of one LSM training step (``DistillProposalMMSSRCNN``
    at FREEZE_AT 0): the trunk, the RPN head, res5 and the predictor on
    ``rois`` sampled ROIs an image, res5 on the whole res4 map (the grid
    pass), and two MMSS passes; forward and backward."""
    parts, (h16, w16) = trunk(d, h, w)
    fwd_trained = b * (parts["res2"] + parts["res3"] + parts["res4"] +
                       rpn_head(d, h16, w16)) + \
        res5(d, b * rois, d.pooled, d.pooled) + res5(d, b, h16, w16) + \
        box_predictor(d, b * rois)
    once = b * parts["stem"]
    for _ in range(2):  # the grid pass and the box pass
        p = mmss_pass(d, b, words)
        once += p.pop("mlm_decoder")
        fwd_trained += sum(p.values())
    return 3 * fwd_trained + 2 * once


def stt_inference(d: Dims, b: int, h: int, w: int, proposals: int
                  ) -> float:
    """Model FLOPs of one STT inference call: the trunk, the RPN head,
    res5 and the predictor on every proposal."""
    parts, (h16, w16) = trunk(d, h, w)
    return b * (sum(parts.values()) + rpn_head(d, h16, w16)) + \
        res5(d, b * proposals, d.pooled, d.pooled) + \
        box_predictor(d, b * proposals)
