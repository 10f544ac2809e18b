"""The work of one call of ``ToyPyramidRCNN``: its convolutions, box
head and classifier, and ROIAlign's bytes on both levels."""
from .flops import conv
from .roi_align import forward_bytes


def request_work(cfg, classes: int, b: int, hw, words: int = 0) -> dict:
    c = cfg.MODEL.TOY_PYRAMID.CHANNELS
    n = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    a = len(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0])
    e = cfg.MODEL.ROI_BOX_HEAD.EMB_DIM
    (h, w), cin, flops, roi_bytes = hw, 3, 0.0, 0.0
    for i in range(4):
        f, h, w = conv(h, w, cin, c, 3, 2, 1)
        flops, cin = flops + f, c
        if i >= 2:  # a level: its lateral conv and the RPN head
            flops += conv(h, w, c, c, 1)[0] + conv(h, w, c, c, 3, 1, 1)[0] \
                + conv(h, w, c, 5 * a, 1)[0]
            roi_bytes += forward_bytes(b, h, w, c, n, p, 4)
    head = 2.0 * n * (c * p * p * 2 * c + 2 * c * (e + 4) + e * classes)
    return {"flops": b * (flops + head), "roi_bytes": roi_bytes}
