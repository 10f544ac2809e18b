"""The work of one STT inference call (``OvrRCNN.inference``)."""
from .flops import dims_from_cfg, stt_inference, trunk
from .roi_align import forward_bytes


def request_work(cfg, classes: int, b: int, hw, words: int = 0) -> dict:
    d = dims_from_cfg(cfg, classes)
    n = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    _, (h16, w16) = trunk(d, *hw)
    return {"flops": stt_inference(d, b, hw[0], hw[1], n),
            "roi_bytes": forward_bytes(b, h16, w16, d.res2_out * 4, n,
                                       d.pooled, 2)}
