"""The work of one LSM training step (``DistillProposalMMSSRCNN``)."""
from .flops import dims_from_cfg, lsm_step, trunk
from .roi_align import backward_bytes, forward_bytes


def request_work(cfg, classes: int, b: int, hw, words: int) -> dict:
    d = dims_from_cfg(cfg, classes)
    rois = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    _, (h16, w16) = trunk(d, *hw)
    c4 = d.res2_out * 4
    return {"flops": lsm_step(d, b, hw[0], hw[1], rois, words),
            "roi_bytes": forward_bytes(b, h16, w16, c4, rois, d.pooled, 2)
            + backward_bytes(b, h16, w16, c4, rois, d.pooled, 2)}
