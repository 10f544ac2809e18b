"""The bytes of ROIAlign, the operation, whatever kernel computes it:
each byte of its inputs read once and of its outputs written once."""


def forward_bytes(b: int, h: int, w: int, c: int, rois: int, pooled: int,
                  elt: int) -> float:
    """Features [b, h, w, c] read, pooled maps [b, rois, P, P, c]
    written, boxes [b, rois, 4] float32 read."""
    return elt * (b * h * w * c + b * rois * pooled * pooled * c) + \
        16.0 * b * rois


def backward_bytes(b: int, h: int, w: int, c: int, rois: int,
                   pooled: int, elt: int) -> float:
    """The pooled maps' gradient read, the features' gradient written,
    the boxes read."""
    return forward_bytes(b, h, w, c, rois, pooled, elt)
