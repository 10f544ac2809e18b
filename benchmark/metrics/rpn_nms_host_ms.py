"""Host ms a request in the ``rpn+nms`` stage ranges (``rpn_head``,
``rpn_losses``, ``select_proposals``, ``fast_rcnn_inference``),
exclusive of the ranges nested in them: where the NMS waits on the
host."""


def read(ctx):
    s = ctx["buckets"].get("rpn+nms", {}).get("host_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
