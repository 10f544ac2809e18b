"""The NMS's host reads of the card a request: the ``wait.nms_converge``
and ``wait.nms_tile`` spans (``locov_torch/ops/nms.py``) inside the
traced requests (``spans.py:wait_spans``)."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    waits = s["waits"] if s else {}
    n = sum(v["count"] for k, v in waits.items() if k.startswith("nms_"))
    return n / ctx["requests"] if n else None
