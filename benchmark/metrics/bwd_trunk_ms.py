"""Device ms a step of the backward's ``trunk`` bucket (``spans.py``:
the kernels autograd launched for nodes that the forward's
``backbone`` stage built)."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    t = s["backward"]["buckets"].get("trunk", 0.0) if s else 0.0
    return 1e3 * t / ctx["requests"] if t > 0 else None
