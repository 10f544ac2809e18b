"""Device ms a step of the backward's ``mmss`` bucket (``spans.py``:
the kernels autograd launched for nodes that the forward's
``grid_mmss``, ``box_mmss``, ``fused_mmss`` and ``distill``
stages built)."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    t = s["backward"]["buckets"].get("mmss", 0.0) if s else 0.0
    return 1e3 * t / ctx["requests"] if t > 0 else None
