"""Device ms a step of the backward's ``res5`` bucket (``spans.py``:
the kernels autograd launched for nodes that the forward's
``roi_features`` and ``grid_features`` stages built; ROIAlign's
rows stay out, under ``roi_align_roofline``)."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    t = s["backward"]["buckets"].get("res5", 0.0) if s else 0.0
    return 1e3 * t / ctx["requests"] if t > 0 else None
