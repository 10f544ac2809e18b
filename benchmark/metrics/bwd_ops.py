"""Device operations a step (kernels, copies, sets) launched inside
autograd's engine (``spans.py``): the backward's launches, ROIAlign's
included."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    n = s["backward"]["ops"] if s else 0
    return n / ctx["requests"] if n else None
