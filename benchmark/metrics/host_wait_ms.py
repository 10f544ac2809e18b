"""Host ms a request inside the program's ``wait.*`` spans (the union
of them, ``spans.py:wait_spans``): where the host blocks on the card.
On the host's clock, which the profiler stretches."""
from .. import spans


def read(ctx):
    s = spans.of(ctx)
    w = s["waits"].get("all") if s else None
    return 1e3 * w["s"] / ctx["requests"] if w and w["count"] else None
