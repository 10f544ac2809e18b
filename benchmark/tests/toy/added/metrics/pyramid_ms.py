"""Host ms a request in the ``pyramid`` bucket's stage ranges
(``stages/toy.json``), exclusive of the ranges nested in them: what a
run on the CPU, which has no device rows, can read of a new stage."""


def read(ctx):
    s = ctx["buckets"].get("pyramid", {}).get("host_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
