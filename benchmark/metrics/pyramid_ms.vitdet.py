"""Device ms a request in the ``pyramid`` bucket (the simple feature
pyramid) of the trace join: the reader of ``pyramid_ms.vitdet`` by its
full name, beside the toy pyramid's own ``pyramid_ms`` of
``tests/test_bench_extend.py``."""


def read(ctx):
    s = ctx["buckets"].get("pyramid", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
