"""Device ms a request in the ``backbone`` bucket of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("backbone", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
