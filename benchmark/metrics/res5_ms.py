"""Device ms a request in the ``res5`` bucket of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("res5", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
