"""Device ms a request in the ``mmss_heads`` bucket of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("mmss_heads", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
