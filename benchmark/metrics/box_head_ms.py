"""Device ms a request in the ``box_head`` bucket (the 4conv1fc head on
every proposal) of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("box_head", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
