"""Device ms a request in the ``window_attn`` bucket (the
``window_attention`` stage ranges of the windowed blocks: their bias
terms and KA2) of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("window_attn", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
