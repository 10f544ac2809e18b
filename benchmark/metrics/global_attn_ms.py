"""Device ms a request in the ``global_attn`` bucket (the
``global_attention`` stage ranges of the global blocks: their bias terms
and KA2) of the trace join."""


def read(ctx):
    s = ctx["buckets"].get("global_attn", {}).get("device_s", 0.0)
    return 1e3 * s / ctx["requests"] if s > 0 else None
