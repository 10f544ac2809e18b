"""Device ms a step of the backward and the optimizer: the
``backward (unattributed)`` bucket (the kernels autograd launches from
its own thread) and the ``optimizer`` bucket."""


def read(ctx):
    b = ctx["buckets"]
    s = sum(b.get(k, {}).get("device_s", 0.0)
            for k in ("backward (unattributed)", "optimizer"))
    return 1e3 * s / ctx["requests"] if s > 0 else None
