"""Per-layer metrics, one small reader a quantity: ``<name>.py`` (or,
for ``<quantity>.<suffix>``, ``<quantity>.py``) with ``read(ctx)``,
which returns the metric's value from the traced window or ``None``
where it finds nothing to read (the harness then leaves the metric out).

``ctx`` (``run.py:trace_context``): ``buckets`` ({bucket: {"device_s",
"host_s"}} of ``trace.py``), ``requests`` (steps or calls traced),
``window_s``, ``busy_s``, ``flops`` (model FLOPs of the traced requests,
``work/flops.py``), ``roi_bytes`` (ROIAlign's bytes, ``work/roi_align.py``).
"""
