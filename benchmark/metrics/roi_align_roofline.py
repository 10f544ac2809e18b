"""ROIAlign's share of its roofline, %: the least time its bytes take
at 3.35 TB/s over the device time of the kernels that the trace puts
under ROIAlign (its kernel's name or its launching operator's), so that
the share still reads when the kernel is replaced."""
from ..work.peaks import HBM_BYTES


def read(ctx):
    t = ctx["buckets"].get("roi_align", {}).get("device_s", 0.0)
    if t <= 0 or not ctx.get("roi_bytes"):
        return None
    return 100.0 * ctx["roi_bytes"] / HBM_BYTES / t
