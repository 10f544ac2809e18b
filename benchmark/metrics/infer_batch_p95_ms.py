"""The nearest-rank 95th percentile of the traced window's calls, ms,
each timed on the host from hand-over to ``Detections`` on the host
(under the profiler). A per-layer metric of the entry: as an
end-to-end metric its spread from seed to seed (up to 7.2%) would ask
for a bound over the contract's 0.25."""
import math


def read(ctx):
    lat = sorted(ctx.get("latencies") or [])
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
