"""KA2's share of its roofline, %: the least time the attention's work
takes (its products at 989.4 TFLOP/s or its bytes at 3.35 TB/s,
``work/vitdet_infer.py:attention_work``) over the device time of the
``window_attn`` and ``global_attn`` buckets (the bias terms and KA2).

The harness hands a reader the window's model FLOPs and ROIAlign bytes
only, so the attention's work is worked out here from the one cell that
runs a ViT, ``CELL``: its configuration and batch, times the requests
traced. A window whose model FLOPs are not ``CELL``'s reads nothing, so
that another cell is never given ``CELL``'s work."""
import math

from .. import build
from ..work.peaks import BF16_FLOPS, HBM_BYTES
from ..work.vitdet_infer import attention_work, request_work

CELL = "vitdet_b_infer_b8"
BUCKETS = ("window_attn", "global_attn")


def read(ctx):
    t = sum(ctx["buckets"].get(k, {}).get("device_s", 0.0) for k in BUCKETS)
    if t <= 0:
        return None
    cell = build.load_cell(CELL)
    cfg = build.reference_cfg(cell["config"])
    traffic = cell["traffic"]
    b = traffic["batch"]
    canvas = next(iter(traffic["buckets"].values()))["padded"]
    flops = request_work(cfg, traffic["class_emb"]["rows"], b,
                         canvas)["flops"]
    if not math.isclose(ctx["flops"], flops * ctx["requests"],
                        rel_tol=1e-9):
        return None
    work = attention_work(cfg, b)
    least = max(work["attn_flops"] / BF16_FLOPS,
                work["attn_bytes"] / HBM_BYTES) * ctx["requests"]
    return 100.0 * least / t
