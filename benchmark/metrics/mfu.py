"""The whole step's share of the card's bf16 peak, %: the model FLOPs
of the traced window's requests over (the window's seconds x 989.4
TFLOP/s)."""
from ..work.peaks import BF16_FLOPS


def read(ctx):
    if not ctx.get("flops") or not ctx["busy_s"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * BF16_FLOPS)
