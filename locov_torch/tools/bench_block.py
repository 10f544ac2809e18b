"""The fused bottleneck-block kernel against cuDNN's chain of three
convolutions, at res2 training shapes ([4, 200, 336, 256] bfloat16,
M 64) by default. Twin of ``tools/bench_block.py``.

    python -m locov_torch.tools.bench_block [--n 4 --h 200 --w 336
        --c 256 --m 64] [--check-only] [--device cuda|cpu] [--seed 0]

Inputs are seeded random arrays (an explicit ``torch.Generator``), as
the JAX tool makes them: x ~ N(0, 1), weights ~ N(0, 1) x 0.05 in
bfloat16, biases ~ N(0, 1) x 0.1 in float32. Prints one JSON line: the
block's time and ``bottleneck_block_ref``'s (three ``F.conv2d`` calls,
not one call), their ratio and the block's largest error relative to
max |ref|; with ``--check-only`` the error alone. On the card the block
is the CUDA kernel, timed with CUDA events (median after warm-up); with
``--device cpu`` it is the plain version, timed on the host clock.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops.bottleneck_block import bottleneck_block, bottleneck_block_ref
from ..utils.device import resolve_device
from .timing import describe, time_ms


def make_inputs(gen, shape, m, dtype=torch.bfloat16):
    """(x, w1, b1, w2, b2, w3, b3) on ``gen``'s device, as the JAX tool
    makes them: x [N, H, W, C] ~ N(0, 1) and weights ~ N(0, 1) x 0.05 in
    ``dtype``, biases ~ N(0, 1) x 0.1 in float32."""
    c = shape[3]

    def normal(s, scale, dt):
        return (torch.randn(s, generator=gen, device=gen.device)
                * scale).to(dt)

    f32 = torch.float32
    return (normal(shape, 1.0, dtype), normal((c, m), 0.05, dtype),
            normal((m,), 0.1, f32), normal((3, 3, m, m), 0.05, dtype),
            normal((m,), 0.1, f32), normal((m, c), 0.05, dtype),
            normal((c,), 0.1, f32))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--h", type=int, default=200)
    ap.add_argument("--w", type=int, default=336)
    ap.add_argument("--c", type=int, default=256)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x, *wargs = make_inputs(gen, (args.n, args.h, args.w, args.c), args.m)
    with torch.no_grad():
        y = bottleneck_block(x, *wargs).float()
        y_ref = bottleneck_block_ref(x, *wargs).float()
        rel = float((y - y_ref).abs().max()
                    / y_ref.abs().max().clamp(min=1e-6))
        if args.check_only:
            line = {"metric": "block_parity_max_rel_err", "value": rel,
                    **describe(device)}
        else:
            t_block = time_ms(lambda: bottleneck_block(x, *wargs), device)
            t_ref = time_ms(lambda: bottleneck_block_ref(x, *wargs), device)
            line = {"metric": "bottleneck_block_fwd_ms",
                    "shape": [args.n, args.h, args.w, args.c, args.m],
                    "dtype": "bfloat16", **describe(device),
                    "block": "cuda_kernel" if device.type == "cuda"
                    else "plain",
                    "block_ms": t_block, "ref_ms": t_ref,
                    "speedup": t_ref / t_block, "max_rel_err": rel}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
