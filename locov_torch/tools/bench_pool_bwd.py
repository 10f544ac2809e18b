"""The stem's ReLU + max-pool backward kernel (K1-bwd,
``relu_maxpool_bwd_cuda``) under its launch plan and others, and against
another build of the kernel source, in one process on the card.

    python -m locov_torch.tools.bench_pool_bwd [--n 8 --h 400 --w 672
        --c 64] [--device cuda|cpu] [--rows 4,16] [--reference SRC]
        [--seed 0]

Inputs are made from ``--seed`` (an explicit ``torch.Generator``): x and
dy ~ N(0, 1) at the stem's shapes ([8, 400, 672, 64] -> dy [8, 200, 336,
64] by default), in float32 and bfloat16. Prints one JSON line with the
card's name and power limit and, for each dtype, the kernel's time, the
plain version's (autograd of the plain forward, masked) and the byte
bound (x, dy and dx moved once at 3.35 TB/s); whether the kernel's dx
(filled with NaN before the launch) has the plain version's bits; the
time under each plan of ``--rows`` (window rows a block) and whether it
gives the same bits as the default plan's. ``--reference`` builds
another source of ``csrc/relu_maxpool.cu`` whose C entry
``relu_maxpool_bwd`` takes ``(x, dy, dx, n, h, w, c, oh, ow, dtype, vec,
stream)`` (every version of the file does: ``git show
<commit>:locov_torch/csrc/relu_maxpool.cu``, beside ``common.cuh``) and
times it in turns with the kernel: reference, kernel, kernel, reference.
Times are medians of CUDA-event timings after warm-up. With ``--device
cpu`` only the plain version runs, timed on the host clock.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from ..ops import kernel_lib
from ..ops import relu_maxpool as pool
from ..utils.device import resolve_device
from .timing import describe, time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def load_reference(src):
    """``src`` built by nvcc beside this build, its backward entry
    bound."""
    lib = kernel_lib.load_source(src, "reference_relu_maxpool")

    def run(x, dy):
        n, h, w, c = x.shape
        dx = torch.empty_like(x)
        kernel_lib.launch("relu_maxpool_bwd", x.device, x.data_ptr(),
                          dy.data_ptr(), dx.data_ptr(), n, h, w, c,
                          dy.shape[1], dy.shape[2], pool._DTYPES[x.dtype],
                          pool._vec(x, dy, dx), lib=lib)
        return dx
    return run


def _same_bits(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def bench_dtype(x, dy, rows, reference, device) -> dict:
    nbytes = (2 * x.numel() + dy.numel()) * x.element_size()
    line = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    if device.type == "cpu":
        line["plain_ms"] = time_ms(
            lambda: pool.relu_maxpool_bwd_plain(x, dy), device, reps=3,
            warmup=1)
        return line
    want = pool._launch_bwd(x, dy, fill=math.nan)
    line["same_bits_as_plain"] = _same_bits(
        want, pool.relu_maxpool_bwd_plain(x, dy))
    line["kernel_ms"] = time_ms(lambda: pool.relu_maxpool_bwd_cuda(x, dy),
                                device)
    line["plain_ms"] = time_ms(lambda: pool.relu_maxpool_bwd_plain(x, dy),
                               device, reps=10)
    line["plans"] = {}
    for r in rows:
        got = pool._launch_bwd(x, dy, r, math.nan)
        line["plans"][str(r)] = {
            "ms": time_ms(lambda r=r: pool._launch_bwd(x, dy, r), device),
            "same_bits_as_planned": _same_bits(got, want)}
        del got
    if reference is not None:
        turns = [time_ms(lambda: reference(x, dy), device),
                 time_ms(lambda: pool.relu_maxpool_bwd_cuda(x, dy), device),
                 time_ms(lambda: pool.relu_maxpool_bwd_cuda(x, dy), device),
                 time_ms(lambda: reference(x, dy), device)]
        line["turns_ms"] = dict(zip(
            ("reference", "kernel", "kernel_again", "reference_again"),
            turns))
        line["reference_same_bits"] = _same_bits(reference(x, dy), want)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--h", type=int, default=400)
    ap.add_argument("--w", type=int, default=672)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--rows", default="4,16",
                    help="other plans: window rows a block, comma-separated")
    ap.add_argument("--reference", default=None,
                    help="another relu_maxpool.cu to time in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    oh, ow = (args.h + 1) // 2, (args.w + 1) // 2
    x = torch.randn((args.n, args.h, args.w, args.c), generator=gen,
                    device=device)
    dy = torch.randn((args.n, oh, ow, args.c), generator=gen, device=device)
    rows = [int(r) for r in args.rows.split(",") if r]
    reference = load_reference(args.reference) if args.reference else None
    line = {"metric": "relu_maxpool_bwd_ms",
            "shape": [args.n, args.h, args.w, args.c], **describe(device),
            "backward": "cuda_kernel" if device.type == "cuda" else "plain"}
    for dtype in (torch.float32, torch.bfloat16):
        line[str(dtype).split(".")[1]] = bench_dtype(
            x.to(dtype), dy.to(dtype), rows, reference, device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
