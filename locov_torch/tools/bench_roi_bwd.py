"""The ROIAlign feature-gradient kernel (``roi_align_bwd_cuda``) at the
training step's shapes, under its launch plan and others, and against
another build of the kernel source, in one process on the card.

    python -m locov_torch.tools.bench_roi_bwd [--plans 4x64,2x128,4x128]
        [--reference SRC] [--seed 0]

Inputs, made from ``--seed``: the cotangent g [8, 512, 14, 14, 1024] ~
N(0, 1) and 512 boxes an image of 800 x 1344 (492 with log-uniform
sides of 8 to 1344 / 800 px, 20 with sides of 32 to 400 px), features
[8, 50, 84, 1024] at stride 16, adaptive sampling, in float32 and
bfloat16. For each dtype it prints one JSON line: the kernel's time
under ``_bwd_plan``'s plan and under each plan of ``--plans`` (band
rows x channel tile), each with whether its output has the same bits as
the planned launch's (the plan only moves work between blocks, not the
order of any sum). ``--reference`` builds another source of
``csrc/roi_align.cu`` whose C entry takes ``(g, boxes, df, b, h, w, c,
n, pooled, ratio, scale, dtype, threads, stream)`` (the row-per-block
kernel of commit edd65b0 does, with ``git show
edd65b0:locov_torch/csrc/roi_align.cu``, beside ``common.cuh``) and
times it in turns with the kernel: reference, kernel, kernel,
reference. Times are medians of CUDA-event timings after warm-up.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math

import torch

from ..ops import kernel_lib
from ..ops import roi_align as roi
from ..utils.device import resolve_device
from .timing import describe, time_ms

SCALE, POOLED, H, W = 1 / 16, 14, 50, 84


def train_boxes(gen, b=8, n=512, n_gt=20, img_h=800, img_w=1344):
    """Boxes as ROIAlign sees them in a training step, on gen's device."""
    dev = gen.device
    u = torch.rand((b, n - n_gt, 4), generator=gen, device=dev)
    sw = torch.exp(u[..., 2] * math.log(img_w / 8.0)) * 8
    sh = torch.exp(u[..., 3] * math.log(img_h / 8.0)) * 8
    x0, y0 = u[..., 0] * (img_w - sw), u[..., 1] * (img_h - sh)
    props = torch.stack([x0, y0, x0 + sw, y0 + sh], -1)
    u = torch.rand((b, n_gt, 4), generator=gen, device=dev)
    side = 32 + u[..., 2:] * 368
    lo = u[..., :2] * (torch.tensor([img_w, img_h], device=dev) - side)
    gt = torch.cat([lo, lo + side], -1)
    return torch.cat([props, gt], 1).contiguous()


def run_plan(g, boxes, rows, tile):
    """The kernel's C entry under a given plan (band rows, channel
    tile)."""
    b, n = boxes.shape[:2]
    c = g.shape[-1]
    df = torch.empty((b, H, W, c), dtype=g.dtype, device=g.device)
    vec = 16 // g.element_size()
    kernel_lib.launch("roi_align_bwd", g.device, g.data_ptr(),
                      boxes.data_ptr(), df.data_ptr(), b, H, W, c, n, POOLED,
                      0, SCALE, roi._DTYPES[g.dtype], vec, rows, tile,
                      roi._bwd_smem(rows, W, tile, POOLED))
    return df


def load_reference(src):
    """``src`` built by nvcc beside this build, its C entry bound."""
    fn = kernel_lib.load_source(src, "reference_roi_align").roi_align_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(g, boxes):
        b, n = boxes.shape[:2]
        c = g.shape[-1]
        df = torch.empty((b, H, W, c), dtype=g.dtype, device=g.device)
        err = fn(g.data_ptr(), boxes.data_ptr(), df.data_ptr(), b, H, W, c,
                 n, POOLED, 0, SCALE, roi._DTYPES[g.dtype],
                 max(64, min(128, -(-c // 32) * 32)),
                 kernel_lib.stream_ptr(g.device))
        kernel_lib.check_launch(err, "reference roi_align_bwd")
        return df
    return run


def _same_bits(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plans", default="4x64,2x128,4x128",
                    help="band rows x channel tile, comma-separated")
    ap.add_argument("--reference", default=None,
                    help="another roi_align.cu to time in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    boxes = train_boxes(gen)
    reference = load_reference(args.reference) if args.reference else None
    plans = [tuple(int(v) for v in p.split("x"))
             for p in args.plans.split(",") if p]
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((8, 512, POOLED, POOLED, 1024), generator=gen,
                        device=device).to(dtype)
        plan = roi._bwd_plan(H, W, 1024, dtype)

        def kernel():
            return roi.roi_align_bwd_cuda(g, boxes, SCALE, H, W, POOLED, 0)
        want = kernel()
        line = {"metric": "roi_align_bwd_ms", "shape": list(g.shape),
                "dtype": str(dtype).split(".")[1], **describe(device),
                "plan": plan, "kernel_ms": time_ms(kernel, device),
                "plans": {}}
        for rows, tile in plans:
            got = run_plan(g, boxes, rows, tile)
            line["plans"][f"{rows}x{tile}"] = {
                "ms": time_ms(lambda: run_plan(g, boxes, rows, tile),
                              device),
                "same_bits_as_planned": _same_bits(got, want)}
        if reference is not None:
            turns = [time_ms(lambda: reference(g, boxes), device),
                     time_ms(kernel, device), time_ms(kernel, device),
                     time_ms(lambda: reference(g, boxes), device)]
            line["turns_ms"] = dict(zip(
                ("reference", "kernel", "kernel_again", "reference_again"),
                turns))
            ref = reference(g, boxes).float()
            line["reference_max_abs_diff"] = \
                (ref - want.float()).abs().max().item()
        print(json.dumps(line), flush=True)
        lines.append(line)
        del g
    return lines


if __name__ == "__main__":
    main()
