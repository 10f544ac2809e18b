"""The ROIAlign forward kernel (``roi_align_cuda``: K2 at the inference
shapes, K3-fwd at the training shapes) under its launch plan and others,
and against another build of the kernel source, in one process on the
card. Twin of ``bench_roi_bwd``.

    python -m locov_torch.tools.bench_roi_fwd [--plans 1024x32x2,1024x16x2]
        [--reference SRC] [--seed 0]

Inputs, made from ``--seed``: features [8, 50, 84, 1024] ~ N(0, 1) at
stride 16 of 800 x 1344 images; ``inference``: 1000 boxes an image the
size of RPN proposals (``proposal_boxes``: log-uniform sides of 8 to
1344 / 800 px); ``train``: 512 boxes an image as a training step samples
them (``bench_roi_bwd.train_boxes``); adaptive sampling, pooled 14, in
float32 and bfloat16. For each dtype it prints one JSON line with the
card's name and power limit and, for each shape, the kernel's time under
``_fwd_plan``'s plan and under each plan of ``--plans`` (channel tile x
bytes a thread loads at once x output rows a block), each with whether
its output (filled with NaN before the launch) has the same bits as the
planned launch's (a plan only moves work between blocks and threads,
not the order of any sum), and the byte bound (features, boxes and
output moved once at 3.35 TB/s). ``--reference`` builds another source of
``csrc/roi_align.cu`` whose C entry ``roi_align_fwd`` takes ``(feat,
boxes, out, b, h, w, c, n, pooled, ratio, scale, dtype, vec, stream)``
(the gather kernel of commit b455d78 does, with ``git show
b455d78:locov_torch/csrc/roi_align.cu``, beside ``common.cuh``) and times
it in turns with the kernel: reference, kernel, kernel, reference. Times
are medians of CUDA-event timings after warm-up.
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
from .bench_roi_bwd import train_boxes
from .timing import describe, time_ms

SCALE, POOLED, H, W, C = 1 / 16, 14, 50, 84, 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def proposal_boxes(gen, b, n, img_h=800, img_w=1344):
    """Boxes the size of RPN proposals, on gen's device: log-uniform
    sides of 8 px to the image's."""
    u = torch.rand((b, n, 4), generator=gen, device=gen.device)
    side_w = torch.exp(u[..., 2] * math.log(img_w / 8.0)) * 8
    side_h = torch.exp(u[..., 3] * math.log(img_h / 8.0)) * 8
    x0 = u[..., 0] * (img_w - side_w)
    y0 = u[..., 1] * (img_h - side_h)
    return torch.stack([x0, y0, x0 + side_w, y0 + side_h], -1).contiguous()


def load_reference(src):
    """``src`` built by nvcc beside this build, its C entry bound."""
    fn = kernel_lib.load_source(src, "reference_roi_align_fwd").roi_align_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(f, boxes):
        b, h, w, c = f.shape
        n = boxes.shape[1]
        out = torch.empty((b, n, POOLED, POOLED, c), dtype=f.dtype,
                          device=f.device)
        err = fn(f.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, h, w, c,
                 n, POOLED, 0, SCALE, roi._DTYPES[f.dtype],
                 roi._vec(c, f.dtype), kernel_lib.stream_ptr(f.device))
        kernel_lib.check_launch(err, "reference roi_align_fwd")
        return out
    return run


def _same_bits(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def bench_shape(f, boxes, plans, reference, device) -> dict:
    """One shape: the kernel under its plan, under ``plans`` and, with
    ``reference``, in turns with it."""
    def kernel():
        return roi.roi_align_cuda(f, boxes, SCALE, POOLED, 0)
    want = kernel()
    nbytes = f.numel() * f.element_size() + boxes.numel() * 4 + \
        want.numel() * want.element_size()
    line = {"boxes": list(boxes.shape),
            "plan": roi._fwd_plan(H, W, C, f.dtype, POOLED),
            "kernel_ms": time_ms(kernel, device),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "plans": {}}
    for tile, nbytes, rows in plans:
        vec = roi._vec(C, f.dtype, True, nbytes)
        plan = roi._fwd_launch_plan(H, W, tile, vec, POOLED, rows)

        def run(plan=plan):
            return roi._launch_fwd(f, boxes, SCALE, POOLED, 0, plan)
        got = roi._launch_fwd(f, boxes, SCALE, POOLED, 0, plan, math.nan)
        line["plans"][f"{tile}x{nbytes}x{rows}"] = {
            "ms": time_ms(run, device),
            "same_bits_as_planned": _same_bits(got, want),
            "threads": plan["threads"]}
    if reference is not None:
        turns = [time_ms(lambda: reference(f, boxes), device),
                 time_ms(kernel, device), time_ms(kernel, device),
                 time_ms(lambda: reference(f, boxes), device)]
        line["turns_ms"] = dict(zip(
            ("reference", "kernel", "kernel_again", "reference_again"),
            turns))
        line["reference_max_abs_diff"] = \
            (reference(f, boxes).float() - want.float()).abs().max().item()
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plans",
                    default="1024x32x1,1024x32x4,512x32x2,1024x16x2",
                    help="channel tile x bytes a thread loads at once x "
                         "output rows a block, comma-separated")
    ap.add_argument("--reference", default=None,
                    help="another roi_align.cu to time in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shapes = {"inference": proposal_boxes(gen, 8, 1000),
              "train": train_boxes(gen)}
    feats = torch.randn((8, H, W, C), generator=gen, device=device)
    reference = load_reference(args.reference) if args.reference else None
    plans = [tuple(int(v) for v in p.split("x"))
             for p in args.plans.split(",") if p]
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(dtype)
        line = {"metric": "roi_align_fwd_ms", "features": list(f.shape),
                "dtype": str(dtype).split(".")[1], **describe(device)}
        for name, boxes in shapes.items():
            line[name] = bench_shape(f, boxes, plans, reference, device)
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
        del f
    return lines


if __name__ == "__main__":
    main()
