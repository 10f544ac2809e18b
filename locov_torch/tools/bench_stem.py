"""The stem-conv kernel (7x7/s2/p3 over 3 channels, + the BN shift)
against one cuDNN call, ``F.conv2d(x, w, bias=shift, stride=2,
padding=3)`` in bfloat16, at LSM training shapes ([4, 800, 1344, 3]
bfloat16 -> [4, 400, 672, 64]) by default. Twin of
``tools/bench_stem.py``.

    python -m locov_torch.tools.bench_stem [--n 4 --h 800 --w 1344
        --f 64] [--device cuda|cpu] [--reference SRC] [--seed 0]

Inputs are seeded random arrays (an explicit ``torch.Generator``), as
the JAX tool makes them: x ~ N(0, 1) in bfloat16, w ~ N(0, 1) x 0.1 and
shift ~ N(0, 1) in float32. Prints one JSON line with two comparisons:
the forward, and forward + backward (gradients in x and w) of the loss
sum(out ** 2) in float32; and the stem's largest forward error relative
to max |library|. On the card the stem is the CUDA kernel, timed with
CUDA events (median after warm-up); with ``--device cpu`` it is the
plain version, timed on the host clock. ``--reference`` builds another
source of ``csrc/stem_conv_bn.cu`` whose C entry ``stem_conv_bn_fwd``
takes ``(x, w, shift, out, n, h, w, f, dtype, stream)`` with w in HWIO
order, bfloat16 (the kernel of commit f1b7fdf does: ``git show
f1b7fdf:locov_torch/csrc/stem_conv_bn.cu``, beside ``common.cuh`` and
``mma_bf16.cuh``), and times its forward in turns with the kernel's,
for bfloat16 and float32 x: reference, kernel, kernel, reference; with
the largest difference of the two outputs.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import kernel_lib
from ..ops.conv import conv2d
from ..ops.stem_conv_bn import _DTYPES, stem_conv_bn, stem_conv_bn_cuda
from ..utils.device import resolve_device
from .timing import describe, time_ms


def library(x, w, shift):
    """One cuDNN call in x's dtype: conv + bias, NHWC in and out."""
    y = conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
               shift.to(x.dtype), stride=2, padding=3)
    return y.permute(0, 2, 3, 1)


def load_reference(src):
    """``src`` built by nvcc beside this build, its C entry bound."""
    lib = kernel_lib.load_source(src, "reference_stem_conv_bn")

    def run(x, wb, sh):
        n, h, wd, _ = x.shape
        f = wb.shape[-1]
        out = torch.empty((n, h // 2, wd // 2, f), dtype=torch.bfloat16,
                          device=x.device)
        kernel_lib.launch("stem_conv_bn_fwd", x.device, x.data_ptr(),
                          wb.data_ptr(), sh.data_ptr(), out.data_ptr(), n, h,
                          wd, f, _DTYPES[x.dtype], lib=lib)
        return out
    return run


def turns(reference, x, w, shift, device) -> dict:
    """The reference's and the kernel's forward in turns; each takes its
    weights prepared once (the kernel's wrapper keeps its repack)."""
    wb, sh = w.to(torch.bfloat16).contiguous(), shift.float().contiguous()

    def kernel():
        return stem_conv_bn_cuda(x, w, shift)

    def ref():
        return reference(x, wb, sh)
    times = [time_ms(ref, device), time_ms(kernel, device),
             time_ms(kernel, device), time_ms(ref, device)]
    line = dict(zip(("reference", "kernel", "kernel_again",
                     "reference_again"), times))
    line["max_abs_diff"] = (ref().float() - kernel().float()).abs().max().item()
    return line


def _fwd_bwd(fn, x, w, shift):
    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)

    def run():
        loss = (fn(xr, wr, shift).float() ** 2).sum()
        return torch.autograd.grad(loss, (xr, wr))
    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--h", type=int, default=800)
    ap.add_argument("--w", type=int, default=1344)
    ap.add_argument("--f", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--reference", default=None,
                    help="another stem_conv_bn.cu to time in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn((args.n, args.h, args.w, 3), generator=gen,
                    device=device).to(torch.bfloat16)
    w = torch.randn((7, 7, 3, args.f), generator=gen, device=device) * 0.1
    shift = torch.randn((args.f,), generator=gen, device=device)

    with torch.no_grad():
        a = library(x, w, shift).float()
        b = stem_conv_bn(x, w, shift).float()
        rel = float((a - b).abs().max() / a.abs().max().clamp(min=1e-9))
        fwd = {"stem_ms": time_ms(lambda: stem_conv_bn(x, w, shift), device),
               "library_ms": time_ms(lambda: library(x, w, shift), device)}
    both = {"stem_ms": time_ms(_fwd_bwd(stem_conv_bn, x, w, shift), device),
            "library_ms": time_ms(_fwd_bwd(library, x, w, shift), device)}
    for d in (fwd, both):
        d["speedup"] = d["library_ms"] / d["stem_ms"]
    line = {"metric": "stem_conv_bn_ms",
            "shape": [args.n, args.h, args.w, 3, args.f],
            "dtype": "bfloat16", **describe(device),
            "stem": "cuda_kernel" if device.type == "cuda" else "plain",
            "fwd": fwd, "fwd_bwd": both, "max_rel_err": rel}
    if args.reference:
        reference = load_reference(args.reference)
        line["turns_ms"] = {str(dt).split(".")[1]: turns(
            reference, x.to(dt), w, shift, device)
            for dt in (torch.bfloat16, torch.float32)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
