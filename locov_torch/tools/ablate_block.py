"""What holds the fused bottleneck-block kernel: copies of
``csrc/bottleneck_block.cu`` with one part cut, built side by side and
timed through their C entry in one process, at res2 ([4, 200, 336,
256] bfloat16, M 64) by default.

    python -m locov_torch.tools.ablate_block [--n 4 --h 200 --w 336
        --c 256 --m 64] [--dtype bfloat16|float32] [--cuts a,b,...]
        [--reference SRC] [--seed 0]

A cut is a set of text substitutions in the source (or a header beside
it): ``loads`` (the cp.async copies of the ring; the products run on
whatever the stages hold), the bytes of the halo or residual pieces
(``loads_x``, ``loads_res``: zero-filling copies), the W1 and W3 copies
(``loads_w``), ``conv1``, ``conv2``, ``conv3`` (that product's fragment
loads and mma), ``stores`` (the output's stores), ``stores_fake`` (the
stores kept under a condition never met), ``barrier`` (the barrier of a
ring step). Two are not cuts: ``mma_not_volatile`` leaves the mma asm
for the compiler to schedule, ``l2_256`` has each cp.async ask L2 for
256 bytes around it. A cut kernel computes nonsense; only its time is
read. Cuts joined by ``+`` are made together. A layout (``LAYOUTS``)
sets ``Bf16Layout``'s ring stages and blocks an SM at M 64; it computes
the block. The copies build in parallel (one ``nvcc`` each, the
kernels' flags, under ``build/ablate/``); each is timed with CUDA
events (median after warm-up), the uncut copy first and last.
``--reference`` builds another source of the kernel (the same C entry)
beside them and times it the same way, as ``reference``. Prints one
JSON line: ms per cut, and the ptxas lines of each build. On a card
where no kernel profiler runs, this is how to see what holds the
kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from ..ops import kernel_lib
from ..ops.bottleneck_block import _DTYPES
from .bench_block import make_inputs
from .timing import describe, time_ms

SRC = "bottleneck_block.cu"
# cut -> [(file, text, replacement)]
CUTS = {
    "loads": [(SRC, "    if (tile < g.tiles) {\n      if (k < kc) {",
               "    if (false) {\n      if (k < kc) {")],
    "loads_x": [(SRC, "in ? xb + xo[j] + c0 : x, in);", "x, false);")],
    "loads_res": [(SRC, "in ? rb + ro[j] + c0 : x, in);", "x, false);")],
    "loads_w": [(SRC, "copy_rows<NB, M>(st + NHP * LDX, LDM, w1 + (long long)"
                 "c0 * M, M,\n                         tid);", ""),
                (SRC, "copy_rows<M, NB>(st, LDX, w3 + c0, g.c, tid);", "")],
    "conv1": [(SRC, "for (int k0 = 0; k0 < NB; k0 += 16) {",
               "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    "conv2": [(SRC, "for (int k0 = 0; k0 < M; k0 += 16) {",
               "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    "conv3": [(SRC, "for (int kk = 0; kk < M / 16; ++kk) {\n#pragma unroll\n"
               "        for (int j = 0; j < NT3 / 2; ++j) {",
               "for (int kk = 0; kk < 0; ++kk) {\n#pragma unroll\n"
               "        for (int j = 0; j < NT3 / 2; ++j) {")],
    "stores": [(SRC, "        if (gy < g.h && gx < g.w)\n          __stcs(",
                "        if (false)\n          __stcs(")],
    # the epilogue computed but nothing stored
    "stores_fake": [(SRC, "        if (gy < g.h && gx < g.w)\n          __stcs(",
                     "        if (gy < 0 && val.x == 0x7fc1)\n          __stcs(")],
    "barrier": [(SRC, "    __syncthreads();\n    feed.fill(",
                 "    feed.fill(")],
    # not cuts: each copy bringing 256 bytes into L2; the mma free to be
    # scheduled by the compiler
    "l2_256": [(SRC, "cp.async.cg.shared.global [%0]",
                "cp.async.cg.shared.global.L2::256B [%0]")],
    "mma_not_volatile": [("mma_bf16.cuh", "asm volatile(\n      \"mma.sync",
                          "asm(\n      \"mma.sync")],
}
# other layouts at M 64 (Bf16Layout's members: ring stages, blocks an
# SM)
LAYOUTS = {
    "1blk_2st": (2, 1),
    "1blk_3st": (3, 1),
    "1blk_4st": (4, 1),
}
LAYOUT_KEYS = ("STAGES", "MINB")


def layout_subs(values):
    """Substitutions that set Bf16Layout's members at M 64."""
    subs = []
    for key, v in zip(LAYOUT_KEYS, values):
        pre = "static constexpr int %s = M == 64 ? " % key
        subs.append((SRC, re.compile(re.escape(pre) + r"\d+ :"),
                     "%s%d :" % (pre, v)))
    return subs


def variant_subs(name):
    """The substitutions of a cut, a layout, or cuts joined by "+"."""
    subs = []
    for part in name.split("+"):
        subs += CUTS[part] if part in CUTS else layout_subs(LAYOUTS[part])
    return subs


def variant_dir(name: str) -> str:
    return os.path.join(os.path.dirname(kernel_lib.BUILD_DIR), "ablate", name)


def write_variant(name: str, subs) -> str:
    """A copy of csrc/ with ``subs`` applied; returns its source path."""
    d = variant_dir(name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(kernel_lib.CSRC):
        shutil.copy(os.path.join(kernel_lib.CSRC, f), d)
    for fname, old, new in subs:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if isinstance(old, str):
            old = re.compile(re.escape(old))
        text, count = old.subn(new.replace("\\", "\\\\"), text)
        if count != 1:
            raise ValueError(f"{name}: {old.pattern!r} is not once in "
                             f"{fname}")
        with open(path, "w") as f:
            f.write(text)
    return os.path.join(d, SRC)


def build_all(variants) -> dict:
    """Build every variant at once; returns name -> (library, ptxas)."""
    procs = {}
    for name, src in variants.items():
        so = os.path.join(variant_dir(name), "block.so")
        procs[name] = (so, subprocess.Popen(
            [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for cut {name}:\n{out}")
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "Used" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(os.path.abspath(so)), ptxas)
    return built


def runner(lib, args):
    x, w1, b1, w2, b2, w3, b3 = args
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, w3, b3, out)]

    def run():
        kernel_lib.launch("bottleneck_block_fwd", x.device, *ptrs, n, h, w,
                          c, w1.shape[1], _DTYPES[x.dtype], lib=lib)
    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--h", type=int, default=200)
    ap.add_argument("--w", type=int, default=336)
    ap.add_argument("--c", type=int, default=256)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--cuts", default=",".join(CUTS),
                    help="comma-separated cuts (a+b: both) or layouts, of: "
                    + ", ".join([*CUTS, *LAYOUTS]))
    ap.add_argument("--reference", default=None,
                    help="another bottleneck_block.cu (its headers beside "
                         "it) timed with the cuts, as `reference`")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("ablate_block: needs a CUDA device")
    cuts = [c for c in args.cuts.split(",") if c]
    variants = {"base": write_variant("base", [])}
    for cut in cuts:
        variants[cut] = write_variant(cut, variant_subs(cut))
    if args.reference:
        os.makedirs(variant_dir("reference"), exist_ok=True)
        variants["reference"] = os.path.abspath(args.reference)
        cuts.append("reference")
    built = build_all(variants)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    inputs = make_inputs(gen, (args.n, args.h, args.w, args.c), args.m,
                         getattr(torch, args.dtype))
    runs = {name: runner(lib, inputs) for name, (lib, _) in built.items()}
    ms = {"base": time_ms(runs["base"], device)}
    for cut in cuts:
        ms[cut] = time_ms(runs[cut], device)
    ms["base_again"] = time_ms(runs["base"], device)
    line = {"metric": "bottleneck_block_ablation_ms",
            "shape": [args.n, args.h, args.w, args.c, args.m],
            "dtype": args.dtype, **describe(device), "ms": ms,
            "ptxas": {name: p for name, (_, p) in built.items()}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
