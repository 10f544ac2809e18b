"""What holds KQ2, the int8 ROIAlign kernel: copies of
``csrc/roi_align_int8.cu`` with one part changed or cut, other launch
plans, and the parent's form, built side by side and timed through the
C entry in one process, at the static int8 path's shapes: features [8,
50, 84, 1024] (bfloat16, quantized by their max-abs), 1,000 boxes an
image the size of RPN proposals, adaptive sampling, pooled 14.

    python -m locov_torch.tools.ablate_roi_int8 [--cuts a,b,...]
        [--plans 128x16,64x16,...] [--reference SRC] [--k2-reference SRC]
        [--seed 0]

A change is a text substitution in the source: ``imad`` (phase (b)'s
four-row products as four multiply-adds of sign-extended bytes, not one
``__dp4a``), ``four_columns`` and ``three_columns`` (phase (a) loads
four or three columns of each row at once, not two),
``one_builder_warp`` (the first warp builds both matrices, not one
each of the first two), ``unroll_bins`` and ``unroll_groups`` (the loop
over the bins p, or over the row groups of phase (a), unrolled by two),
``plain_stores`` (``st.global`` for the output, not ``st.global.cs``).
These compute KQ2, and each is checked against the plain version. A cut
computes nonsense; only its time is read: ``stores`` (the output
computed, stored under a condition never met), ``loads`` (phase (a)'s
16-byte feature loads replaced by values made from their addresses),
``phase_a`` (no tq computed: phase (b) reads what shared memory holds),
``phase_b`` (no bin summed, nothing stored; ``phase_a+phase_b``: the
boxes' build alone). Cuts joined by ``+`` are made together. A change
or cut whose text the source no longer holds is left out and listed
under ``not_applied``. A plan is threads x channels a thread
(``_int8_plan``'s members, the shared memory and blocks an SM
recounted). ``--reference`` is an earlier ``csrc/roi_align_int8.cu``
whose C entry took the matrices (``git show
657e8ff:locov_torch/csrc/roi_align_int8.cu``), timed with the plain
matrix build it needed. The base kernel is timed first
and last; the float K2 (``roi_align_cuda``) on the same boxes and the
bfloat16 features beside them. Prints one JSON line: ms per variant,
same bits per variant that computes KQ2, the ptxas lines of each build,
and the byte bound. ``--k2-reference`` (another ``csrc/roi_align.cu``,
the parent's: the float kernels before their tap code moved into
``roi_taps.cuh``) adds whether K2, K3-fwd and K3-bwd give its bits.
Medians of CUDA-event timings after warm-up.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import torch

from ..ops import int8_conv as iq
from ..ops import kernel_lib
from ..ops import roi_align as ra
from .bench_roi_fwd import proposal_boxes
from .timing import describe, time_ms

SRC = "roi_align_int8.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALE, POOLED = 1 / 16, 14
_STORE = ("store_stream<VEC>(obox + ((long long)pp * p + q) * c + "
          "v * VEC, o);")
_NEVER = "if (o.v[0] == 0x7f7f7f7f && o.v[VEC / 4 - 1] == 0x01020304) "
# name -> [(text, replacement)] in SRC
CHANGES = {
    "imad": [("  return __dp4a(a, b, acc);",
              "  for (int i = 0; i < 32; i += 8)\n"
              "    acc += ((a << (24 - i)) >> 24) *\n"
              "           ((b << (24 - i)) >> 24);\n"
              "  return acc;")],
    "four_columns": [("constexpr int XB = 2;", "constexpr int XB = 4;")],
    "three_columns": [("constexpr int XB = 2;", "constexpr int XB = 3;")],
    "one_builder_warp": [
        ("for (int axis = tid >> 5; axis < 2; axis += tc >> 5)",
         "for (int axis = 0; axis < 2 && tid < 32; ++axis)")],
    "unroll_bins": [("    for (int pp = 0; pp < p; ++pp) {",
                     "#pragma unroll 2\n    for (int pp = 0; pp < p; ++pp) {")],
    "unroll_groups": [("    for (int g = ya >> 2; g <= (yb >> 2) && "
                       "yb >= 0; ++g) {",
                       "#pragma unroll 2\n    for (int g = ya >> 2; "
                       "g <= (yb >> 2) && yb >= 0; ++g) {")],
    "plain_stores": [("    __stcs(reinterpret_cast<int4*>(p),",
                      "    __stwb(reinterpret_cast<int4*>(p),")],
}
CUTS = {
    "stores": [(_STORE, _NEVER + _STORE)],
    "loads": [("const int4 x = __ldg(reinterpret_cast<const int4*>(p));",
               "const int4 x = make_int4((int)(size_t)p, (int)((size_t)p >> "
               "4), 1, 2);")],
    "phase_a": [("    for (int g = ya >> 2; g <= (yb >> 2) && yb >= 0; "
                 "++g) {\n      bool valid[4];",
                 "    for (int g = ya >> 2; g < 0; ++g) {\n"
                 "      bool valid[4];")],
    "phase_b": [("    for (int pp = 0; pp < p; ++pp) {",
                 "    for (int pp = 0; pp < 0; ++pp) {")],
}


def variant_dir(name: str) -> str:
    return os.path.join(os.path.dirname(kernel_lib.BUILD_DIR),
                        "ablate_roi_int8", name)


def write_variant(name: str, subs):
    """A copy of csrc/ with ``subs`` applied to SRC; returns its path, or
    None where SRC does not hold the text of a substitution once."""
    with open(os.path.join(kernel_lib.CSRC, SRC)) as f:
        text = f.read()
    for old, new in subs:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    d = variant_dir(name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(kernel_lib.CSRC):
        shutil.copy(os.path.join(kernel_lib.CSRC, f), d)
    path = os.path.join(d, SRC)
    with open(path, "w") as f:
        f.write(text)
    return path


def build_all(sources) -> dict:
    """Build every source at once; returns name -> (library, ptxas)."""
    procs = {}
    for name, src in sources.items():
        so = os.path.join(variant_dir(name), "kq2.so")
        os.makedirs(variant_dir(name), exist_ok=True)
        procs[name] = (so, subprocess.Popen(
            [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "Used" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(os.path.abspath(so)), ptxas)
    return built


def plan_of(spec: str, h: int, w: int) -> dict:
    """``threads x vec`` as a launch plan (the blocks an SM its shared
    memory leaves)."""
    threads, vec = (int(v) for v in spec.split("x"))
    smem = ra._int8_smem(h, w, vec, threads)
    per_sm = 2 if smem <= ra._BWD_SMEM_TWO else 1
    return {"vec": vec, "threads": threads, "blocks_per_sm": per_sm,
            "smem_bytes": smem}


def runner(lib, args, plan):
    """One launch of ``lib``'s C entry (the op's signature) under
    ``plan``."""
    fq, boxes, ratio = args
    b, h, w, c = fq.shape
    n = boxes.shape[1]
    out = torch.empty((b, n, POOLED, POOLED, c), dtype=torch.int8,
                      device=fq.device)

    def run():
        kernel_lib.launch("roi_align_int8_fwd", fq.device, fq.data_ptr(),
                          boxes.data_ptr(), ratio.data_ptr(), out.data_ptr(),
                          b, h, w, c, n, POOLED, 0, SCALE, plan["vec"],
                          plan["threads"], plan["smem_bytes"], lib=lib)
        return out
    return run


def parent_runner(lib, args):
    """The parent's form (adaptive sampling, pooled 14, stride 16): its
    plain matrix build and its kernel, which took the matrices (C entry
    (fq, kyq, kxq, sx, rescale, out, b, h, w, c, n, p, stream)). Returns
    a function of no arguments giving the output."""
    fn = lib.roi_align_int8_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fq, boxes, ratio = args
    b, h, w, c = fq.shape
    n = boxes.shape[1]

    def run():
        ky, kx = ra._build_kernels(boxes, SCALE, h, w, POOLED, 0)
        kyq, sy = ra._quantize_rows(ky)
        kxq, sx = ra._quantize_rows(kx)
        rescale = ratio.reshape(()) * sy
        out = torch.empty((b, n, POOLED, POOLED, c), dtype=torch.int8,
                          device=fq.device)
        err = fn(fq.data_ptr(), kyq.data_ptr(), kxq.data_ptr(),
                 sx.data_ptr(), rescale.data_ptr(), out.data_ptr(), b, h, w,
                 c, n, POOLED, kernel_lib.stream_ptr(fq.device))
        kernel_lib.check_launch(err, "parent roi_align_int8")
        return out
    return run


def k2_same_bits(src: str, f, boxes, gen) -> dict:
    """K2 (bfloat16, adaptive), K3-fwd (float32, ratio 2) and K3-bwd
    (bfloat16, 512 boxes an image) through ``roi_align_cuda`` /
    ``roi_align_bwd_cuda`` built from ``src`` (another ``roi_align.cu``,
    its headers beside it) and from ``csrc/``: the same bits?"""
    new = kernel_lib.load("roi_align")
    ref = kernel_lib.load_source(src, "reference_roi_align")
    g = torch.randn((8, 512, POOLED, POOLED, f.shape[-1]), generator=gen,
                    device=f.device).to(torch.bfloat16)
    small, sb = f[:2].float().contiguous(), boxes[:2].contiguous()
    nb = boxes[:, :512].contiguous()
    outs = []
    for lib in (ref, new):
        kernel_lib._LIBS["roi_align"] = lib
        try:
            outs.append((ra.roi_align_cuda(f, boxes, SCALE, POOLED, 0),
                         ra.roi_align_cuda(small, sb, SCALE, POOLED, 2),
                         ra.roi_align_bwd_cuda(g, nb, SCALE, f.shape[1],
                                               f.shape[2], POOLED, 0)))
        finally:
            kernel_lib._LIBS["roi_align"] = new
    return {name: bool(torch.equal(a, b)) for name, a, b in
            zip(("k2_bfloat16", "k3_fwd_float32_ratio2", "k3_bwd_bfloat16"),
                *outs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cuts", default=",".join([*CHANGES, *CUTS]),
                    help="comma-separated changes or cuts, of: "
                    + ", ".join([*CHANGES, *CUTS]))
    ap.add_argument("--plans", default="64x16,128x8",
                    help="threads x channels a thread, comma-separated")
    ap.add_argument("--reference", default=None,
                    help="the parent's roi_align_int8.cu, timed with its "
                         "plain matrix build")
    ap.add_argument("--k2-reference", default=None,
                    help="another roi_align.cu (the parent's), whose K2 / "
                         "K3 outputs are held to csrc's bit for bit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_roi_int8: needs a CUDA device")
    device = torch.device("cuda")
    names = [c for c in args.cuts.split(",") if c]
    sources, not_applied = {"base": write_variant("base", [])}, []
    for name in names:
        src = write_variant(name, [sub for part in name.split("+")
                                   for sub in {**CHANGES, **CUTS}[part]])
        if src is None:
            not_applied.append(name)
        else:
            sources[name] = src
    if args.reference:
        sources["parent"] = os.path.abspath(args.reference)
    built = build_all(sources)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    f = torch.randn((8, 50, 84, 1024), generator=gen,
                    device=device).to(torch.bfloat16)
    boxes = proposal_boxes(gen, 8, 1000, 800, 1344)
    amax = f.float().abs().amax()
    fq, kyq, kxq, sx, rescale, s_pool = ra.int8_operands(
        f, boxes, SCALE, amax, amax * 0.6, POOLED, 0)
    ratio = (iq._scale_of(amax) / s_pool).reshape(1)
    want = ra.roi_align_int8_plain(fq, kyq, kxq, sx, rescale, chunk=25)
    del kyq, kxq, sx, rescale
    inputs = (fq, boxes, ratio)
    _, h, w, c = fq.shape
    base_plan = ra._int8_plan(h, w, c, POOLED, ra._align(fq))
    runs = {name: runner(lib, inputs, base_plan)
            for name, (lib, _) in built.items()
            if name != "parent"}
    for spec in [p for p in args.plans.split(",") if p]:
        runs["plan_" + spec] = runner(built["base"][0], inputs,
                                      plan_of(spec, h, w))
    if "parent" in built:
        runs["parent"] = parent_runner(built["parent"][0], inputs)
    same = {name: bool(torch.equal(run(), want)) for name, run in
            runs.items() if not set(name.split("+")) & set(CUTS)}
    ms = {"base": time_ms(runs["base"], device, reps=20)}
    for name, run in runs.items():
        if name != "base":
            ms[name] = time_ms(run, device, reps=20)
    ms["base_again"] = time_ms(runs["base"], device, reps=20)
    ms["k2_bfloat16"] = time_ms(
        lambda: ra.roi_align_cuda(f, boxes, SCALE, POOLED, 0), device,
        reps=20)
    nbytes = fq.numel() + boxes.numel() * 4 + 4 + want.numel()
    line = {"metric": "roi_align_int8_ablation_ms",
            "features": list(fq.shape), "boxes": list(boxes.shape),
            "plan": base_plan, **describe(device), "ms": ms,
            "same_bits": same, "not_applied": not_applied,
            "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "ptxas": {name: p for name, (_, p) in built.items()}}
    if args.k2_reference:
        del want, runs
        line["k2_same_bits_as_reference"] = k2_same_bits(
            os.path.abspath(args.k2_reference), f, boxes, gen)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
