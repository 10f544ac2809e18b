#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--batches N] [--seed S]

Phases, one JSON line each, in order:

1. env: torch and CUDA versions, the card's name and power limit; the
   hand-written CUDA kernels are built from ``locov_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
2. kernel checks: each kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, at the shapes of the main path (K1
   x [8, 400, 672, 64]; K2 features [8, 50, 84, 1024] with 1000 boxes an
   image, adaptive sampling), plus tie-heavy (K1: also with NaNs and
   negative zeros) and edge-box cases. K1 must be bit-exact, with NaN
   where the plain version has NaN. K2 in float32 must be within 1e-5 * max|F|; in
   bfloat16 within one bfloat16 ulp of the plain version (computed in
   float32 and cast once), or 1e-5 * max|F| where that is larger (the
   float32 sum-order error, which exceeds a bfloat16 ulp of outputs
   close to 0). Kernel, plain and library-call times are medians of 30
   CUDA-event timings after warm-up.
3. small reference: a tiny float32 OvrRCNN (TF32 off) on the card,
   through the kernels, against the same model on the CPU, through the
   plain versions, which the CPU tests hold against the JAX package.
4. main path: STT inference, ``build_meta_arch`` on ``cuda`` from
   configs/coco_stt.yaml in bfloat16 at full width, seeded random
   weights, 8 images of 800 x 1344 (valid 800 x 1312, original 640 x
   640) and a [66, 768] class-embedding matrix, as bench.py builds the
   workload. Launch counts are zeroed just before the timed batches and
   read just after; each kernel must have launched.
5. one batch under torch.profiler: device busy time and idle share, and
   for each stage of the model's inference (its ``OvrRCNN.<stage>``
   ranges) the host time and the device time of its kernels.
6. the ``kernels`` line, the card's ``nvidia-smi`` name and power limit,
   and the result line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the
result line. It does the same when no CUDA device is present, and when
the ``locov_torch`` package is not beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
KERNEL_SOURCES = {
    "relu_maxpool": ("locov_torch/csrc/relu_maxpool.cu",
                     "locov_tpu/ops/pallas_pool.py:165"),
    "roi_align_fused": ("locov_torch/csrc/roi_align.cu",
                        "locov_tpu/ops/pallas_roi_align.py:162"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ K1
def _same_bits(got, want) -> bool:
    """Equal bit for bit, with NaN in the same places (NaN payloads
    aside)."""
    import torch
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(got.view(ints[got.dtype])[~nan],
                       want.view(ints[want.dtype])[~nan])


def check_relu_maxpool(gen, results):
    import torch
    from locov_torch.ops.relu_maxpool import (relu_maxpool_cuda,
                                              relu_maxpool_plain)
    f = torch.nn.functional
    main = (8, 400, 672, 64)
    cases = [("main", main, "randn"), ("ties", (2, 64, 96, 64), "ties"),
             ("odd", (3, 33, 47, 24), "ties")]
    for dtype in (torch.float32, torch.bfloat16):
        for case, shape, kind in cases:
            if kind == "randn":
                x = torch.randn(shape, generator=gen, device="cuda")
            else:
                x = torch.randint(-2, 3, shape, generator=gen,
                                  device="cuda").float()
                if case == "ties":  # NaNs and negative zeros among ties
                    u = torch.rand(shape, generator=gen, device="cuda")
                    x[u < 0.02] = float("nan")
                    x[(u >= 0.02) & (u < 0.12)] = -0.0
            x = x.to(dtype)
            got = relu_maxpool_cuda(x)
            want = relu_maxpool_plain(x)
            torch.cuda.synchronize()
            exact = _same_bits(got, want)
            num = ~(torch.isnan(got) | torch.isnan(want))
            err = (got.float() - want.float())[num].abs().max().item()
            line = {"phase": "kernel_check", "kernel": "relu_maxpool",
                    "case": case, "dtype": str(dtype).split(".")[1],
                    "shape": list(shape), "bit_exact": exact,
                    "nan_outputs": int(torch.isnan(want).sum()),
                    "max_abs_err": err}
            if case == "main":
                line["kernel_ms"] = time_ms(lambda: relu_maxpool_cuda(x))
                line["plain_ms"] = time_ms(lambda: relu_maxpool_plain(x))
                line["library_ms"] = time_ms(lambda: f.max_pool2d(
                    f.relu(x.permute(0, 3, 1, 2)), 3, 2, 1))
                out_el = got.numel()
                line["bound_ms"], line["bound_by"] = bound_ms(
                    (x.numel() + out_el) * x.element_size(),
                    9 * out_el + x.numel())
                results[("relu_maxpool", line["dtype"])] = line
            emit(line)
            if not exact:
                raise AssertionError(f"relu_maxpool {case} {dtype}: not "
                                     f"bit-exact (max err {err})")
            del x, got, want, num


# ------------------------------------------------------------------ K2
def _proposal_like_boxes(gen, b, n, img_h, img_w):
    """Boxes the size of RPN proposals: log-uniform sides 8..img."""
    import torch
    u = torch.rand((b, n, 4), generator=gen, device="cuda")
    side_w = torch.exp(u[..., 2] * math.log(img_w / 8.0)) * 8
    side_h = torch.exp(u[..., 3] * math.log(img_h / 8.0)) * 8
    x0 = u[..., 0] * (img_w - side_w)
    y0 = u[..., 1] * (img_h - side_h)
    return torch.stack([x0, y0, x0 + side_w, y0 + side_h], -1).contiguous()


def _edge_boxes(b, img_h, img_w):
    import torch
    special = torch.tensor([
        [0, 0, img_w, img_h], [10.0, 12.0, 13.0, 14.0],
        [50.0, 40.0, 50.0, 90.0], [80.0, 60.0, 70.0, 50.0],
        [-100.0, -80.0, 30.0, 20.0],
        [img_w + 20, img_h + 30, img_w + 90, img_h + 99],
        [-3000.0, -50.0, 3000.0, img_h + 40], [5.5, 7.25, 300.75, 240.5],
    ], dtype=torch.float32, device="cuda")
    return special.expand(b, -1, -1).contiguous()


def _bf16_ulp(mag):
    """bfloat16 ulp at magnitude ``mag`` (float32): a value in
    [2^(e-1), 2^e) has 8 significant bits, so its ulp is 2^(e-8)."""
    import torch
    _, e = torch.frexp(mag)
    return torch.exp2((e - 8).float())


def roi_align_ops(boxes, scale, pooled, c):
    """Operations the gather form needs for these boxes (adaptive):
    per output element, 4 taps x (multiply + add) per sample."""
    import torch
    bw = (boxes[..., 2] * scale - 0.5) - (boxes[..., 0] * scale - 0.5)
    bh = (boxes[..., 3] * scale - 0.5) - (boxes[..., 1] * scale - 0.5)
    pooled_t = torch.full_like(bw, pooled)  # exact division, see _div
    srx = torch.clamp(torch.ceil(bw / pooled_t), 0, 8)
    sry = torch.clamp(torch.ceil(bh / pooled_t), 0, 8)
    return float((srx * sry).sum().item()) * pooled * pooled * c * 8


def check_roi_align(gen, results):
    import torch
    from locov_torch.ops.roi_align import roi_align_batched, roi_align_cuda
    scale, pooled = 1.0 / 16, 14
    img_h, img_w = 800, 1344
    fmain = torch.randn((8, 50, 84, 1024), generator=gen, device="cuda")
    cases = [("main", fmain, _proposal_like_boxes(gen, 8, 1000, img_h,
                                                  img_w), 0),
             ("edges", fmain[:2, :, :, :256].contiguous(),
              _edge_boxes(2, img_h, img_w), 0),
             ("fixed_ratio", fmain[:2, :, :, :256].contiguous(),
              _proposal_like_boxes(gen, 2, 100, img_h, img_w), 2)]
    for dtype in (torch.float32, torch.bfloat16):
        for case, feats, boxes, sr in cases:
            f = feats.to(dtype)
            got = roi_align_cuda(f, boxes, scale, pooled, sr)
            # the plain version: f32 matrices and contractions, one cast
            plain = roi_align_batched(f, boxes, scale, pooled, sr)
            torch.cuda.synchronize()
            fmax = f.float().abs().max().item()
            err = (got.float() - plain.float()).abs()
            line = {"phase": "kernel_check", "kernel": "roi_align_fused",
                    "case": case, "dtype": str(dtype).split(".")[1],
                    "features": list(f.shape), "boxes": list(boxes.shape),
                    "sampling_ratio": sr, "max_abs_err": err.max().item(),
                    "max_abs_features": fmax}
            if dtype == torch.float32:
                ok = bool((err <= 1e-5 * fmax).all())
            else:
                # one bf16 ulp at the larger magnitude, with the f32
                # sum-order bound as a floor near 0
                ulp = _bf16_ulp(torch.maximum(got.float().abs(),
                                              plain.float().abs()))
                ok = bool((err <= torch.clamp(ulp, min=1e-5 * fmax)).all())
                line["over_one_bf16_ulp"] = int((err > ulp).sum())
                del ulp
            line["within_tolerance"] = ok
            if case == "edges":
                zero = bool((got[:, 2:4] == 0).all() and
                            (got[:, 5] == 0).all())
                line["degenerate_exact_zero"] = zero
                ok = ok and zero
            if case == "main":
                line["kernel_ms"] = time_ms(
                    lambda: roi_align_cuda(f, boxes, scale, pooled, sr))
                line["plain_ms"] = time_ms(
                    lambda: roi_align_batched(f, boxes, scale, pooled, sr),
                    reps=20)
                line["library_ms"] = None  # no single PyTorch call
                nbytes = f.numel() * f.element_size() + boxes.numel() * 4 \
                    + got.numel() * got.element_size()
                line["bound_ms"], line["bound_by"] = bound_ms(
                    nbytes, roi_align_ops(boxes, scale, pooled, f.shape[3]))
                results[("roi_align_fused", line["dtype"])] = line
            emit(line)
            if not ok:
                raise AssertionError(f"roi_align_fused {case} {dtype}: "
                                     f"max err {err.max().item()}")
            del f, got, plain, err
    del fmain


# ------------------------------------------------------ small reference
def _tiny_cfg():
    from locov_torch.config import get_cfg
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "OvrRCNN"
    cfg.MODEL.PIXEL_STD = [57.375, 57.12, 58.395]
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP = 8, 32, 8
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = True
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 8
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def small_reference(seed):
    """Tiny float32 model: card (kernels) vs CPU (plain versions). The
    RPN is tamed as in the CPU parity tests (zero anchor deltas)."""
    import numpy as np
    import torch
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.weights import seeded_init_
    rng = np.random.RandomState(seed)
    batch = DetectionBatch(images=ImageBatch(
        image=(rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
        hw=np.array([[64, 64], [48, 56]], np.int32),
        orig_hw=np.array([[128, 128], [96, 112]], np.int32)))
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    dets = {}
    for dev in ("cpu", "cuda"):
        model = seeded_init_(build_meta_arch(_tiny_cfg(), device="cpu"),
                             seed)
        with torch.no_grad():
            model.rpn_head.anchor_deltas.weight.zero_()
        model.to(dev)
        before = dict(kernel_lib.LAUNCHES)
        dets[dev] = model.inference(to_torch(batch, dev),
                                    torch.from_numpy(ce).to(dev))
        launched = {k: kernel_lib.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    cpu, gpu = dets["cpu"], [x.cpu() for x in dets["cuda"]]
    m = cpu.mask.numpy()
    same_mask = bool((gpu[3].numpy() == m).all())
    same_cls = bool((gpu[2].numpy()[m] == cpu.classes.numpy()[m]).all())
    box_err = float(np.abs(gpu[0].numpy()[m] - cpu.boxes.numpy()[m]).max())
    score_err = float(np.abs(gpu[1].numpy() - cpu.scores.numpy()).max())
    line = {"phase": "small_reference", "detections": int(m.sum()),
            "same_mask": same_mask, "same_classes": same_cls,
            "max_box_err_px": box_err, "max_score_err": score_err,
            "gpu_launches": launched}
    emit(line)
    ok = (same_mask and same_cls and m.sum() > 0 and box_err <= 1e-3
          and score_err <= 1e-5 and all(v > 0 for v in launched.values()))
    if not ok:
        raise AssertionError(f"small reference mismatch: {line}")


# ------------------------------------------------------------ main path
def main_path(seed, batches):
    import numpy as np
    import torch
    from locov_torch.config import config_path, get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.weights import seeded_init_

    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    t0 = time.perf_counter()
    model = seeded_init_(build_meta_arch(cfg), seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    b = 8
    batch = to_torch(DetectionBatch(images=ImageBatch(
        image=(rng.rand(b, 800, 1344, 3) * 255).astype(np.float32),
        hw=np.stack([np.full(b, 800), np.full(b, 1312)], 1).astype(
            np.int32),
        orig_hw=np.full((b, 2), 640, np.int32))), "cuda")
    class_emb = torch.from_numpy(
        rng.randn(66, 768).astype(np.float32)).cuda()

    t0 = time.perf_counter()
    model.inference(batch, class_emb)  # warm-up (cuDNN plans, caches)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    times, dets = [], None
    for _ in range(batches):
        t0 = time.perf_counter()
        dets = model.inference(batch, class_emb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernel_lib.LAUNCHES)
    ms = statistics.median(times)
    finite = bool(torch.isfinite(dets.boxes).all() and
                  torch.isfinite(dets.scores).all())
    shapes_ok = (tuple(dets.boxes.shape) == (b, 100, 4) and
                 tuple(dets.scores.shape) == (b, 100) and
                 tuple(dets.classes.shape) == (b, 100))
    kept = int(dets.mask.sum())
    in_range = bool((dets.classes[dets.mask] >= 0).all() and
                    (dets.classes[dets.mask] < 65).all() and
                    (dets.boxes[dets.mask] >= 0).all() and
                    (dets.boxes[dets.mask] <= 640).all())
    line = {"phase": "main_path", "config": "configs/coco_stt.yaml",
            "dtype": "bfloat16", "batch": b, "image": [800, 1344],
            "batches": batches, "ms_per_batch": ms,
            "ms_per_batch_all": times, "images_per_s": b / ms * 1e3,
            "detections_kept": kept, "finite": finite,
            "shapes_ok": shapes_ok, "in_range": in_range,
            "launches": launches, "model_init_s": init_s,
            "warmup_s": warm_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if not (finite and shapes_ok and in_range):
        raise AssertionError(f"main path output check failed: {line}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    profile_batch(model, batch, class_emb, ms)
    return launches


def profile_batch(model, batch, class_emb, unprofiled_ms):
    """One more batch under torch.profiler: the device's busy time (the
    sum of its kernels' times) against the batch's wall time, the
    kernels that take the most of it, and for each ``OvrRCNN.<stage>``
    range of the model's inference its host time and the device time of
    the kernels launched in it. The profiler stretches the wall time, so
    the idle share is also given against ``unprofiled_ms``, the main
    path's median batch time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.inference(batch, class_emb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ranges = [e for e in events if e.key.startswith("OvrRCNN.")]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    stages = {}
    for e in ranges:
        st = stages.setdefault(e.key[len("OvrRCNN."):], {})
        if e.device_type == DeviceType.CUDA:  # the range on the device
            st["device_span_ms"] = device_us(e) / 1e3
        else:
            st["host_ms"] = e.cpu_time_total / 1e3
            st["device_kernels_ms"] = device_us(e) / 1e3
    emit({"phase": "main_path_profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
          "kernel_launches": sum(e.count for e in kernels),
          "stages": stages,
          "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                              e.count] for e in top]})
    if not stages:
        raise AssertionError("the profile holds no OvrRCNN.<stage> range")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from locov_torch.ops import kernel_lib
    except ImportError as e:
        print(f"chip_smoke: the locov_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    build_s = kernel_lib.build()
    regs = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
            for k, v in kernel_lib.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": regs})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    check_relu_maxpool(gen, results)
    check_roi_align(gen, results)
    torch.cuda.empty_cache()
    small_reference(args.seed)
    launches = main_path(args.seed, args.batches)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = results[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16",
            "shape": r.get("shape") or r.get("features"),
            "f32_ms": results[(name, "float32")]["kernel_ms"],
            "f32_plain_ms": results[(name, "float32")]["plain_ms"]})
    emit({"kernels": kernels,
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
