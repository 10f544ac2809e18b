#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--batches N] [--seed S]

Phases, one JSON line each, in order:

1. env: torch and CUDA versions, the card's name and power limit; the
   hand-written CUDA kernels are built from ``locov_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
2. kernel checks: each kernel against its plain PyTorch version on the
   card, in float32 and bfloat16, at the shapes of the paths below (K1
   x [8, 400, 672, 64], and [8, 672, 400, 64] for the eval path's
   portrait bucket; K2 features [8, 50, 84, 1024] with 1000 boxes an
   image, and [8, 84, 50, 1024] portrait; K3 the same features with 512
   boxes an image, 20 of them gt-sized), plus tie-heavy (K1: also with
   NaNs and negative zeros) and edge-box cases. K1 forward and backward
   must be bit-exact with the plain version (the backward: with the
   plain backward, autograd of the plain forward masked with x > 0),
   NaN where it has NaN (bfloat16
   backward: one ulp is allowed, and it came out bit-exact); the
   backward writes into a NaN-filled dx and gives the same bits on a
   second launch and under other plans. K2 and K3-fwd in float32 within
   1e-5 * max|F|; in bfloat16 within one bfloat16 ulp of the plain
   version (computed in float32 and cast once), or 1e-5 * max|F| where
   that is larger (the float32 sum-order error, which exceeds a bfloat16
   ulp of outputs close to 0); two launches, and launches under other
   plans, must give the same bits. K3-bwd within 1e-5 * (the plain backward
   of |g|) at each cell, plus one bfloat16 ulp in bfloat16, the same
   bits on two launches, also at feature heights 7 and 1 (band edges);
   degenerate and outside boxes contribute exactly 0. K5 within one
   bfloat16 ulp plus the float32 sum-order floor, into a NaN-filled
   output, the same bits on two launches; K4 likewise into a NaN-filled
   output, the same bits on two launches, in six cases (res2, res3 M
   128, partial tiles, H 1, and b1 = 3 against a relu(b1) halo).
   Kernel, plain and library-call times are medians of CUDA-event
   timings after warm-up.
3. small references: a tiny float32 OvrRCNN on the card, with cuDNN's
   TF32 allowed as PyTorch's default has it (the port's float32
   convolutions turn it off themselves), through the kernels, against
   the same model on the CPU, through the
   plain versions, which the CPU tests hold against the JAX package:
   inference, and one training step at FREEZE_AT 0 (losses, gradients,
   SGD updates); then one training step of a tiny float32
   DistillProposalMMSSRCNN (the LSM model) likewise, every draw pinned;
   then the family of phase 10 likewise (``small_reference_family``: the
   grid models, the box pass alone, the fused passes, the MLP head, the
   grounding head's random branches with their draws pinned, and STT
   with the grounding box predictor, a step and inference); then
   ``eval_reference`` (phase 7's reference).
4. main path: STT inference, ``build_meta_arch`` on ``cuda`` from
   configs/coco_stt.yaml in bfloat16 at full width, seeded random
   weights, 8 images of 800 x 1344 (valid 800 x 1312, original 640 x
   640) and a [66, 768] class-embedding matrix, as bench.py builds the
   workload; then one batch under torch.profiler: device busy time and
   idle share, and per ``OvrRCNN.<stage>`` range the host time and the
   device time of its kernels.
5. train path: the STT training step (``make_train_step`` over
   ``OvrRCNN.losses`` and ``build_optimizer``) from the same config at
   full width in bfloat16, batch 8 with synthetic gt, one warm-up and
   three timed steps, the frozen state checked unchanged and the
   trained state changed; one step under torch.profiler; then one step
   at FREEZE_AT 0, batch 2, where the stem's backward runs.
6. LSM path: the LSM training step (``DistillProposalMMSSRCNN`` from
   configs/coco_lsm.yaml at full width in bfloat16, built by the bench
   twin's ``build_full``: batch 4, 200 gt boxes an image, 70 caption
   tokens, FREEZE_AT 0), one warm-up and ``LSM_STEPS`` timed steps,
   finite losses, the frozen state unchanged and the trained state
   changed, every kernel of ``LSM_KERNELS`` launched; one step under
   torch.profiler by ``DistillProposalMMSSRCNN.<stage>``. The K1 and K3
   checks of phase 2 also run at its shapes.
7. eval path: STT evaluation, ``engine/trainer.py:test`` from
   configs/coco_stt.yaml in bfloat16 at full width (seeded weights,
   TEST.IMS_PER_BATCH 8) on a synthetic ``coco_generalized_zeroshot_val``
   tree of 256 JPEGs that the script writes (``write_coco_val``: COCO
   val's 640 x 480 and 480 x 640, a few square, the 65 classes of the
   zero-shot split), through the real loader: a decode check first, then
   AP, AP50, AP50-seen/unseen, images/s, the time split (loader wait,
   host-to-device, inference, ``.cpu()``, evaluator), the buckets and
   padded rows, K1-fwd and K2 once a batch, peak memory; the gt oracle
   (AP 100); one batch under torch.profiler. Its CPU reference is phase
   3's ``eval_reference``: ``test`` of a tiny float32 model on the
   micro-COCO tree, card against CPU (flat detections and AP).
8. trainer path: both LocOV stages through the CLI twin
   (``locov_torch.train_ovnet.main``) at full configs/coco_lsm.yaml and
   coco_stt.yaml width in bfloat16, on a synthetic tree the script
   writes (``write_coco_trainval``: 64 train and 24 val JPEGs in COCO's
   sizes and mix, captions, OLN-style proposals, the zero-shot splits):
   LSM from a checkpoint of seeded weights at a trained scale, batch 4,
   6 steps, checkpoints pruned to two, the loss-and-detection
   evaluation; ``--resume`` to 8 steps (the model and the momentum
   buffers equal to the checkpoint's before the first step); STT from
   the LSM's ``model_final`` through the rename map (res5 and the
   projection equal to the LSM's), batch 8, 4 steps, AP50-seen and
   -unseen; per stage the loop's images/s (by the median step and over
   all steps), data time, the checkpoints' seconds (caller's thread, in
   all) and bytes, seconds and peak memory; K1-fwd, K1-bwd, K2 and
   K3-bwd launched. ``KernelShapes`` records the signature of every
   launch of the path (the buckets 800 x 1344, 1344 x 800 and 800 x
   800 at batch 4 and 8, the evaluations at batch 1), and after the
   path each kernel is checked at each of them on fresh inputs with
   phase 2's tolerances (``check_path_shapes``).
9. scale path, on the trainer path's tree and seed checkpoint: both
   published LSM recipes at their batch of 32. configs/coco_lsm.yaml
   through ``train_ovnet --num-gpus 1`` as batch 4 with
   ``GRADIENT_ACCUMULATION_STEPS`` 8 for 16 iterations (the parameters
   and momentum move at iterations 8 and 16 only, the logged learning
   rate is the schedule at iteration // 8, no process group), then
   ``--resume`` from the checkpoint after iteration 12 (model,
   momentum, accumulated gradients and micro-step count equal to the
   checkpoint's before the first step); configs/coco_lsm_global.yaml at
   batch 32 with ``TPU.REMAT_BACKBONE`` and ``PAIRWISE_CHUNK`` 128, 3
   steps (peak memory, images/s); one LSM step at batch 8 in four
   variants (neither, remat, chunk, both: peak memory, ms, gradients
   against the plain variant's); two data-parallel gloo ranks on the
   card in float32 (local scope = accumulation 2 on one rank, global
   scope = one rank at batch 4, the scopes differ). The kernels'
   signatures of the path, the ranks' included (batch 32 among them),
   are checked as phase 8's.
10. family path (``family_path``), on the trainer path's tree and seed
   checkpoint, at full configs/coco_lsm.yaml and coco_stt.yaml width in
   bfloat16: ``MMSSGridModel`` and ``DistillMMSSGridModel`` through the
   CLI twin at batch 4 (from the LSM seed checkpoint through the rename
   map, a few steps, checkpoints, the 'ovr' loss-only evaluation, the
   Distill model resumed bit for bit), the grid -> STT hand-off (its
   trunk res5 into the ROI res5, its projection into ``emb_pred``, one
   detection batch of 8); ``DistillOnlyProposalMMSSRCNN`` at batch 4
   (``box_kd_loss`` alone); ``TPU.FUSED_MMSS_PASSES`` off and on, the
   same weights, batch and draws, dropout off, in turns (median ms,
   losses and gradients against the unfused run's, one profile of each:
   the MMSS stages' host ms and the launches a run); the MLP head, then
   the grounding head's random branches, a step each; STT with
   ``EmbeddingGroundingFastRCNNOutputLayers`` on class names of 1 to 4
   tokens, inference at batch 8 (ms) and training steps. Its kernel
   signatures are checked as phase 8's.
11. serving path (``serving_path``): configs/coco_stt.yaml in bfloat16
   at full width, seeded weights at a trained scale, exported by the
   export twin (``locov_torch.tools.export_serving``) at batch 8, 800 x
   1344 under ``build/`` (export seconds, each file's bytes); a fresh
   ``python`` process loads the artifact with ``locov_torch.serving.
   load_exported``, imports no ``locov_torch.models`` module, runs 1 + 5
   batches and launches K1-fwd and K2; here the loaded program runs
   again under ``KernelShapes`` (its signatures then checked as phase
   8's) against eager ``model.inference`` (classes and mask equal, boxes
   and scores equal or within 1e-3 px / 1e-5), and the ms a batch of
   each (the median of 5 turns each, in turns).
12. TTA path (``tta_path``): ``engine/trainer.py:test`` with
   TEST.AUG.ENABLED at its defaults (sizes 400-1200, MAX_SIZE 4000,
   flip: 18 passes) over 16 synthetic JPEGs (seconds, passes, AP keys,
   peak memory, every kernel checked at every TTA signature as phase
   8's); then, at the test size alone, the unflipped pass's detections
   equal the plain evaluation's array for array (and their merge's AP
   keys within 1e-6, the detections the merge removed printed), and the
   flipped pass's images and boxes are the mirror of its inputs and of
   its own raw boxes.
13. block path: ``locov_torch.tools.bench_block.main`` at its defaults
   (K4 at res2 [4, 200, 336, 256] M 64 against cuDNN's three convs).
14. stem path: ``locov_torch.tools.bench_stem.main`` at its defaults
   (K5 at [4, 800, 1344, 3] against ``F.conv2d``, forward and forward +
   backward).
15. the ``kernels`` line (one row per TPU kernel replaced:
   ``roi_align_fused`` has a K2 row at the inference shapes and a
   K3-fwd row at the training shapes; ``launches_by_path`` gives each
   path's counts, ``eval``, ``trainer``, ``scale``, ``family``,
   ``serving`` and ``tta`` among them), the
   card's ``nvidia-smi`` name and power limit, and the result line
   ``{"ok": true, "device": {...}}``.

Launch counts are zeroed just before each path's timed run and read
just after; each kernel of the path must have launched. Any failed
check raises, and the script exits non-zero without the result line.
It does the same when no CUDA device is present, and when the
``locov_torch`` package is not beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
BF16_TC_OPS_PER_S = 989.4e12     # H100 SXM dense bfloat16, tensor cores
# One row of the kernels line per TPU kernel replaced: (kernel, source,
# the TPU kernel, the path whose launches the row reports, the check
# whose numbers it reports). roi_align_fused replaces both K2 (inference)
# and K3-fwd (training forward), each with its own row.
KERNEL_ROWS = (
    ("relu_maxpool", "locov_torch/csrc/relu_maxpool.cu",
     "locov_tpu/ops/pallas_pool.py:165", "inference", "relu_maxpool"),
    ("relu_maxpool_bwd", "locov_torch/csrc/relu_maxpool.cu",
     "locov_tpu/ops/pallas_pool.py:192", "train_freeze0",
     "relu_maxpool_bwd"),
    ("roi_align_fused", "locov_torch/csrc/roi_align.cu",
     "locov_tpu/ops/pallas_roi_align.py:162", "inference",
     "roi_align_fused"),
    ("roi_align_fused", "locov_torch/csrc/roi_align.cu",
     "locov_tpu/ops/pallas_roi_align.py:82", "train",
     "roi_align_fused_train"),
    ("roi_align_bwd", "locov_torch/csrc/roi_align.cu",
     "locov_tpu/ops/pallas_roi_align.py:288", "train", "roi_align_bwd"),
    ("bottleneck_block", "locov_torch/csrc/bottleneck_block.cu",
     "locov_tpu/ops/pallas_block.py:133", "block", "bottleneck_block"),
    ("stem_conv_bn", "locov_torch/csrc/stem_conv_bn.cu",
     "locov_tpu/ops/pallas_stem.py:246", "stem", "stem_conv_bn"),
)
INFERENCE_KERNELS = ("relu_maxpool", "roi_align_fused")
TRAIN_KERNELS = ("relu_maxpool", "relu_maxpool_bwd", "roi_align_fused",
                 "roi_align_bwd")  # at FREEZE_AT 0
LSM_KERNELS = ("relu_maxpool", "relu_maxpool_bwd", "roi_align_fused",
               "roi_align_bwd")  # coco_lsm.yaml: FREEZE_AT 0
TRAIN_STEPS = 3  # timed steps of the train path
LSM_STEPS = 3  # timed steps of the LSM path
LSM_RANGE = "DistillProposalMMSSRCNN."
# parameters whose gradient is zero but for rounding (a softmax ignores
# a shift of a whole row): held to an absolute bound, not a relative one
ZERO_BY_SHIFT = ("attention_self.key.bias", "bi_seq_relationship.bias")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def _k1_input(gen, shape, kind, case):
    """Standard normal, or heavy ties (values -2..2), with NaNs and
    negative zeros among the ties in the ``ties`` case."""
    import torch
    if kind == "randn":
        return torch.randn(shape, generator=gen, device="cuda")
    x = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
    if case == "ties":
        u = torch.rand(shape, generator=gen, device="cuda")
        x[u < 0.02] = float("nan")
        x[(u >= 0.02) & (u < 0.12)] = -0.0
    return x


def check_relu_maxpool(gen, results):
    import torch
    from locov_torch.ops.relu_maxpool import (relu_maxpool_cuda,
                                              relu_maxpool_plain)
    from locov_torch.tools.timing import time_ms
    f = torch.nn.functional
    main = (8, 400, 672, 64)
    cases = [("main", main, "randn"), ("ties", (2, 64, 96, 64), "ties"),
             ("odd", (3, 33, 47, 24), "ties"),
             ("lsm", (4, 400, 672, 64), "randn"),
             ("portrait", (8, 672, 400, 64), "randn")]
    for dtype in (torch.float32, torch.bfloat16):
        for case, shape, kind in cases:
            x = _k1_input(gen, shape, kind, case).to(dtype)
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


def check_relu_maxpool_bwd(gen, results):
    """K1-bwd against the plain backward (autograd of the plain
    forward) on the same x and dy. float32 must be bit-exact (the kernel
    sums a tap's <= 4 windows in the plain version's order); bfloat16
    within one bfloat16 ulp (the sum is in f32, rounded once), NaN in the
    same places. Every launch compared writes into a NaN-filled dx; a
    second launch, and launches under other plans (4 and 16 window rows
    a block), must give the same bits."""
    import torch
    from locov_torch.ops.relu_maxpool import (_launch_bwd,
                                              relu_maxpool_bwd_cuda,
                                              relu_maxpool_bwd_plain,
                                              relu_maxpool_plain)
    from locov_torch.tools.timing import time_ms
    f = torch.nn.functional
    cases = [("main", (8, 400, 672, 64), "randn"),
             ("ties", (2, 64, 96, 64), "ties"),
             ("odd", (3, 33, 47, 24), "ties"),
             ("lsm", (4, 400, 672, 64), "randn")]
    for dtype in (torch.float32, torch.bfloat16):
        for case, shape, kind in cases:
            x = _k1_input(gen, shape, kind, case)
            x = x.to(dtype)
            oshape = (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                      shape[3])
            dy = torch.randn(oshape, generator=gen, device="cuda").to(dtype)
            got = _launch_bwd(x, dy, fill=math.nan)
            want = relu_maxpool_bwd_plain(x, dy)
            torch.cuda.synchronize()
            exact = _same_bits(got, want)
            again = all(_same_bits(_launch_bwd(x, dy, rows, math.nan), got)
                        for rows in (None, 4, 16))
            same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
            err = torch.nan_to_num((got.float() - want.float()).abs())
            ulp = _bf16_ulp(torch.maximum(got.float().abs(),
                                          want.float().abs()))
            line = {"phase": "kernel_check", "kernel": "relu_maxpool_bwd",
                    "case": case, "dtype": str(dtype).split(".")[1],
                    "shape": list(shape), "bit_exact": exact,
                    "nan_inputs": int(torch.isnan(x).sum()),
                    "max_abs_err": err.max().item(),
                    "over_one_bf16_ulp": int((err > ulp).sum()),
                    "same_bits_again_and_every_plan": again}
            ok = again and (exact if dtype == torch.float32 else
                            same_nan and line["over_one_bf16_ulp"] == 0)
            if case == "main":
                line["kernel_ms"] = time_ms(
                    lambda: relu_maxpool_bwd_cuda(x, dy))
                xr = x.detach().requires_grad_(True)
                y = relu_maxpool_plain(xr)
                line["plain_ms"] = time_ms(lambda: torch.autograd.grad(
                    y, xr, dy, retain_graph=True))
                xl = x.detach().requires_grad_(True)
                yl = f.max_pool2d(f.relu(xl.permute(0, 3, 1, 2)), 3, 2, 1)
                dyl = dy.permute(0, 3, 1, 2)
                line["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    yl, xl, dyl, retain_graph=True))
                del xr, y, xl, yl, dyl
                nbytes = (x.numel() + dy.numel() + got.numel()) * \
                    x.element_size()
                # per window: 9 compares to find its argmax, one add of
                # its dy; per input: the relu test
                line["bound_ms"], line["bound_by"] = bound_ms(
                    nbytes, 10 * dy.numel() + x.numel())
                results[("relu_maxpool_bwd", line["dtype"])] = line
            line["within_tolerance"] = ok
            emit(line)
            if not ok:
                raise AssertionError(f"relu_maxpool_bwd {case} {dtype}: "
                                     f"max err {line['max_abs_err']}")
            del x, dy, got, want, err, ulp


# ------------------------------------------------------------------ K2
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


def roi_align_fwd_bits(f, boxes, scale, pooled, sr, got):
    """The forward kernel's plan at these features and whether a second
    launch, and launches under other plans (a half and a quarter of the
    channel tile, 16-byte loads, 1 and 7 output rows a block), give
    ``got``'s bits."""
    import torch
    from locov_torch.ops import roi_align as roi
    _, h, w, c = f.shape
    plan = roi._fwd_plan(h, w, c, f.dtype, pooled, roi._align(f))
    tile, vec = plan["channel_tile"], plan["vec"]
    half = roi._vec(c, f.dtype, roi._align(f) >= 16, 16)
    others = []
    for d, v, rows in ((2, vec, plan["rows"]), (4, vec, plan["rows"]),
                       (1, half, plan["rows"]), (1, vec, 1), (1, vec, 7)):
        step = math.lcm(8, v)  # a tile: whole vectors, a multiple of 8
        others.append(roi._fwd_launch_plan(
            h, w, max(step, tile // d // step * step), v, pooled, rows))
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def same_bits(out):  # the outputs are finite: compare the words
        return torch.equal(out.view(ints[out.dtype]),
                           got.view(ints[got.dtype]))
    again = roi.roi_align_cuda(f, boxes, scale, pooled, sr)
    same = same_bits(again)
    del again
    every = True
    for other in others:
        out = roi._launch_fwd(f, boxes, scale, pooled, sr, other, math.nan)
        every = every and same_bits(out)
        del out
    return {"channel_tile": tile, "vec": vec, "rows": plan["rows"],
            "threads": plan["threads"],
            "smem_bytes": plan["smem_bytes"],
            "same_bits_two_launches": same, "same_bits_every_plan": every}


def check_roi_align(gen, results):
    """K2 against the plain version: main (the inference shapes), edge
    boxes, a fixed ratio and the portrait bucket (1344 x 800 images:
    features [8, 84, 50, 1024], 1000 boxes an image); float32 within
    1e-5 * max|F|, bfloat16 within one bfloat16 ulp or 1e-5 * max|F|;
    degenerate and outside boxes exactly 0; two launches and every launch
    plan the same bits."""
    import torch
    from locov_torch.ops.roi_align import roi_align_batched, roi_align_cuda
    from locov_torch.tools.bench_roi_fwd import proposal_boxes
    from locov_torch.tools.timing import time_ms
    scale, pooled = 1.0 / 16, 14
    img_h, img_w = 800, 1344
    fmain = torch.randn((8, 50, 84, 1024), generator=gen, device="cuda")
    cases = [("main", fmain, proposal_boxes(gen, 8, 1000, img_h, img_w), 0),
             ("edges", fmain[:2, :, :, :256].contiguous(),
              _edge_boxes(2, img_h, img_w), 0),
             ("fixed_ratio", fmain[:2, :, :, :256].contiguous(),
              proposal_boxes(gen, 2, 100, img_h, img_w), 2),
             ("portrait", fmain.reshape(8, 84, 50, 1024),
              proposal_boxes(gen, 8, 1000, img_w, img_h), 0)]
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
            del plain, err
            line.update(roi_align_fwd_bits(f, boxes, scale, pooled, sr, got))
            ok = ok and line["same_bits_two_launches"] and \
                line["same_bits_every_plan"]
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
                                     f"{line}")
            del f, got
    del fmain


# ------------------------------------------------------------------ K3
def _band_edge_boxes(gen, b, n, img_h, img_w):
    """Proposal-sized boxes in an image ``img_h`` tall, the first
    five replaced by tall thin ones (half a cell or less wide) whose
    spans start and end inside different bands of feature rows."""
    import torch
    from locov_torch.tools.bench_roi_fwd import proposal_boxes
    bx = proposal_boxes(gen, b, n, img_h, img_w)
    spans = torch.tensor([[0.0, 1.0], [0.15, 0.9], [0.4, 0.75],
                          [0.05, 0.55], [0.6, 1.0]], device="cuda")
    bx[:, :5, 0] = torch.tensor([100.0, 300.0, 301.0, 700.0, 1200.0],
                                device="cuda")
    bx[:, :5, 2] = bx[:, :5, 0] + torch.tensor([8.0, 1.0, 4.0, 8.0, 2.0],
                                               device="cuda")
    bx[:, :5, 1] = spans[:, 0] * img_h
    bx[:, :5, 3] = spans[:, 1] * img_h
    return bx.contiguous()


def check_roi_align_train(gen, results):
    """K3 at the training step's shapes (512 boxes an image, 20 of them
    gt-sized), adaptive and ratio 2, float32 and bfloat16. Forward: the
    K2 kernel, with K2's tolerances. Backward (K3-bwd) against the plain
    backward (f32 einsums, cast once): |err| <= 1e-5 * (the plain
    backward of |g|) at each cell, the f32 sum-order bound of a cell
    that many boxes touch; in bfloat16 plus one bfloat16 ulp of the
    result; two launches on the same inputs must give the same bits.
    Feature heights that are not a multiple of the kernel's band rows
    (7 and 1, tall thin boxes across band borders) are held to the same
    tolerance. Boxes that are degenerate (adaptive) or wholly
    outside the image must contribute exactly 0."""
    import torch
    from locov_torch.ops.roi_align import (_bwd_plan, roi_align_batched,
                                           roi_align_bwd_cuda,
                                           roi_align_bwd_plain,
                                           roi_align_cuda)
    from locov_torch.tools.bench_roi_bwd import train_boxes
    from locov_torch.tools.timing import time_ms
    scale, pooled = 1.0 / 16, 14
    img_h, img_w = 800, 1344
    fmain = torch.randn((8, 50, 84, 1024), generator=gen, device="cuda")
    bmain = train_boxes(gen, 8, 512, 20, img_h, img_w)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        f = fmain.to(dtype)
        for sr in (0, 2):
            got = roi_align_cuda(f, bmain, scale, pooled, sr)
            plain = roi_align_batched(f, bmain, scale, pooled, sr)
            torch.cuda.synchronize()
            fmax = f.float().abs().max().item()
            err = (got.float() - plain.float()).abs()
            tol = torch.full_like(err, 1e-5 * fmax)
            if dtype == torch.bfloat16:
                tol = torch.clamp(_bf16_ulp(torch.maximum(
                    got.float().abs(), plain.float().abs())), min=1e-5 * fmax)
            ok = bool((err <= tol).all())
            line = {"phase": "kernel_check", "kernel": "roi_align_fused",
                    "case": "train", "dtype": dt, "features": list(f.shape),
                    "boxes": list(bmain.shape), "sampling_ratio": sr,
                    "max_abs_err": err.max().item(), "within_tolerance": ok}
            del plain, err, tol
            line.update(roi_align_fwd_bits(f, bmain, scale, pooled, sr, got))
            ok = ok and line["same_bits_two_launches"] and \
                line["same_bits_every_plan"]
            del got
            if sr == 0:
                line["kernel_ms"] = time_ms(
                    lambda: roi_align_cuda(f, bmain, scale, pooled, sr))
                line["plain_ms"] = time_ms(
                    lambda: roi_align_batched(f, bmain, scale, pooled, sr),
                    reps=20)
                line["library_ms"] = None  # no single PyTorch call
                out_bytes = 8 * 512 * pooled * pooled * 1024 * \
                    f.element_size()
                line["bound_ms"], line["bound_by"] = bound_ms(
                    f.numel() * f.element_size() + bmain.numel() * 4
                    + out_bytes, roi_align_ops(bmain, scale, pooled, 1024))
                results[("roi_align_fused_train", dt)] = line
            emit(line)
            if not ok:
                raise AssertionError(f"roi_align_fused train {dt} sr {sr}: "
                                     f"max err {line['max_abs_err']}")
        del f
        g = torch.randn((8, 512, pooled, pooled, 1024), generator=gen,
                        device="cuda").to(dtype)
        for sr in (0, 2):
            got = roi_align_bwd_cuda(g, bmain, scale, 50, 84, pooled, sr)
            again = roi_align_bwd_cuda(g, bmain, scale, 50, 84, pooled, sr)
            plain = roi_align_bwd_plain(g, bmain, scale, 50, 84, pooled, sr)
            # f32 sum-order bound: the plain backward of |g|
            absbwd = roi_align_bwd_plain(g.abs(), bmain, scale, 50, 84,
                                         pooled, sr).float()
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs()
            tol = 1e-5 * absbwd
            if dtype == torch.bfloat16:
                tol = tol + _bf16_ulp(torch.maximum(got.float().abs(),
                                                     plain.float().abs()))
            # the sum order is fixed: two launches give the same bits
            same = _same_bits(got, again)
            ok = bool((err <= tol).all()) and same
            line = {"phase": "kernel_check", "kernel": "roi_align_bwd",
                    "case": "main", "dtype": dt, "shape": list(g.shape),
                    "boxes": list(bmain.shape), "sampling_ratio": sr,
                    **_bwd_plan(50, 84, 1024, dtype),
                    "max_abs_err": err.max().item(),
                    "max_err_over_abs_bound": (err / absbwd.clamp(
                        min=1e-30)).max().item(),
                    "max_abs_df": plain.float().abs().max().item(),
                    "same_bits_two_launches": same,
                    "within_tolerance": ok}
            del got, again, plain, absbwd, err, tol
            if sr == 0:
                line["kernel_ms"] = time_ms(lambda: roi_align_bwd_cuda(
                    g, bmain, scale, 50, 84, pooled, sr))
                line["plain_ms"] = time_ms(lambda: roi_align_bwd_plain(
                    g, bmain, scale, 50, 84, pooled, sr), reps=5)
                line["library_ms"] = None  # no single PyTorch call
                nbytes = (g.numel() + 8 * 50 * 84 * 1024) * \
                    g.element_size() + bmain.numel() * 4
                line["bound_ms"], line["bound_by"] = bound_ms(
                    nbytes, roi_align_ops(bmain, scale, pooled, 1024))
                results[("roi_align_bwd", dt)] = line
            emit(line)
            if not ok:
                raise AssertionError(f"roi_align_bwd {dt} sr {sr}: max err "
                                     f"{line['max_abs_err']}")
        del g
        # band edges: heights that are not a multiple of the band rows,
        # with tall thin boxes whose taps straddle band borders
        for hh in (7, 1):
            bx = _band_edge_boxes(gen, 2, 40, hh * 16, img_w)
            ge = torch.randn((2, bx.shape[1], pooled, pooled, 256),
                             generator=gen, device="cuda").to(dtype)
            for sr in (0, 2):
                got = roi_align_bwd_cuda(ge, bx, scale, hh, 84, pooled, sr)
                plain = roi_align_bwd_plain(ge, bx, scale, hh, 84, pooled,
                                            sr)
                absbwd = roi_align_bwd_plain(ge.abs(), bx, scale, hh, 84,
                                             pooled, sr).float()
                err = (got.float() - plain.float()).abs()
                tol = 1e-5 * absbwd
                if dtype == torch.bfloat16:
                    tol = tol + _bf16_ulp(torch.maximum(
                        got.float().abs(), plain.float().abs()))
                ok = bool((err <= tol).all())
                line = {"phase": "kernel_check", "kernel": "roi_align_bwd",
                        "case": f"band_edge_h{hh}", "dtype": dt,
                        "shape": list(ge.shape), "sampling_ratio": sr,
                        "band_rows": _bwd_plan(hh, 84, 256,
                                               dtype)["band_rows"],
                        "max_abs_err": err.max().item(),
                        "max_abs_df": plain.float().abs().max().item(),
                        "within_tolerance": ok}
                emit(line)
                if not ok:
                    raise AssertionError(f"roi_align_bwd band edge {dt} "
                                         f"h {hh} sr {sr}: {line}")
                del got, plain, absbwd, err, tol
            del ge
        # edge boxes (256 channels): against the plain version, and the
        # degenerate and wholly outside ones alone give exactly 0
        edges = _edge_boxes(2, img_h, img_w)
        ge = torch.randn((2, edges.shape[1], pooled, pooled, 256),
                         generator=gen, device="cuda").to(dtype)
        for sr, zero_idx in ((0, [2, 3, 5]), (2, [5])):
            got = roi_align_bwd_cuda(ge, edges, scale, 50, 84, pooled, sr)
            plain = roi_align_bwd_plain(ge, edges, scale, 50, 84, pooled, sr)
            absbwd = roi_align_bwd_plain(ge.abs(), edges, scale, 50, 84,
                                         pooled, sr).float()
            err = (got.float() - plain.float()).abs()
            tol = 1e-5 * absbwd
            if dtype == torch.bfloat16:
                tol = tol + _bf16_ulp(torch.maximum(got.float().abs(),
                                                     plain.float().abs()))
            alone = roi_align_bwd_cuda(ge[:, zero_idx].contiguous(),
                                       edges[:, zero_idx].contiguous(),
                                       scale, 50, 84, pooled, sr)
            zero = bool((alone == 0).all())
            ok = bool((err <= tol).all()) and zero
            line = {"phase": "kernel_check", "kernel": "roi_align_bwd",
                    "case": "edges", "dtype": dt, "sampling_ratio": sr,
                    "max_abs_err": err.max().item(),
                    "zero_boxes": zero_idx, "zero_contribution": zero,
                    "within_tolerance": ok}
            emit(line)
            if not ok:
                raise AssertionError(f"roi_align_bwd edges {dt} sr {sr}: "
                                     f"{line}")
        del ge
    del fmain


def _roi_fwd_within(got, plain, fmax):
    """K2/K3-fwd's tolerance: float32 within 1e-5 * max|F|; bfloat16
    within one bfloat16 ulp of the larger magnitude, or 1e-5 * max|F|
    where that is larger. Returns (ok, max |err|)."""
    import torch
    err = (got.float() - plain.float()).abs()
    tol = torch.full_like(err, 1e-5 * fmax)
    if got.dtype == torch.bfloat16:
        tol = torch.clamp(_bf16_ulp(torch.maximum(
            got.float().abs(), plain.float().abs())), min=1e-5 * fmax)
    return bool((err <= tol).all()), err.max().item()


def _roi_bwd_within(got, plain, absbwd):
    """K3-bwd's tolerance: 1e-5 * (the plain backward of |g|) at each
    cell, plus one bfloat16 ulp in bfloat16. Returns (ok, max |err|)."""
    import torch
    err = (got.float() - plain.float()).abs()
    tol = 1e-5 * absbwd
    if got.dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(torch.maximum(got.float().abs(),
                                             plain.float().abs()))
    return bool((err <= tol).all()), err.max().item()


def check_roi_align_lsm(gen):
    """K3-fwd and K3-bwd at the LSM step's shapes: res4 features [4, 50,
    84, 1024], 200 sampled boxes an image (20 of them gt-sized),
    adaptive sampling, in bfloat16 (the path's dtype) and float32, with
    check_roi_align_train's tolerances."""
    import torch
    from locov_torch.ops.roi_align import (roi_align_batched,
                                           roi_align_bwd_cuda,
                                           roi_align_bwd_plain,
                                           roi_align_cuda)
    from locov_torch.tools.bench_roi_bwd import train_boxes
    scale, pooled, sr = 1.0 / 16, 14, 0
    feats = torch.randn((4, 50, 84, 1024), generator=gen, device="cuda")
    bx = train_boxes(gen, 4, 200, 20, 800, 1344)
    cot = torch.randn((4, 200, pooled, pooled, 1024), generator=gen,
                      device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        f, g = feats.to(dtype), cot.to(dtype)
        got = roi_align_cuda(f, bx, scale, pooled, sr)
        plain = roi_align_batched(f, bx, scale, pooled, sr)
        fwd_ok, fwd_err = _roi_fwd_within(got, plain,
                                          f.float().abs().max().item())
        del got, plain
        got = roi_align_bwd_cuda(g, bx, scale, 50, 84, pooled, sr)
        plain = roi_align_bwd_plain(g, bx, scale, 50, 84, pooled, sr)
        absbwd = roi_align_bwd_plain(g.abs(), bx, scale, 50, 84, pooled,
                                     sr).float()
        bwd_ok, bwd_err = _roi_bwd_within(got, plain, absbwd)
        line = {"phase": "kernel_check", "kernel": "roi_align_fused+bwd",
                "case": "lsm", "dtype": dt, "features": list(f.shape),
                "boxes": list(bx.shape), "sampling_ratio": sr,
                "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
                "within_tolerance": fwd_ok and bwd_ok}
        emit(line)
        if not (fwd_ok and bwd_ok):
            raise AssertionError(f"roi_align at the LSM shapes {dt}: {line}")
        del f, g, got, plain, absbwd
    del feats, cot


# ------------------------------------------------------------------ K4
def _err_stats(err):
    """max and 99.9th percentile of an error tensor (the smallest of its
    top 0.1%)."""
    import torch
    flat = err.flatten()
    k = max(1, flat.numel() // 1000)
    return flat.max().item(), torch.topk(flat, k).values[-1].item()


def check_bottleneck_block(gen, results):
    """K4 against its plain version (the Pallas kernel's rounding
    points). float32: within 1e-5 * max|y| (float32 sums in another
    order). bfloat16, at each element: one bfloat16 ulp of the larger
    magnitude (the output's own rounding) plus 1e-3 * max|y|. t1 and t2
    are each rounded once, and a sum-order difference can flip one of
    those roundings; the next product carries the flip into y as a
    difference of about ulp(t2) * |w3|, a few 1e-3 at these scales. The
    ``zero_ring`` cases set b1 = 3 at small images, so that a t1 halo
    holding relu(b1) instead of 0 would move every border pixel by
    far more than that. Each compared launch writes into a NaN-filled
    output (so an output the kernel skips fails), and two launches must
    give the same bits. The ``main`` lines report the shared memory of a
    block and ptxas's line for each of the kernel's instances."""
    import torch
    from locov_torch.ops import kernel_lib
    from locov_torch.ops.bottleneck_block import (_launch,
                                                  bottleneck_block_cuda,
                                                  bottleneck_block_plain,
                                                  bottleneck_block_ref,
                                                  smem_bytes)
    from locov_torch.tools.bench_block import make_inputs
    from locov_torch.tools.timing import time_ms
    cases = [("main", (4, 200, 336, 256), 64), ("res3", (2, 28, 42, 512), 128),
             ("odd", (2, 13, 19, 256), 64), ("h1", (2, 1, 37, 128), 64),
             ("zero_ring", (2, 6, 9, 128), 64),
             ("zero_ring_h1", (1, 1, 5, 128), 64)]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for case, shape, m in cases:
            args = make_inputs(gen, shape, m, dtype)
            if case.startswith("zero_ring"):
                args = (*args[:2], torch.full_like(args[2], 3.0), *args[3:])
            with torch.no_grad():
                got = _launch(*args, fill=math.nan)
                again = _launch(*args, fill=math.nan)
                same = _same_bits(got, again)
                del again
                got = got.float()
                plain = bottleneck_block_plain(*args).float()
            torch.cuda.synchronize()
            ymax = plain.abs().max().item()
            err = (got - plain).abs()
            if dtype == torch.float32:
                tol = torch.full_like(err, 1e-5 * ymax)
            else:
                ulp = _bf16_ulp(torch.maximum(got.abs(), plain.abs()))
                tol = ulp + 1e-3 * ymax
            err_max, err_999 = _err_stats(err)
            ok = same and bool((err <= tol).all()) and \
                bool(torch.isfinite(got).all())
            line = {"phase": "kernel_check", "kernel": "bottleneck_block",
                    "case": case, "dtype": dt, "shape": list(shape), "m": m,
                    "same_bits_two_launches": same,
                    "max_abs_err": err_max, "p999_abs_err": err_999,
                    "max_abs_y": ymax, "differing_share":
                        (err > 0).float().mean().item(),
                    "max_err_over_tolerance": (err / tol).max().item(),
                    "within_tolerance": ok}
            if dtype == torch.bfloat16:
                line["over_one_bf16_ulp"] = int((err > ulp).sum())
                del ulp
            del got, plain, err, tol
            if case == "main":
                with torch.no_grad():
                    line["kernel_ms"] = time_ms(
                        lambda: bottleneck_block_cuda(*args))
                    line["plain_ms"] = time_ms(
                        lambda: bottleneck_block_plain(*args), reps=10)
                    # cuDNN's three convolutions: not one call
                    line["ref_chain_ms"] = time_ms(
                        lambda: bottleneck_block_ref(*args))
                line["library_ms"] = None
                n, h, w, c = shape
                nbytes = sum(a.numel() * a.element_size() for a in args) + \
                    args[0].numel() * args[0].element_size()
                ops = 2 * n * h * w * (2 * c * m + 9 * m * m)
                line["bound_ms"], line["bound_by"] = bound_ms(
                    nbytes, ops, BF16_TC_OPS_PER_S if dtype == torch.bfloat16
                    else F32_OPS_PER_S)
                line["smem_bytes"] = smem_bytes(dtype, m)
                line["ptxas"] = [
                    ln.strip() for ln in kernel_lib.BUILD_LOG.get(
                        "bottleneck_block", "").splitlines()
                    if "Used" in ln or "spill" in ln]
                results[("bottleneck_block", dt)] = line
            emit(line)
            if not ok:
                raise AssertionError(f"bottleneck_block {case} {dt}: {line}")
            del args


# ------------------------------------------------------------------ K5
def check_stem_conv_bn(gen, results):
    """K5 against its plain version (float32 conv of the bfloat16-rounded
    x and w, + shift, one rounding): within one bfloat16 ulp of the larger
    magnitude, plus 1e-5 * (|x| conv |w| + |shift|), the float32
    sum-order bound of an output close to 0. The backward (the plain
    conv VJP) against autograd of the plain conv at the un-rounded x and
    w.to(x.dtype): within 1e-5 * max, plus one bfloat16 ulp in
    bfloat16. Each compared launch writes into a NaN-filled output (so
    an output the kernel skips fails), and two launches must give the
    same bits."""
    import torch
    from locov_torch.ops.stem_conv_bn import (_conv, _launch, smem_bytes,
                                              stem_conv_bn, stem_conv_bn_cuda,
                                              stem_conv_bn_plain)
    from locov_torch.tools.timing import time_ms
    f = torch.nn.functional
    bf = torch.bfloat16
    cases = [("main", (4, 800, 1344, 3)), ("odd_tiles", (2, 64, 86, 3)),
             ("odd_rows", (1, 38, 70, 3))]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for case, shape in cases:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn((7, 7, 3, 64), generator=gen, device="cuda") * 0.1
            shift = torch.randn((64,), generator=gen, device="cuda")
            got = _launch(x, w, shift, math.nan)
            again = _launch(x, w, shift, math.nan)
            same = torch.equal(got.view(torch.int16), again.view(torch.int16))
            del again
            got = got.float()
            plain = stem_conv_bn_plain(x, w, shift).float()
            sum_order = 1e-5 * (_conv(x.to(bf).float().abs(),
                                      w.to(bf).float().abs()) + shift.abs())
            torch.cuda.synchronize()
            err = (got - plain).abs()
            ulp = _bf16_ulp(torch.maximum(got.abs(), plain.abs()))
            over = err > ulp
            line = {"phase": "kernel_check", "kernel": "stem_conv_bn",
                    "case": case, "dtype": dt, "shape": list(shape),
                    "max_abs_err": err.max().item(),
                    "over_one_bf16_ulp": int(over.sum()),
                    "max_abs_y_over_one_ulp":
                        plain.abs()[over].max().item() if over.any()
                        else None,
                    "same_bits_two_launches": same,
                    "within_tolerance": same and bool(
                        (err <= ulp + sum_order).all())}
            del got, plain, sum_order, err, ulp, over
            if case == "main":
                line["kernel_ms"] = time_ms(
                    lambda: stem_conv_bn_cuda(x, w, shift))
                line["plain_ms"] = time_ms(
                    lambda: stem_conv_bn_plain(x, w, shift), reps=10)
                xl, wl, sl = x.permute(0, 3, 1, 2), \
                    w.to(dtype).permute(3, 2, 0, 1), shift.to(dtype)
                line["library_ms"] = time_ms(
                    lambda: f.conv2d(xl, wl, sl, stride=2, padding=3))
                n, h, wd, _ = shape
                nbytes = x.numel() * x.element_size() + w.numel() * 4 + \
                    shift.numel() * 4 + n * (h // 2) * (wd // 2) * 64 * 2
                line["bound_ms"], line["bound_by"] = bound_ms(
                    nbytes, 2 * 147 * 64 * n * (h // 2) * (wd // 2),
                    BF16_TC_OPS_PER_S)
                line["smem_bytes"] = smem_bytes(dtype)
                results[("stem_conv_bn", dt)] = line
                del xl, wl, sl
            if case == "odd_tiles":
                g = torch.randn((shape[0], shape[1] // 2, shape[2] // 2, 64),
                                generator=gen, device="cuda").to(bf)
                xs, ws, ss = (v.detach().requires_grad_(True)
                              for v in (x, w, shift))
                stem_conv_bn(xs, ws, ss).backward(g)
                xr, wr = (v.detach().requires_grad_(True) for v in (x, w))
                _conv(xr, wr.to(dtype)).backward(g.to(dtype))
                bwd_err = {}
                ok_bwd = True
                for name, a, b in (("dx", xs.grad, xr.grad),
                                   ("dw", ws.grad, wr.grad),
                                   ("dshift", ss.grad,
                                    g.float().sum((0, 1, 2)))):
                    a, b = a.float(), b.float()
                    tol = 1e-5 * b.abs().max()
                    if dtype == bf:
                        tol = tol + _bf16_ulp(torch.maximum(a.abs(), b.abs()))
                    bwd_err[name] = (a - b).abs().max().item()
                    ok_bwd = ok_bwd and bool(((a - b).abs() <= tol).all())
                line["backward_max_abs_err"] = bwd_err
                line["backward_within_tolerance"] = ok_bwd
                line["within_tolerance"] = line["within_tolerance"] and ok_bwd
                del g, xs, ws, ss, xr, wr
            emit(line)
            if not line["within_tolerance"]:
                raise AssertionError(f"stem_conv_bn {case} {dt}: {line}")
            del x, w, shift


def bench_path(name, main_fn, kernel, max_rel_err):
    """One bench entry point at its defaults on the card: launch counts
    zeroed just before and read just after; the kernel must have
    launched, and its output must agree with the library's."""
    from locov_torch.ops import kernel_lib
    kernel_lib.reset_launches()
    line = main_fn([])
    launches = dict(kernel_lib.LAUNCHES)
    emit({"phase": f"{name}_path", "bench": line, "launches": launches})
    if launches[kernel] == 0:
        raise AssertionError(f"{kernel} not launched on the {name} path")
    if not line["max_rel_err"] <= max_rel_err:
        raise AssertionError(f"{name} path: max rel err "
                             f"{line['max_rel_err']} vs the library")
    return launches


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


def small_reference(seed, cfg=None, ce=None, phase="small_reference"):
    """Tiny float32 model (``_tiny_cfg`` or ``cfg``): card (kernels) vs
    CPU (plain versions), on the class embeddings ``ce`` (numpy; by
    default a seeded [6, 8] matrix). The RPN is tamed as in the CPU
    parity tests (zero anchor deltas)."""
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
    if ce is None:
        ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
        ce[-1] = 0.0
    dets = {}
    for dev in ("cpu", "cuda"):
        model = seeded_init_(build_meta_arch(cfg or _tiny_cfg(),
                                             device="cpu"), seed)
        with torch.no_grad():
            model.rpn_head.anchor_deltas.weight.zero_()
        model.to(dev)
        before = dict(kernel_lib.LAUNCHES)
        dets[dev] = model.inference(to_torch(batch, dev),
                                    _tensors(ce, dev))
        launched = {k: kernel_lib.LAUNCHES[k] - before[k]
                    for k in INFERENCE_KERNELS}
    torch.cuda.synchronize()
    cpu, gpu = dets["cpu"], [x.cpu() for x in dets["cuda"]]
    m = cpu.mask.numpy()
    same_mask = bool((gpu[3].numpy() == m).all())
    same_cls = bool((gpu[2].numpy()[m] == cpu.classes.numpy()[m]).all())
    box_err = float(np.abs(gpu[0].numpy()[m] - cpu.boxes.numpy()[m]).max())
    score_err = float(np.abs(gpu[1].numpy() - cpu.scores.numpy()).max())
    line = {"phase": phase, "detections": int(m.sum()),
            "same_mask": same_mask, "same_classes": same_cls,
            "max_box_err_px": box_err, "max_score_err": score_err,
            "gpu_launches": launched}
    emit(line)
    ok = (same_mask and same_cls and m.sum() > 0 and box_err <= 1e-3
          and score_err <= 1e-5 and all(v > 0 for v in launched.values()))
    if not ok:
        raise AssertionError(f"{phase} mismatch: {line}")


def _tiny_train_batch(rng):
    """Two 64 x 64 images (the second padded) with padded gt, numpy."""
    import numpy as np
    from locov_torch.structures.batches import (DetectionBatch, GtBatch,
                                                ImageBatch)
    return DetectionBatch(
        images=ImageBatch(
            image=(rng.rand(2, 64, 64, 3) * 255).astype(np.float32),
            hw=np.array([[64, 64], [48, 56]], np.int32),
            orig_hw=np.array([[128, 128], [96, 112]], np.int32)),
        gt=GtBatch(
            boxes=np.array([[[4, 4, 30, 30], [10, 20, 40, 44]],
                            [[8, 8, 24, 24], [0, 0, 0, 0]]], np.float32),
            classes=np.array([[1, 3], [0, 0]], np.int32),
            mask=np.array([[True, True], [True, False]])))


def small_reference_train(seed):
    """One training step of a tiny float32 OvrRCNN at FREEZE_AT 0 (so
    every kernel runs, K1-bwd included), cuDNN's TF32 allowed in the
    process (the port turns it off for its float32 convolutions), the
    RPN tamed and the samplers' uniform draws fixed: the card (kernels)
    against the CPU (plain versions, which the CPU tests hold against the
    JAX package).
    Compared: the loss dict (|diff| <= 1e-4 * max(1, |loss|)); the
    gradients of the stem conv, a res4 conv, ``rpn_head.conv`` and
    ``bbox_pred`` and every parameter's SGD update (max |diff| <= 1e-3
    * max |CPU value| of each tensor): f32 sums in another order
    through a dozen convolutions."""
    import numpy as np
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_train_step
    from locov_torch.structures.batches import to_torch
    from locov_torch.utils.weights import seeded_init_
    cfg = _tiny_cfg()
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    rng = np.random.RandomState(seed)
    batch = _tiny_train_batch(rng)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    n_anchors, n_props = (64 // 16) ** 2 * 15, 32 + 2
    u = {"rpn": rng.rand(2, 2, n_anchors).astype(np.float32),
         "roi": rng.rand(2, 2, n_props).astype(np.float32)}
    names = ["backbone.stem.conv1.weight", "backbone.res4.0.conv2.weight",
             "rpn_head.conv.weight",
             "roi_heads.box_predictor.bbox_pred.weight"]
    out = {}
    for dev in ("cpu", "cuda"):
        model = seeded_init_(build_meta_arch(cfg, device="cpu"), seed)
        with torch.no_grad():
            model.rpn_head.anchor_deltas.weight.zero_()
        model.to(dev)
        before = {k: v.detach().clone() for k, v in
                  model.named_parameters()}
        step = make_train_step(model, *build_optimizer(cfg, model))
        uniforms = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
                    for k, v in u.items()}
        kernel_lib.reset_launches()
        metrics = step(to_torch(batch, dev), torch.from_numpy(ce).to(dev),
                       None, uniforms)
        launched = {k: kernel_lib.LAUNCHES[k] for k in TRAIN_KERNELS}
        params = dict(model.named_parameters())
        out[dev] = {
            "losses": {k: float(v) for k, v in metrics.items()},
            "grads": {k: params[k].grad.detach().cpu() for k in names},
            "updates": {k: (p.detach() - before[k]).cpu()
                        for k, p in params.items()}}
    torch.cuda.synchronize()
    cpu, gpu = out["cpu"], out["cuda"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    loss_err = {k: abs(gpu["losses"][k] - v) for k, v in
                cpu["losses"].items()}
    grad_err = {k: rel(gpu["grads"][k], v) for k, v in cpu["grads"].items()}
    upd_err = max(rel(gpu["updates"][k], v) for k, v in
                  cpu["updates"].items())
    line = {"phase": "small_reference_train", "freeze_at": 0,
            "losses_cpu": cpu["losses"], "loss_abs_err": loss_err,
            "grad_rel_err": grad_err, "max_update_rel_err": upd_err,
            "gpu_launches": launched}
    emit(line)
    ok = (all(e <= 1e-4 * max(1.0, abs(cpu["losses"][k]))
              for k, e in loss_err.items())
          and all(e <= 1e-3 for e in grad_err.values()) and upd_err <= 1e-3
          and all(v > 0 for v in launched.values()))
    if not ok:
        raise AssertionError(f"small reference train mismatch: {line}")


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
    missing = [k for k in INFERENCE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    profile_run("main_path_profile",
                lambda: model.inference(batch, class_emb), ms)
    return launches


def profile_run(phase, run, unprofiled_ms):
    """``run()`` once under torch.profiler: the device's busy time (the
    sum of its kernels' times) against the wall time, the kernels that
    take the most of it, and for each ``OvrRCNN.<stage>`` and
    ``train_step.<stage>`` range its host time and the device time of
    the kernels launched in it (kernels that autograd launches from its
    own thread belong to no range: ``unattributed_kernels_ms``). The
    profiler stretches the wall time, so the idle share is also given
    against ``unprofiled_ms``, the same run's median time unprofiled.
    Returns the emitted line."""
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
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ranges = [e for e in events
              if e.key.startswith(("OvrRCNN.", LSM_RANGE, "train_step.",
                                   "eval."))]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    stages = {}
    for e in ranges:
        st = stages.setdefault(e.key.split(".", 1)[1], {})
        if e.device_type == DeviceType.CUDA:  # the range on the device
            st["device_span_ms"] = device_us(e) / 1e3
        else:
            st["host_ms"] = e.cpu_time_total / 1e3
            st["device_kernels_ms"] = device_us(e) / 1e3
    attributed = sum(st.get("device_kernels_ms", 0.0)
                     for st in stages.values())
    line = {"phase": phase, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "stages": stages,
            "unattributed_kernels_ms": busy_ms - attributed,
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}
    emit(line)
    if not stages:
        raise AssertionError(f"{phase}: the profile holds no stage range")
    return line


# ----------------------------------------------------------- train path
def _train_batch(rng, b, max_gt=20, num_classes=48):
    """``b`` images as the main path builds them, with synthetic gt: 1 to
    ``max_gt`` boxes an image with sides of 32 to 400 px inside the
    valid 800 x 1312, classes in [0, num_classes), padded to
    ``max_gt`` with a mask."""
    import numpy as np
    from locov_torch.structures.batches import (DetectionBatch, GtBatch,
                                                ImageBatch)
    side = rng.uniform(32, 400, (b, max_gt, 2))
    lo = rng.uniform(0, 1, (b, max_gt, 2)) * (np.array([1312, 800]) - side)
    count = rng.randint(1, max_gt + 1, size=b)
    return DetectionBatch(
        images=ImageBatch(
            image=(rng.rand(b, 800, 1344, 3) * 255).astype(np.float32),
            hw=np.stack([np.full(b, 800), np.full(b, 1312)], 1).astype(
                np.int32),
            orig_hw=np.full((b, 2), 640, np.int32)),
        gt=GtBatch(
            boxes=np.concatenate([lo, lo + side], -1).astype(np.float32),
            classes=rng.randint(0, num_classes, (b, max_gt)).astype(
                np.int32),
            mask=np.arange(max_gt)[None] < count[:, None]))


def _train_model(cfg, seed):
    """The model from ``seed`` at the scale of trained weights
    (``utils/weights.py:trained_scale_``: seeded weights as they are
    make the first loss ~1e10 and the next step NaN), its optimizer and
    its train step."""
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import make_train_step
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    optimizer, scheduler = build_optimizer(cfg, model)
    trainable = {id(p) for g in optimizer.param_groups for p in g["params"]}
    torch.cuda.synchronize()
    return model, make_train_step(model, optimizer, scheduler), trainable


def train_path(seed):
    """The STT training step: ``configs/coco_stt.yaml`` at full width in
    bfloat16 (FREEZE_AT 2: the stem and res2 frozen, K1-bwd not on this
    path), batch 8 of 800 x 1344, one warm-up step and ``TRAIN_STEPS``
    timed ones; launch counts zeroed just before the timed steps and read
    just after. Then one step at FREEZE_AT 0, batch 2, where K1-bwd
    runs. Returns the launches of both runs."""
    import numpy as np
    import torch
    from locov_torch.config import config_path, get_cfg
    from locov_torch.ops import kernel_lib
    from locov_torch.structures.batches import to_torch

    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    t0 = time.perf_counter()
    model, step, trainable = _train_model(cfg, seed)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    b = 8
    nb = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batch = to_torch(_train_batch(rng, b, num_classes=nb), "cuda")
    # class embeddings x0.1: class logits of order 1 (as in the tests)
    class_emb = torch.from_numpy(
        (rng.randn(nb + 1, 768) * 0.1).astype(np.float32)).cuda()
    class_emb[-1] = 0.0  # background row
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())

    t0 = time.perf_counter()
    step(batch, class_emb, gen)  # warm-up (cuDNN plans, caches)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, class_emb, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(kernel_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)

    after = model.state_dict()
    frozen_changed = [k for k, v in before.items()
                      if (k not in params or id(params[k]) not in trainable)
                      and not torch.equal(v, after[k])]
    must_train = ("backbone.res3.", "backbone.res4.", "roi_heads.res5.",
                  "rpn_head.", "roi_heads.box_predictor.bbox_pred.")
    unchanged = [k for k, p in params.items() if k.startswith(must_train)
                 and torch.equal(before[k], p.detach())]
    frozen_names = [k for k in params if id(params[k]) not in trainable]
    finite = all(math.isfinite(v) for d in losses for v in d.values())
    line = {"phase": "train_path", "config": "configs/coco_stt.yaml",
            "dtype": "bfloat16", "batch": b, "image": [800, 1344],
            "freeze_at": cfg.MODEL.BACKBONE.FREEZE_AT, "steps": TRAIN_STEPS,
            "ms_per_step": ms, "ms_per_step_all": times,
            "images_per_s": b / ms * 1e3, "losses": losses,
            "finite": finite, "launches": launches,
            "peak_mem_gib": peak, "model_init_s": init_s,
            "warmup_s": warm_s,
            "gt_boxes": int(batch.gt.mask.sum()),
            "frozen_params": len(frozen_names),
            "frozen_state_changed": frozen_changed,
            "trained_but_unchanged": unchanged}
    emit(line)
    if not finite or frozen_changed or unchanged:
        raise AssertionError(f"train path check failed: {line}")
    missing = [k for k in ("relu_maxpool", "roi_align_fused",
                           "roi_align_bwd") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: "
                             f"{missing}")
    profile_run("train_path_profile",
                lambda: step(batch, class_emb, gen), ms)
    del model, step, before, after, params
    torch.cuda.empty_cache()

    # FREEZE_AT 0: the stem trains, so its backward (K1-bwd) runs
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    model, step, _ = _train_model(cfg, seed)
    small = to_torch(_train_batch(rng, 2, num_classes=nb), "cuda")
    step(small, class_emb, gen)  # warm-up
    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    t0 = time.perf_counter()
    metrics = step(small, class_emb, gen)
    torch.cuda.synchronize()
    ms0 = (time.perf_counter() - t0) * 1e3
    launches0 = dict(kernel_lib.LAUNCHES)
    stem_grad = model.backbone.stem.conv1.weight.grad
    line = {"phase": "train_path_freeze0", "freeze_at": 0, "batch": 2,
            "ms_per_step": ms0,
            "losses": {k: float(v) for k, v in metrics.items()},
            "stem_grad_abs_max": float(stem_grad.abs().max()),
            "launches": launches0}
    emit(line)
    if not (all(math.isfinite(v) for v in line["losses"].values())
            and line["stem_grad_abs_max"] > 0
            and all(launches0[k] > 0 for k in TRAIN_KERNELS)):
        raise AssertionError(f"FREEZE_AT 0 step check failed: {line}")
    del model, step
    torch.cuda.empty_cache()
    return launches, launches0


# ------------------------------------------------------------ LSM path
def _tiny_lsm_cfg():
    """coco_lsm.yaml at tiny widths (as tests/torch_parity.py:TINY_LSM):
    the tiny trunk, a 2-layer BERT of width 16 over a vocabulary of 50,
    dropout off, at most 8 regions an image."""
    from locov_torch.config import config_path, get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    cfg.MODEL.PIXEL_STD = [57.375, 57.12, 58.395]
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP = 8, 32, 8
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 12
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 48
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 24
    cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = 8
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 16
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    for node in (cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG,
                 cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG):
        node.vocab_size, node.hidden_size = 50, 16
        node.num_hidden_layers, node.num_attention_heads = 2, 2
        node.intermediate_size, node.max_position_embeddings = 32, 16
        node.hidden_dropout_prob = node.attention_probs_dropout_prob = 0.0
    return cfg


def _tiny_lsm_batch(rng):
    """Two 96 x 128 images (the second with a 64 x 80 valid part), binary
    gt (padded), captions with padding, special tokens and MLM targets,
    numpy; and a [81, 16] class-embedding matrix x0.1."""
    import numpy as np
    from locov_torch.structures.batches import (DetectionBatch, GtBatch,
                                                ImageBatch, TextBatch)
    ids = rng.randint(5, 50, size=(2, 8)).astype(np.int32)
    attn = np.ones((2, 8), np.int32)
    attn[1, 6:] = 0
    special = np.zeros((2, 8), np.int32)
    special[:, 0] = 1
    special[0, 7] = 1
    special[1, 5:] = 1
    mlm = np.zeros((2, 8), np.int32)
    mlm[0, 3] = mlm[1, 2] = 1
    batch = DetectionBatch(
        images=ImageBatch(
            image=(rng.rand(2, 96, 128, 3) * 255).astype(np.float32),
            hw=np.array([[96, 128], [64, 80]], np.int32),
            orig_hw=np.array([[192, 256], [128, 160]], np.int32)),
        gt=GtBatch(
            boxes=np.array([[[4, 4, 40, 30], [10, 20, 70, 60],
                             [50, 8, 120, 90]],
                            [[8, 8, 24, 24], [30, 10, 70, 50],
                             [0, 0, 0, 0]]], np.float32),
            classes=np.ones((2, 3), np.int32),
            mask=np.array([[True, True, True], [True, True, False]])),
        text=TextBatch(ids, attn, special, ids.copy(), mlm))
    ce = (rng.randn(81, 16) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    return batch, ce


def _tensors(x, dev):
    """numpy arrays -> torch tensors on ``dev``, through dicts and
    tuples."""
    import torch
    if isinstance(x, dict):
        return {k: _tensors(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_tensors(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return torch.from_numpy(x).to(dev)


def _card_against_cpu(cfg, batch, ce, u, names, seed, kernels,
                      tame_rpn=True):
    """One ``make_train_step`` step of the seeded model of ``cfg`` on the
    CPU (plain versions) and on the card (kernels), from the same
    weights, batch, class embeddings ``ce`` and draws ``u`` (numpy):
    the metrics, the gradients of ``names``, every parameter's update,
    and the card's launches of ``kernels``, by device."""
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_train_step
    from locov_torch.structures.batches import to_torch
    from locov_torch.utils.weights import seeded_init_
    out = {}
    for dev in ("cpu", "cuda"):
        model = seeded_init_(build_meta_arch(cfg, device="cpu"), seed)
        if tame_rpn and hasattr(model, "rpn_head"):
            with torch.no_grad():
                model.rpn_head.anchor_deltas.weight.zero_()
        model.to(dev)
        before = {k: v.detach().clone() for k, v in
                  model.named_parameters()}
        step = make_train_step(model, *build_optimizer(cfg, model))
        kernel_lib.reset_launches()
        metrics = step(to_torch(batch, dev), _tensors(ce, dev), None,
                       _tensors(u, dev))
        launched = {k: kernel_lib.LAUNCHES[k] for k in kernels}
        params = dict(model.named_parameters())
        out[dev] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: params[k].grad.detach().cpu() for k in names},
            "updates": {k: (p.detach() - before[k]).cpu()
                        for k, p in params.items()},
            "launched": launched}
    torch.cuda.synchronize()
    return out["cpu"], out["cuda"]


def _held_to_cpu(phase, cpu, gpu, lr, extra=None):
    """The card's step against the CPU's (``_card_against_cpu``): the
    metrics within 1e-4 * max(1, |value|); the gradients within 1e-3 of
    each tensor's largest CPU value; every parameter's update within
    1e-3 of its largest CPU value + 1e-6 * ``lr`` (the float32 rounding
    of order-1 loss terms, where their gradients cancel), and where a
    gradient is zero but for rounding (``ZERO_BY_SHIFT``) |update| <=
    1e-6 on both; every kernel launched. Emits the line; returns
    whether it held."""
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    metric_err = {k: abs(gpu["metrics"][k] - v) for k, v in
                  cpu["metrics"].items()}
    grad_err = {k: rel(gpu["grads"][k], v) for k, v in cpu["grads"].items()}
    floor = 1e-6 * lr
    upd_ratio = {k: float((gpu["updates"][k] - v).abs().max())
                 / (1e-3 * float(v.abs().max()) + floor)
                 for k, v in cpu["updates"].items()
                 if not k.endswith(ZERO_BY_SHIFT)}
    worst = max(upd_ratio, key=upd_ratio.get)
    shift_upd = max([max(float(gpu["updates"][k].abs().max()),
                         float(v.abs().max()))
                     for k, v in cpu["updates"].items()
                     if k.endswith(ZERO_BY_SHIFT)] or [0.0])
    line = {"phase": phase, **(extra or {}),
            "metrics_cpu": cpu["metrics"], "metric_abs_err": metric_err,
            "grad_rel_err": grad_err, "update_floor": floor,
            "worst_update": worst,
            "worst_update_err_over_bound": upd_ratio[worst],
            "worst_update_rel_err": rel(gpu["updates"][worst],
                                        cpu["updates"][worst]),
            "zero_by_shift_max_update": shift_upd,
            "gpu_launches": gpu["launched"]}
    emit(line)
    return (set(gpu["metrics"]) == set(cpu["metrics"])
            and all(e <= 1e-4 * max(1.0, abs(cpu["metrics"][k]))
                    for k, e in metric_err.items())
            and all(e <= 1e-3 for e in grad_err.values())
            and upd_ratio[worst] <= 1.0 and shift_upd <= 1e-6
            and all(v > 0 for v in gpu["launched"].values())), line


def _lsm_tiny_draws(rng):
    """Pinned draws of the tiny LSM step (numpy): the RPN and ROI
    samplers' pairs, the grid and box spatial dropout's keys."""
    import numpy as np
    return {"rpn": tuple(rng.rand(2, 2, 6 * 8 * 15).astype(np.float32)),
            "roi": tuple(rng.rand(2, 2, 24 + 3).astype(np.float32)),
            "grid_drop": rng.rand(2, 3 * 4).astype(np.float32),
            "box_drop": rng.rand(2, 12).astype(np.float32)}


def small_reference_lsm(seed):
    """One training step of a tiny float32 DistillProposalMMSSRCNN
    (FREEZE_AT 0, so every kernel of the LSM path runs), cuDNN's TF32
    allowed in the process, the RPN tamed and every draw pinned (the
    samplers' uniforms and the grid and box dropout keys): the card
    (kernels) against the CPU (plain versions, which the CPU tests hold
    against the JAX package), within ``_held_to_cpu``'s bounds. Compared:
    the loss dict and the MMSS outputs; the gradients of the stem conv,
    a res5 conv, the tied ``v2l_projection``, a joint-encoder layer and
    ``bbox_pred``; every parameter's SGD update."""
    import numpy as np
    cfg = _tiny_lsm_cfg()
    rng = np.random.RandomState(seed)
    batch, ce = _tiny_lsm_batch(rng)
    names = ["backbone.stem.conv1.weight", "roi_heads.res5.2.conv3.weight",
             "mmss_heads.v2l_projection.weight",
             "mmss_heads.transformer_head.encoder.layer_1.output.weight",
             "roi_heads.box_predictor.bbox_pred.weight"]
    cpu, gpu = _card_against_cpu(cfg, batch, ce, _lsm_tiny_draws(rng),
                                 names, seed, LSM_KERNELS)
    ok, line = _held_to_cpu("small_reference_lsm", cpu, gpu,
                            cfg.SOLVER.BASE_LR, {"freeze_at": 0})
    if not (ok and len(cpu["metrics"]) == 19 + 14 + 1):
        raise AssertionError(f"small reference LSM mismatch: {line}")


def _tiny_grounding_draws(rng, gcfg, b=2, w=8, r=8):
    """Pinned draws of the grounding head's random branches for one pass
    of the tiny LSM model (B captions of W tokens, B images of R
    regions), numpy: uniforms over [tiny, 1) for the alignments, indices
    in [0, B - 1) for the negatives."""
    import numpy as np
    tiny = np.finfo(np.float32).tiny
    draws = {}
    if gcfg.ALIGNMENT.startswith("random"):
        draws["align_words"] = np.maximum(
            rng.rand(b, b, w, r), tiny).astype(np.float32)
        draws["align_regions"] = np.maximum(
            rng.rand(b, b, r, w), tiny).astype(np.float32)
    if gcfg.LOSS == "triplet" and gcfg.NEGATIVE_MINING == "random":
        for key in ("neg_words", "neg_regions"):
            draws[key] = tuple(rng.randint(0, b - 1, b).astype(np.int64)
                               for _ in range(2))
    return draws


FAMILY_TINY = {
    # case: (overrides of the tiny LSM config, the kernels it launches)
    "grid": ({"MODEL.META_ARCHITECTURE": "MMSSGridModel",
              "MODEL.MMSS_HEAD.DISTILLATION_LOSS": False},
             ("relu_maxpool", "relu_maxpool_bwd")),
    "distill_grid": ({"MODEL.META_ARCHITECTURE": "DistillMMSSGridModel"},
                     ("relu_maxpool", "relu_maxpool_bwd")),
    "distill_only": ({"MODEL.META_ARCHITECTURE":
                      "DistillOnlyProposalMMSSRCNN"}, LSM_KERNELS),
    "fused": ({"TPU.FUSED_MMSS_PASSES": True}, LSM_KERNELS),
    "mlp_head": ({"MODEL.MMSS_HEAD.TYPES": ("GroundingHead", "MLPHead")},
                 LSM_KERNELS),
    "random_categorical": ({"MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT":
                            "random_categorical"}, LSM_KERNELS),
    "random_top3": ({"MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT": "random_top3"},
                    LSM_KERNELS),
    "triplet_random": ({"MODEL.MMSS_HEAD.GROUNDING.LOSS": "triplet",
                        "MODEL.MMSS_HEAD.GROUNDING.NEGATIVE_MINING":
                        "random"}, LSM_KERNELS),
}
GROUNDING_PREDICTOR = "EmbeddingGroundingFastRCNNOutputLayers"


def _set(cfg, overrides):
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def _tiny_class_tokens(rng, n_classes, dim=8, t_max=4):
    """``ClassTokenEmbeddings`` of ``n_classes`` class names of 1 ..
    ``t_max`` tokens (x0.1) and the background, as numpy."""
    from locov_torch.models.box_emb_grounding import ClassTokenEmbeddings
    ct = ClassTokenEmbeddings.from_ragged(
        [rng.randn(rng.randint(1, t_max + 1), dim) * 0.1
         for _ in range(n_classes)], dim)
    return ClassTokenEmbeddings(ct.tokens.numpy(), ct.mask.numpy())


def small_reference_family(seed):
    """The rest of the model family at tiny width in float32, the card
    (kernels) against the CPU (plain versions, which the CPU tests hold
    against the JAX package), cuDNN's TF32 allowed in the process: one
    training step of each ``FAMILY_TINY`` case of the tiny LSM model
    (the grid models, the box pass alone, the fused passes, the MLP
    head, the grounding head's random branches with their draws pinned)
    within ``_held_to_cpu``'s bounds; then the tiny STT model with the
    grounding box predictor on class names of 1 to 4 tokens: one
    training step at FREEZE_AT 0 likewise, and inference as
    ``small_reference`` holds it."""
    import numpy as np
    failed = []
    for case, (overrides, kernels) in FAMILY_TINY.items():
        cfg = _set(_tiny_lsm_cfg(), overrides)
        rng = np.random.RandomState(seed)
        batch, ce = _tiny_lsm_batch(rng)
        u = _lsm_tiny_draws(rng)
        for key in ("grid_heads", "box_heads"):
            u[key] = _tiny_grounding_draws(rng, cfg.MODEL.MMSS_HEAD.GROUNDING)
        grid = "Grid" in cfg.MODEL.META_ARCHITECTURE
        names = ["backbone.stem.conv1.weight",
                 "backbone.res5.2.conv3.weight" if grid
                 else "roi_heads.res5.2.conv3.weight",
                 "mmss_heads.v2l_projection.weight",
                 "mmss_heads.mlp_head.mlp_in.weight" if case == "mlp_head"
                 else "mmss_heads.transformer_head.encoder.layer_1.output."
                      "weight"]
        cpu, gpu = _card_against_cpu(cfg, batch, ce, u, names, seed,
                                     kernels)
        ok, line = _held_to_cpu("small_reference_family", cpu, gpu,
                                cfg.SOLVER.BASE_LR, {"case": case})
        if not ok:
            failed.append(case)

    cfg = _tiny_cfg()
    cfg.MODEL.ROI_BOX_HEAD.NAME = GROUNDING_PREDICTOR
    cfg.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE = 1.0
    rng = np.random.RandomState(seed)
    small_reference(seed, cfg, _tiny_class_tokens(rng, 5),
                    "small_reference_family_grounding_inference")
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    batch = _tiny_train_batch(rng)
    u = {"rpn": tuple(rng.rand(2, 2, 16 * 15).astype(np.float32)),
         "roi": tuple(rng.rand(2, 2, 32 + 2).astype(np.float32))}
    cpu, gpu = _card_against_cpu(
        cfg, batch, _tiny_class_tokens(rng, 5), u,
        ["backbone.stem.conv1.weight", "roi_heads.res5.2.conv3.weight",
         "roi_heads.box_predictor.emb_pred.weight",
         "roi_heads.box_predictor.bbox_pred.weight"], seed, TRAIN_KERNELS)
    ok, line = _held_to_cpu("small_reference_family", cpu, gpu,
                            cfg.SOLVER.BASE_LR,
                            {"case": "grounding_predictor_step"})
    if not ok:
        failed.append("grounding_predictor_step")
    if failed:
        raise AssertionError(f"small reference family mismatch: {failed}")


def lsm_path(seed):
    """The LSM training step: ``DistillProposalMMSSRCNN`` from
    configs/coco_lsm.yaml at full width in bfloat16, built as the bench
    twin builds it (``locov_torch/tools/bench.py:build_full``: batch 4 of
    800 x 1344, 200 binary gt boxes an image, 70 caption tokens, an [81,
    768] class-embedding matrix, seeded weights at a trained scale),
    through ``build_optimizer`` and ``make_train_step`` with dropout live;
    one warm-up step and ``LSM_STEPS`` timed ones, launch counts zeroed
    just before the timed steps and read just after. Checked: every loss
    and output finite, the frozen state (word embeddings, the unused
    position tables, FrozenBN) unchanged, the trained state changed, and
    every kernel of ``LSM_KERNELS`` launched. Then one step under
    torch.profiler, split by ``DistillProposalMMSSRCNN.<stage>``."""
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_train_step
    from locov_torch.tools.bench import build_full

    t0 = time.perf_counter()
    cfg, model, batch, class_emb = build_full(device="cuda", seed=seed)
    optimizer, scheduler = build_optimizer(cfg, model)
    step = make_train_step(model, optimizer, scheduler)
    trainable = {id(p) for g in optimizer.param_groups for p in g["params"]}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())

    t0 = time.perf_counter()
    step(batch, class_emb, gen)  # warm-up (cuDNN plans, caches)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    times, metrics = [], []
    for _ in range(LSM_STEPS):
        t0 = time.perf_counter()
        m = step(batch, class_emb, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(kernel_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)

    after = model.state_dict()
    frozen_changed = [k for k, v in before.items()
                      if (k not in params or id(params[k]) not in trainable)
                      and not torch.equal(v, after[k])]
    must_train = ("backbone.stem.", "backbone.res2.", "backbone.res4.",
                  "rpn_head.", "roi_heads.res5.",
                  "roi_heads.box_predictor.bbox_pred.",
                  "mmss_heads.v2l_projection.", "mmss_heads.transformer_head.")
    unchanged = [k for k, p in params.items() if k.startswith(must_train)
                 and not k.endswith(ZERO_BY_SHIFT)
                 and torch.equal(before[k], p.detach())]
    frozen_names = sorted(k for k in params if id(params[k]) not in trainable)
    finite = all(math.isfinite(v) for d in metrics for v in d.values())
    line = {"phase": "lsm_path", "config": "configs/coco_lsm.yaml",
            "dtype": "bfloat16", "batch": 4, "image": [800, 1344],
            "gt_boxes_per_image": 200, "text_len": 70,
            "freeze_at": cfg.MODEL.BACKBONE.FREEZE_AT, "steps": LSM_STEPS,
            "ms_per_step": ms, "ms_per_step_all": times,
            "images_per_s": 4 / ms * 1e3, "metrics": metrics,
            "finite": finite, "launches": launches, "peak_mem_gib": peak,
            "model_init_s": init_s, "warmup_s": warm_s,
            "frozen_params": frozen_names,
            "frozen_state_changed": frozen_changed,
            "trained_but_unchanged": unchanged}
    emit(line)
    if not finite or frozen_changed or unchanged or \
            "language_backbone.bert_model.embeddings.word_embeddings" \
            not in frozen_names:
        raise AssertionError(f"LSM path check failed: {line}")
    missing = [k for k in LSM_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the LSM path: "
                             f"{missing}")
    profile_run("lsm_path_profile", lambda: step(batch, class_emb, gen), ms)
    del model, step, before, after, params, optimizer
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ eval path
EVAL_DATASET = "coco_generalized_zeroshot_val"
EVAL_IMAGES = 256
EVAL_AP_KEYS = ("AP", "AP50", "AP50-seen", "AP50-unseen")
EVAL_SPLIT = ("loader_wait", "h2d", "inference", "d2h", "evaluator")


def _eval_reference_cfg(root):
    """The tiny float32 OvrRCNN of ``micro_cfg`` on the micro-COCO tree,
    tamed as tests/test_torch_evaluator.py tames it: the narrow trunk, a
    torchvision-like pixel std, 16 and 32 px anchors, 32 proposals and
    50 detections an image."""
    from locov_torch.data.synthetic import micro_cfg
    cfg = micro_cfg(root)
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP = 8, 32, 8
    cfg.MODEL.PIXEL_STD = [57.375, 57.12, 58.395]
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[16, 32]]
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.TEST.DETECTIONS_PER_IMAGE = 50
    cfg.DATASETS.TEST = ("coco_zeroshot_val",)
    return cfg


def _scale_embeddings(root, factor):
    """Scale the class-embedding file of the micro tree (the CPU tests
    take x0.1, so that the class scores spread)."""
    path = os.path.join(root, "datasets_data", "embeddings",
                        "coco_nouns_bertemb.json")
    with open(path) as f:
        vecs = json.load(f)
    with open(path, "w") as f:
        json.dump({k: [factor * x for x in v] for k, v in vecs.items()}, f)


def _rankings(flat):
    """Per dataset class, the detections' order by score (stable), as
    the evaluator ranks them."""
    import numpy as np
    return {int(c): np.argsort(-flat["score"][flat["cls"] == c],
                               kind="mergesort")
            for c in np.unique(flat["cls"])}


def eval_reference(seed, workdir):
    """``engine/trainer.py:test`` on the micro-COCO tree with a tiny
    float32 OvrRCNN, the same seeded weights on the card (kernels) and
    on the CPU (plain versions, which the CPU tests hold against the JAX
    package). The flat detections (``collect_detections``) agree: image
    and class ids equal, boxes within 1e-3 px, scores within 1e-5; with
    the same per-class rankings (checked), the AP keys agree within 1e-6
    AP points (the CPU tests' bound: the same ranking and the same
    matches give the same numbers)."""
    import numpy as np
    import torch
    from locov_torch.data import MetadataCatalog
    from locov_torch.data.synthetic import make_micro_coco
    from locov_torch.engine.trainer import (build_test_loader,
                                            load_embeddings, test)
    from locov_torch.evaluation.evaluator import (collect_detections,
                                                  dataset_id_lut)
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_eval_step
    from locov_torch.utils.weights import seeded_init_
    root = os.path.join(workdir, "micro")
    make_micro_coco(root, n_val=12)
    _scale_embeddings(root, 0.1)
    cfg = _eval_reference_cfg(root)
    name = cfg.DATASETS.TEST[0]
    flats, res, launched = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = seeded_init_(build_meta_arch(cfg, device="cpu"), seed)
        with torch.no_grad():
            model.rpn_head.anchor_deltas.weight.zero_()
        model.to(dev)
        kernel_lib.reset_launches()
        with build_test_loader(cfg, name, None, False) as loader:
            flats[dev], _ = collect_detections(
                make_eval_step(model), None, loader,
                load_embeddings(cfg, name, dev),
                dataset_id_lut(MetadataCatalog.get(name)))
        res[dev] = test(cfg, model, dev)[name]
        launched[dev] = {k: kernel_lib.LAUNCHES[k] for k in
                         INFERENCE_KERNELS}
    cpu, gpu = flats["cpu"], flats["cuda"]
    same_ids = bool(np.array_equal(cpu["img"], gpu["img"]) and
                    np.array_equal(cpu["cls"], gpu["cls"]))
    box_err = float(np.abs(cpu["box"] - gpu["box"]).max()) if same_ids \
        else float("inf")
    score_err = float(np.abs(cpu["score"] - gpu["score"]).max()) \
        if same_ids else float("inf")
    rank_c, rank_g = _rankings(cpu), _rankings(gpu)
    same_rank = same_ids and all(np.array_equal(rank_c[c], rank_g[c])
                                 for c in rank_c)
    ap_err = {k: abs(res["cuda"][k] - res["cpu"][k]) for k in EVAL_AP_KEYS}
    line = {"phase": "eval_reference", "dataset": name,
            "images": 12, "detections": int(len(cpu["img"])),
            "same_ids": same_ids, "same_rankings": same_rank,
            "max_box_err_px": box_err, "max_score_err": score_err,
            "ap_cpu": {k: res["cpu"][k] for k in EVAL_AP_KEYS},
            "ap_abs_err": ap_err, "gpu_launches": launched["cuda"],
            "cpu_launches": launched["cpu"]}
    emit(line)
    ok = (same_ids and len(cpu["img"]) > 300 and box_err <= 1e-3 and
          score_err <= 1e-5 and same_rank and
          all(e <= 1e-6 for e in ap_err.values()) and
          res["cpu"]["AP50"] > 0 and
          all(v > 0 for v in launched["cuda"].values()) and
          not any(launched["cpu"].values()))
    if not ok:
        raise AssertionError(f"eval reference mismatch: {line}")


def _synthetic_images(rng, n_images, img_dir, cats, first_id=1):
    """``n_images`` JPEGs (quality 90) under ``img_dir`` in COCO's sizes
    and mix: three landscape 640 x 480 to one portrait 480 x 640, every
    64th square 640 x 640; 1-20 boxes an image over ``cats``, drawn into
    the image over a smooth background; one caption an image. Returns
    (images, annotations, captions, (path, RGB array) of the first
    portrait image)."""
    import numpy as np
    from PIL import Image
    images, anns, caps, probe = [], [], [], None
    for i in range(n_images):
        image_id = first_id + i
        h, w = ((640, 640) if i % 64 == 63 else
                (640, 480) if i % 4 == 3 else (480, 640))
        coarse = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
        img = np.array(Image.fromarray(coarse).resize((w, h),
                                                      Image.BILINEAR))
        for _ in range(rng.randint(1, 21)):
            bw, bh = rng.uniform(16, w / 2), rng.uniform(16, h / 2)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            cat = cats[rng.randint(len(cats))]
            img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = \
                rng.randint(0, 256, 3)
            anns.append({"id": len(anns) + 1,
                         "image_id": image_id, "category_id": cat["id"],
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
        fname = f"{image_id:012d}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, fname), quality=90)
        images.append({"id": image_id, "file_name": fname, "height": h,
                       "width": w})
        caps.append({"id": image_id, "image_id": image_id,
                     "caption": f"a photo of a {cat['name']}"})
        if probe is None and h > w:
            probe = (os.path.join(img_dir, fname), img)
    return images, anns, caps, probe


def _coco_categories(all_80=False):
    """The 65 classes of the zero-shot split (48 seen, 17 unseen, COCO
    ids), or all 80 of COCO's ids (the other 15 named by their id)."""
    from locov_torch.data.datasets.coco import (categories_seen,
                                                categories_unseen)
    cats = categories_seen + categories_unseen
    if all_80:
        known = {c["id"] for c in cats}
        cats = cats + [{"id": i, "name": f"class{i}"} for i in range(1, 91)
                       if i not in known | {12, 26, 29, 30, 45, 66, 68,
                                            69, 71, 83}]
    return sorted(cats, key=lambda c: c["id"])


def write_coco_val(root, seed, n_images=EVAL_IMAGES):
    """A synthetic ``coco_generalized_zeroshot_val`` tree under ``root``
    in COCO's layout, every file its registration opens: the JPEGs of
    ``_synthetic_images`` over the 65 classes of the zero-shot split (48
    seen, 17 unseen, COCO ids), so that all three test buckets run;
    768-d class embeddings. Returns the path and RGB array of the first
    portrait image, for the decode check."""
    import numpy as np
    from locov_torch.data.datasets.coco import (COCO_DATASETS,
                                                DEFAULT_EMBEDDINGS)
    rng = np.random.RandomState(seed)
    paths = {k: os.path.join(root, v)
             for k, v in COCO_DATASETS[EVAL_DATASET].items()}
    for p in (paths["img_dir"], os.path.dirname(paths["ann_file"]),
              os.path.dirname(paths["cap_file"]),
              os.path.dirname(os.path.join(root, DEFAULT_EMBEDDINGS))):
        os.makedirs(p, exist_ok=True)
    cats = _coco_categories()
    images, anns, caps, probe = _synthetic_images(
        rng, n_images, paths["img_dir"], cats)
    with open(paths["ann_file"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    with open(paths["cap_file"], "w") as f:
        json.dump({"images": images, "annotations": caps}, f)
    with open(os.path.join(root, DEFAULT_EMBEDDINGS), "w") as f:
        json.dump({c["name"]: rng.randn(768).tolist() for c in cats}, f)
    return probe


def eval_path(seed, workdir):
    """STT evaluation at full width: ``engine/trainer.py:test`` with
    configs/coco_stt.yaml in bfloat16 (seeded weights), TEST.IMS_PER_BATCH
    8, on ``write_coco_val``'s tree through the real loader (4 mapping
    threads decode and resize). First the decode check (the mapper puts
    zeros where an image fails to decode) and one pass of the loader
    alone (the buckets and padded rows it gives); then the timed
    evaluation, launch counts zeroed just before it and read just after:
    K1-fwd and K2 each once a batch; the gt-oracle (the gt boxes as
    detections, score 1, dataset ids) must read AP 100; then one batch
    under torch.profiler."""
    import numpy as np
    import torch
    from locov_torch.config import config_path, get_cfg
    from locov_torch.data import DatasetCatalog, MetadataCatalog
    from locov_torch.data.mappers import read_image
    from locov_torch.engine.trainer import (build_test_loader,
                                            load_embeddings, test)
    from locov_torch.evaluation.evaluator import (add_seen_unseen_summary,
                                                  build_evaluator_for,
                                                  collect_detections,
                                                  dataset_id_lut,
                                                  score_detections)
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_eval_step
    from locov_torch.tools.timing import nvidia_smi_line
    from locov_torch.utils.weights import seeded_init_
    root = os.path.join(workdir, "coco")
    t0 = time.perf_counter()
    probe_path, probe = write_coco_val(root, seed)
    write_s = time.perf_counter() - t0
    decoded = read_image(probe_path)[:, :, ::-1]  # BGR -> RGB
    decode_err = float(np.abs(decoded.astype(np.float32) - probe).mean()) \
        if decoded.shape == probe.shape else float("inf")
    emit({"phase": "eval_decode_check", "image": probe.shape[:2],
          "decoded": decoded.shape[:2], "mean_abs_err": decode_err,
          "write_s": write_s})
    # JPEG at quality 90 of a smooth image: ~1 a pixel; zeros: ~100
    if not decode_err <= 3.0:
        raise AssertionError(f"decoded image differs from the written "
                             f"one: mean |err| {decode_err}")

    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.DATASETS.ROOT = root
    cfg.DATASETS.TEST = (EVAL_DATASET,)
    cfg.TEST.IMS_PER_BATCH = 8
    shapes, pads, probe_batch = {}, 0, None
    with build_test_loader(cfg, EVAL_DATASET, None, False) as loader:
        for batch in loader:
            key = "x".join(map(str, batch.images.image.shape[1:3]))
            shapes[key] = shapes.get(key, 0) + 1
            pads += int((batch.images.image_id < 0).sum())
            if batch.images.image.shape[1] > batch.images.image.shape[2]:
                probe_batch = batch  # a portrait batch, for the profile
    n_batches = sum(shapes.values())

    t0 = time.perf_counter()
    model = seeded_init_(build_meta_arch(cfg), seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    t0 = time.perf_counter()
    res = test(cfg, model, "cuda")[EVAL_DATASET]
    wall_s = time.perf_counter() - t0
    launches = dict(kernel_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the gt oracle: the gt boxes as detections
    meta = MetadataCatalog.get(EVAL_DATASET)
    inv = dataset_id_lut(meta)
    gt = [(r["image_id"], a["bbox"], inv[a["category_id"]])
          for r in DatasetCatalog.get(EVAL_DATASET) for a in r["annotations"]]
    flat = {"img": np.asarray([g[0] for g in gt], np.int64),
            "box": np.asarray([g[1] for g in gt], np.float64),
            "score": np.ones(len(gt)),
            "cls": np.asarray([g[2] for g in gt], np.int64)}
    evaluator = build_evaluator_for(EVAL_DATASET)
    score_detections(evaluator, flat)
    oracle = add_seen_unseen_summary(
        evaluator.summarize(per_category=True), meta)
    oracle = {k: oracle[k] for k in ("AP", "AP50", "AP50-seen",
                                     "AP50-unseen")}

    split = {k: res[f"seconds_{k}"] for k in EVAL_SPLIT}
    line = {"phase": "eval_path", "config": "configs/coco_stt.yaml",
            "dtype": "bfloat16", "dataset": EVAL_DATASET,
            "images": len(DatasetCatalog.get(EVAL_DATASET)),
            "batch": cfg.TEST.IMS_PER_BATCH,
            "workers": cfg.DATALOADER.NUM_WORKERS,
            "ap": {k: res.get(k) for k in EVAL_AP_KEYS},
            "images_per_second": res["images_per_second"],
            "seconds": split, "seconds_total": res["seconds_total"],
            "wall_s": wall_s,
            "ms_per_batch": {k: v / n_batches * 1e3
                             for k, v in split.items()
                             if k != "evaluator"},
            "buckets": shapes, "batches": n_batches,
            "padded_rows_dropped": pads, "gt_boxes": len(gt),
            "launches": launches, "peak_mem_gib": peak,
            "model_init_s": init_s, "oracle": oracle,
            "nvidia_smi": nvidia_smi_line()}
    emit(line)
    finite = all(np.isfinite(res[k]) and 0 <= res[k] <= 100
                 for k in EVAL_AP_KEYS)
    if not (finite and len(shapes) == 3 and pads > 0):
        raise AssertionError(f"eval path output check failed: {line}")
    if not all(launches[k] == n_batches for k in INFERENCE_KERNELS):
        raise AssertionError(f"eval path: {INFERENCE_KERNELS} must launch "
                             f"once a batch ({n_batches}): {launches}")
    if not all(abs(v - 100.0) <= 1e-9 for v in oracle.values()):
        raise AssertionError(f"eval path: the gt oracle reads {oracle}")

    step = make_eval_step(model)
    ce = load_embeddings(cfg, EVAL_DATASET, "cuda")

    def one_batch():
        return collect_detections(step, None, [probe_batch], ce, inv)
    one_batch()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_batch()
        times.append((time.perf_counter() - t0) * 1e3)
    profile_run("eval_path_profile", one_batch, statistics.median(times))
    del model, step
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- trainer path
TRAINER_TRAIN_IMAGES = 64
TRAINER_VAL_IMAGES = 24
OLN_PROPOSALS = 200  # OLN-style proposals an image (the LSM's binary gt)
LSM_MAX_ITER, LSM_RESUME_ITER, STT_MAX_ITER = 6, 8, 4


def write_coco_trainval(root, seed, n_train=TRAINER_TRAIN_IMAGES,
                        n_val=TRAINER_VAL_IMAGES):
    """The splits the two stage configs read, under ``root`` in COCO's
    layout: train2017 and val2017 JPEGs (``_synthetic_images``: COCO's
    sizes and mix over the 65 classes of the zero-shot split), with
    captions; ``instances_*2017.json`` over COCO's 80 classes
    (``coco_captions_*``: coco_lsm.yaml's NUM_CLASSES 80),
    ``instances_train2017_seen_2.json`` (the 48 seen classes:
    ``coco_zeroshot_train``) and ``instances_val2017_all_2.json`` (all
    65: ``coco_generalized_zeroshot_val``); OLN-style proposal pickles
    (``OLN_PROPOSALS`` boxes an image with objectness 0.5-1:
    ``coco_captions_train_seen_proposals``); 768-d class embeddings x0.1
    (random-init scores otherwise sit on one class); a WordPiece vocab
    of the caption words."""
    import pickle
    import numpy as np
    from locov_torch.data.datasets.coco import (DEFAULT_EMBEDDINGS,
                                                categories_seen)
    from locov_torch.data.tokenization import build_tiny_vocab
    rng = np.random.RandomState(seed)
    dd = os.path.join(root, "datasets_data")
    dirs = {k: os.path.join(dd, v) for k, v in (
        ("train", "coco/train2017"), ("val", "coco/val2017"),
        ("ann", "coco/annotations"), ("zs", "zero-shot/coco"),
        ("prop", "proposals"), ("emb", "embeddings"), ("bert", "bert"))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cats, all_80 = _coco_categories(), _coco_categories(all_80=True)
    seen = {c["id"] for c in categories_seen}
    splits = {}
    for split, n, first in (("train", n_train, 1), ("val", n_val, 100001)):
        images, anns, caps, _ = _synthetic_images(rng, n, dirs[split], cats,
                                                  first)
        splits[split] = (images, anns)
        with open(os.path.join(dirs["ann"], f"instances_{split}2017.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": all_80}, f)
        with open(os.path.join(dirs["ann"], f"captions_{split}2017.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": caps}, f)
    images, anns = splits["train"]
    with open(os.path.join(dirs["zs"], "instances_train2017_seen_2.json"),
              "w") as f:
        json.dump({"images": images,
                   "annotations": [a for a in anns
                                   if a["category_id"] in seen],
                   "categories": [c for c in cats if c["id"] in seen]}, f)
    images, anns = splits["val"]
    with open(os.path.join(dirs["zs"], "instances_val2017_all_2.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    props = []
    for im in splits["train"][0]:
        w, h = im["width"], im["height"]
        x0 = rng.uniform(0, w - 32, OLN_PROPOSALS)
        y0 = rng.uniform(0, h - 32, OLN_PROPOSALS)
        x1 = np.minimum(x0 + rng.uniform(16, w / 2, OLN_PROPOSALS), w)
        y1 = np.minimum(y0 + rng.uniform(16, h / 2, OLN_PROPOSALS), h)
        props.append((im["id"], np.stack(
            [x0, y0, x1, y1, rng.uniform(0.5, 1.0, OLN_PROPOSALS)],
            1).astype(np.float32)))
    with open(os.path.join(dirs["prop"], "coco_train2017_seen.pkl"),
              "wb") as f:
        pickle.dump(props, f)
    with open(os.path.join(root, DEFAULT_EMBEDDINGS), "w") as f:
        json.dump({c["name"]: (0.1 * rng.randn(768)).tolist()
                   for c in all_80}, f)
    words = sorted({w for c in all_80 for w in c["name"].split()})
    vocab = build_tiny_vocab(words + ["a", "photo", "of"])
    with open(os.path.join(dirs["bert"], "vocab.txt"), "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")


def seed_checkpoint(workdir, seed):
    """The path of a port checkpoint (``workdir/seed/model_seed``) of
    the configs/coco_lsm.yaml model's seeded weights at a trained
    scale, written on the first call."""
    import torch
    from locov_torch.config import config_path, get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.utils.checkpoint import Checkpointer
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    ck = Checkpointer(os.path.join(workdir, "seed"), use_async=False)
    path = os.path.join(workdir, "seed", "model_seed")
    if not os.path.exists(path):
        cfg = get_cfg()
        cfg.merge_from_file(config_path("coco_lsm.yaml"))
        model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
        path = ck.save_named("model_seed", {"model": model.state_dict()})
        del model
        torch.cuda.empty_cache()
    return path


class _TrainWatch:
    """Wraps ``OVRTrainer.train`` while ``train_ovnet.main`` runs: keeps
    each trainer, its start iteration, the rows its ``metrics.json``
    held already and the seconds of ``train``, and calls
    ``check(trainer)`` first, before the first step."""

    def __init__(self, check=None):
        self.check, self.runs = check, []

    def __enter__(self):
        from locov_torch.engine.trainer import OVRTrainer
        self._orig = orig = OVRTrainer.train
        watch = self

        def train(trainer):
            path = os.path.join(trainer.cfg.OUTPUT_DIR, "metrics.json")
            run = {"trainer": trainer, "start_iter": trainer.start_iter,
                   "rows_before": sum(1 for _ in open(path))
                   if os.path.exists(path) else 0,
                   "checked": watch.check(trainer) if watch.check else None}
            watch.runs.append(run)
            t0 = time.perf_counter()
            try:
                return orig(trainer)
            finally:
                run["train_s"] = time.perf_counter() - t0
        OVRTrainer.train = train
        return self

    def __exit__(self, *exc):
        from locov_torch.engine.trainer import OVRTrainer
        OVRTrainer.train = self._orig


def _run_cli(flags, opts, log, check=None):
    """``locov_torch.train_ovnet.main`` on ``flags`` and ``opts``, its
    prints to ``log``. Returns (results, the trained run's record of
    ``_TrainWatch``, seconds, peak GiB)."""
    import contextlib
    import torch
    from locov_torch import train_ovnet
    from locov_torch.data import DatasetCatalog, MetadataCatalog
    for name in list(DatasetCatalog._registry):
        DatasetCatalog.remove(name)
    for name in list(MetadataCatalog._store):
        MetadataCatalog.remove(name)
    args = train_ovnet.default_argument_parser().parse_args(flags + opts)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _TrainWatch(check) as watch, open(log, "a") as f, \
            contextlib.redirect_stdout(f):
        results = train_ovnet.main(args)
    torch.cuda.synchronize()
    return (results, watch.runs[0], time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def same_as_checkpoint(trainer):
    """Before the first resumed step: the model, the momentum buffers
    and, under gradient accumulation, the accumulated gradients and the
    micro-step count against the checkpoint it resumed from, bit for
    bit."""
    import torch
    state = trainer.checkpointer.load(trainer.checkpointer.last_checkpoint())
    sd = trainer.model.state_dict()
    model_eq = set(sd) == set(state["model"]) and all(
        torch.equal(sd[k].cpu(), v) for k, v in state["model"].items())
    opt = trainer.optimizer.state_dict()
    mom = state["optimizer"]["state"]
    mom_eq = set(opt["state"]) == set(mom) and all(
        torch.equal(opt["state"][i]["momentum_buffer"].cpu(),
                    m["momentum_buffer"]) for i, m in mom.items())
    out = {"model": model_eq, "momentum": mom_eq,
           "momentum_buffers": len(mom),
           "scheduler_step": trainer.scheduler.last_epoch}
    saved = state["optimizer"].get("multi_steps")
    if saved is not None:
        ms = opt["multi_steps"]
        out.update(mini_step=ms["mini_step"],
                   accumulation=ms["mini_step"] == saved["mini_step"] and
                   len(ms["acc_grads"]) == len(saved["acc_grads"]) and
                   all(torch.equal(a.cpu(), b) for a, b in
                       zip(ms["acc_grads"], saved["acc_grads"])))
    return out


def _loop_numbers(run, batch):
    """The loop's images/s after the warm-up step, by the median of
    ``time`` and by all the images over all the time (the steps that
    take about twice the median count in the second), and ``data_time``
    from metrics.json, the checkpoints' seconds and bytes, and the
    rows."""
    tr = run["trainer"]
    rows = [json.loads(ln) for ln in open(os.path.join(
        tr.cfg.OUTPUT_DIR, "metrics.json"))]
    mine = rows[run["rows_before"]:]
    times = [r["time"] for r in mine[1:]]
    return {"rows": [r["iteration"] for r in mine],
            "ms_per_step": [r["time"] * 1e3 for r in mine],
            "data_ms": [r["data_time"] * 1e3 for r in mine],
            "images_per_s": batch / statistics.median(times),
            "images_per_s_all": batch * len(times) / sum(times),
            "data_ms_median": statistics.median(
                r["data_time"] for r in mine[1:]) * 1e3,
            "checkpoints": tr.checkpointer.saves,
            "train_s": run["train_s"]}, mine


def trainer_path(seed, workdir):
    """Both LocOV stages through the CLI twin (``locov_torch.train_ovnet.
    main``) on the card at full configs/coco_lsm.yaml and coco_stt.yaml
    width in bfloat16, on ``write_coco_trainval``'s tree: LSM from a
    port checkpoint of seeded weights at a trained scale (the same
    model: no rename), ``LSM_MAX_ITER`` steps at batch 4, a checkpoint
    every two (pruned to two), the loss-and-detection evaluation of
    ``coco_captions_val``; the same command with ``--resume`` to
    ``LSM_RESUME_ITER`` (the start iteration and, before the first step,
    the model and the momentum buffers equal to the checkpoint's); STT
    from the LSM's ``model_final`` through the rename map (res5 and the
    projection equal to the LSM's, nothing mismatched), ``STT_MAX_ITER``
    steps at batch 8, the evaluation of ``coco_generalized_zeroshot_val``
    (AP50-seen and -unseen). The training buckets are derived from the
    configs' sizes (``TPU.IMAGE_BUCKETS ()``): the default buckets stop
    at 1024, which an 800 x 1067 image does not fit. Launch counts are
    zeroed before the LSM stage and read after each stage (each stage's
    line gives its own); over the path K1-fwd, K1-bwd, K2 (K3-fwd) and
    K3-bwd must each launch."""
    import math
    import torch
    from locov_torch.config import config_path
    from locov_torch.ops import kernel_lib
    from locov_torch.tools.timing import nvidia_smi_line
    root = os.path.join(workdir, "coco")
    log = os.path.join(workdir, "trainer.log")
    t0 = time.perf_counter()
    write_coco_trainval(root, seed)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seed_path = seed_checkpoint(workdir, seed)
    seed_s = time.perf_counter() - t0

    common = ["DATASETS.ROOT", root, "TPU.IMAGE_BUCKETS", "()",
              "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.LOG_PERIOD", "1",
              "TEST.EVAL_PERIOD", "0"]
    lsm_flags = ["--config-file", config_path("coco_lsm.yaml")]
    lsm_opts = common + [
        "MODEL.WEIGHTS", seed_path, "SOLVER.IMS_PER_BATCH", "4",
        "DATASETS.TEST", "('coco_captions_val',)",
        "OUTPUT_DIR", os.path.join(workdir, "lsm")]
    kernel_lib.reset_launches()
    lsm_res, lsm_run, lsm_s, lsm_peak = _run_cli(
        lsm_flags, lsm_opts + ["SOLVER.MAX_ITER", str(LSM_MAX_ITER)], log)
    lsm_launches = dict(kernel_lib.LAUNCHES)
    lsm_tr = lsm_run["trainer"]
    out = lsm_tr.cfg.OUTPUT_DIR
    files = sorted(n for n in os.listdir(out)
                   if n.startswith(("model_", "last_")))
    loop, rows = _loop_numbers(lsm_run, 4)
    res = lsm_res["coco_captions_val"]
    res_keys = ("Total Loss", "CE_loss (Align Words, Choose Caption)",
                "Masked Language Modeling Loss", "AP50")
    finite = all(math.isfinite(v) for r in rows for k, v in r.items()
                 if "loss" in k.lower())
    line = {"phase": "trainer_lsm", "config": "configs/coco_lsm.yaml",
            "dtype": lsm_tr.cfg.TPU.COMPUTE_DTYPE, "batch": 4,
            "max_iter": LSM_MAX_ITER, "files": files, **loop,
            "finite_losses": finite,
            "results": {k: res.get(k) for k in res_keys},
            "eval_images_per_second": res.get("images_per_second"),
            "buckets": [list(b) for b in lsm_tr.train_loader.buckets],
            "seconds": lsm_s, "peak_mem_gib": lsm_peak,
            "launches": lsm_launches, "tree_write_s": write_s,
            "seed_checkpoint_s": seed_s, "nvidia_smi": nvidia_smi_line()}
    emit(line)
    want_files = ["last_checkpoint", "model_0000003", "model_0000005",
                  "model_final"]
    if not (finite and files == want_files and
            loop["rows"] == list(range(LSM_MAX_ITER)) and
            all(k in res and math.isfinite(res[k]) for k in res_keys) and
            open(os.path.join(out, "last_checkpoint")).read() ==
            "model_0000005"):
        raise AssertionError(f"trainer LSM stage check failed: {line}")

    res2, run2, res2_s, res2_peak = _run_cli(
        lsm_flags + ["--resume"],
        lsm_opts + ["SOLVER.MAX_ITER", str(LSM_RESUME_ITER)], log,
        same_as_checkpoint)
    after_resume = dict(kernel_lib.LAUNCHES)
    loop2, rows2 = _loop_numbers(run2, 4)
    line = {"phase": "trainer_lsm_resume", "start_iter": run2["start_iter"],
            "checked": run2["checked"], "rows": loop2["rows"],
            "ms_per_step": loop2["ms_per_step"],
            "total_loss": [r.get("total_loss") for r in rows2],
            "results": {k: res2["coco_captions_val"].get(k)
                        for k in res_keys},
            "seconds": res2_s, "peak_mem_gib": res2_peak,
            "launches": {k: v - lsm_launches[k]
                         for k, v in after_resume.items()}}
    emit(line)
    if not (run2["start_iter"] == LSM_MAX_ITER and
            run2["checked"]["model"] and run2["checked"]["momentum"] and
            run2["checked"]["momentum_buffers"] > 100 and
            run2["checked"]["scheduler_step"] == LSM_MAX_ITER and
            loop2["rows"] == list(range(LSM_MAX_ITER, LSM_RESUME_ITER))):
        raise AssertionError(f"trainer resume check failed: {line}")

    lsm_final = os.path.join(out, "model_final")

    def handed_over(trainer):
        """Before the first STT step: res5 and emb_pred against the LSM's
        roi_heads.res5 and v2l projection, bit for bit."""
        lsm = torch.load(lsm_final, map_location="cpu",
                         weights_only=True)["model"]
        sd = trainer.model.state_dict()
        res5 = [k for k in lsm if k.startswith("roi_heads.res5.")]
        rep = trainer.last_import_report
        return {
            "res5_equal": len(res5) > 40 and all(
                torch.equal(sd[k].cpu(), lsm[k]) for k in res5),
            "emb_pred_equal": all(torch.equal(
                sd[f"roi_heads.box_predictor.emb_pred.{leaf}"].cpu(),
                lsm[f"mmss_heads.v2l_projection.{leaf}"])
                for leaf in ("weight", "bias")),
            "backbone_res5_in_model": any(k.startswith("backbone.res5")
                                          for k in sd),
            "loaded": len(rep.loaded), "missing": len(rep.missing),
            "mismatched": rep.mismatched,
            "unused_src": len(rep.unused_src)}

    stt_res, stt_run, stt_s, stt_peak = _run_cli(
        ["--config-file", config_path("coco_stt.yaml")],
        common + ["MODEL.WEIGHTS", lsm_final, "SOLVER.IMS_PER_BATCH", "8",
                  "SOLVER.MAX_ITER", str(STT_MAX_ITER),
                  "TEST.EVAL_INIT", "False",
                  "DATASETS.TEST", "('coco_generalized_zeroshot_val',)",
                  "OUTPUT_DIR", os.path.join(workdir, "stt")], log,
        handed_over)
    launches = dict(kernel_lib.LAUNCHES)
    stt_launches = {k: v - after_resume[k] for k, v in launches.items()}
    loop3, rows3 = _loop_numbers(stt_run, 8)
    res3 = stt_res["coco_generalized_zeroshot_val"]
    ap_keys = ("AP", "AP50", "AP50-seen", "AP50-unseen")
    finite3 = all(math.isfinite(v) for r in rows3 for k, v in r.items()
                  if "loss" in k.lower())
    line = {"phase": "trainer_stt", "config": "configs/coco_stt.yaml",
            "dtype": stt_run["trainer"].cfg.TPU.COMPUTE_DTYPE, "batch": 8,
            "max_iter": STT_MAX_ITER, "handoff": stt_run["checked"],
            **loop3, "finite_losses": finite3,
            "results": {k: res3.get(k) for k in ap_keys},
            "eval_images_per_second": res3.get("images_per_second"),
            "seconds": stt_s, "peak_mem_gib": stt_peak,
            "launches": stt_launches, "nvidia_smi": nvidia_smi_line()}
    emit(line)
    h = stt_run["checked"]
    if not (finite3 and h["res5_equal"] and h["emb_pred_equal"] and
            not h["backbone_res5_in_model"] and h["mismatched"] == [] and
            loop3["rows"] == list(range(STT_MAX_ITER)) and
            all(k in res3 and math.isfinite(res3[k]) for k in ap_keys)):
        raise AssertionError(f"trainer STT stage check failed: {line}")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the trainer path: "
                             f"{missing}")
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- scale path
ACCUM_K, ACCUM_ITER, ACCUM_PERIOD = 8, 16, 12  # coco_lsm.yaml as 4 x 8
GLOBAL_BATCH, GLOBAL_ITER = 32, 3  # coco_lsm_global.yaml on one card
VARIANT_BATCH, VARIANT_CHUNK = 8, 16  # 64 pairs a pass in 4 chunks
VARIANT_RUNS = 3  # timed steps a variant, after one warm-up
# the largest difference of a gradient from the plain variant's, over
# the largest |gradient| of that tensor: bfloat16 products of other
# shapes (the chunks) and cuDNN's choices on the recompute (remat)
VARIANT_GRAD_TOL = 5e-2
DP_WORLD, DP_PER_RANK, DP_LR = 2, 2, 0.01
# two ranks against one, float32: each tensor's update within 1e-3 of
# its largest reference update plus 2 spacings of its largest
# parameter; the losses within rtol 1e-4
DP_UPDATE_RTOL, DP_LOSS_RTOL = 1e-3, 1e-4


class _StepWatch:
    """Wraps ``trainer.train_step``: per step, whether it changed the
    trainable parameters and whether it changed the momentum buffers,
    bit for bit."""

    def __init__(self, trainer):
        import torch
        self.params = [p for g in trainer.optimizer.param_groups
                       for p in g["params"]]
        self.state = trainer.optimizer.state
        self.moved, self.momentum_moved = [], []
        inner = trainer.train_step

        def step(*a, **k):
            p0, m0 = self._snapshot()
            out = inner(*a, **k)
            p1, m1 = self._snapshot()
            self.moved.append(not torch.equal(p0, p1))
            self.momentum_moved.append(
                (m0 is None) != (m1 is None) or
                (m0 is not None and not torch.equal(m0, m1)))
            return out
        trainer.train_step = step

    def _snapshot(self):
        import torch
        params = torch.cat([p.detach().reshape(-1) for p in self.params])
        bufs = [self.state[p]["momentum_buffer"].reshape(-1)
                for p in self.params if p in self.state]
        return params, torch.cat(bufs) if bufs else None


def _scale_opts(root, seed_path, out, batch, max_iter, period):
    return ["DATASETS.ROOT", root, "TPU.IMAGE_BUCKETS", "()",
            "DATASETS.TEST", "()", "MODEL.WEIGHTS", seed_path,
            "SOLVER.IMS_PER_BATCH", str(batch),
            "SOLVER.MAX_ITER", str(max_iter),
            "SOLVER.CHECKPOINT_PERIOD", str(period),
            "SOLVER.LOG_PERIOD", "1", "TEST.EVAL_PERIOD", "0",
            "OUTPUT_DIR", out]


def _accumulation_recipe(root, seed_path, workdir, log):
    """configs/coco_lsm.yaml as the reference ran it on 8 GPUs x 4
    images, on one card: batch 4, ``GRADIENT_ACCUMULATION_STEPS`` 8,
    16 iterations (two updates), a checkpoint after iteration 11 (in the
    middle of the second accumulation), through ``train_ovnet --num-gpus
    1`` (no process group); then ``--resume`` from it to 16. Checked:
    the parameters and the momentum move at iterations 8 and 16 only
    (1-based), the logged learning rate is the schedule at iteration //
    8, and before the first resumed step the model, the momentum, the
    accumulated gradients and the micro-step count equal the
    checkpoint's bit for bit."""
    import torch
    from locov_torch.config import config_path
    from locov_torch.engine.solver import (MultiSteps,
                                           _warmup_multistep_factor)
    from locov_torch.ops import kernel_lib
    flags = ["--config-file", config_path("coco_lsm.yaml"), "--num-gpus", "1"]
    opts = _scale_opts(root, seed_path, os.path.join(workdir, "accum"), 4,
                       ACCUM_ITER, ACCUM_PERIOD) + [
        "SOLVER.GRADIENT_ACCUMULATION_STEPS", str(ACCUM_K)]

    def watch(trainer):
        import torch.distributed as dist
        return {"steps": _StepWatch(trainer),
                "process_group": dist.is_initialized(),
                "multi_steps": isinstance(trainer.optimizer, MultiSteps)}
    kernel_lib.reset_launches()
    _, run, secs, peak = _run_cli(flags, opts, log, watch)
    launches = dict(kernel_lib.LAUNCHES)
    tr, w = run["trainer"], run["checked"]
    loop, rows = _loop_numbers(run, 4)
    s = tr.cfg.SOLVER
    factor = _warmup_multistep_factor(s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                      s.WARMUP_ITERS, s.WARMUP_METHOD)
    lr_want = [s.BASE_LR * factor(r["iteration"] // ACCUM_K) for r in rows]
    lr_got = [r["lr"] for r in rows]
    moves = [(i + 1) % ACCUM_K == 0 for i in range(ACCUM_ITER)]
    out = tr.cfg.OUTPUT_DIR
    pointer = open(os.path.join(out, "last_checkpoint")).read()
    saved = tr.checkpointer.load(pointer)["optimizer"]["multi_steps"]
    finite = all(math.isfinite(v) for r in rows for k, v in r.items()
                 if "loss" in k.lower())
    line = {"phase": "scale_accumulation", "config": "configs/coco_lsm.yaml",
            "batch": 4, "accumulation_steps": ACCUM_K,
            "effective_batch": 4 * ACCUM_K, "max_iter": ACCUM_ITER,
            "process_group": w["process_group"],
            "multi_steps": w["multi_steps"],
            "params_moved": w["steps"].moved,
            "momentum_moved": w["steps"].momentum_moved,
            "lr": lr_got, "lr_want": lr_want,
            "checkpoint": pointer, "checkpoint_mini_step":
                saved["mini_step"], **loop, "finite_losses": finite,
            "seconds": secs, "peak_mem_gib": peak, "launches": launches}
    emit(line)
    if not (finite and not w["process_group"] and w["multi_steps"] and
            w["steps"].moved == moves and
            w["steps"].momentum_moved == moves and
            loop["rows"] == list(range(ACCUM_ITER)) and
            all(abs(g - x) <= 1e-6 * x for g, x in zip(lr_got, lr_want)) and
            lr_got[0] != lr_got[ACCUM_K] and
            pointer == f"model_{ACCUM_PERIOD - 1:07d}" and
            saved["mini_step"] == ACCUM_PERIOD % ACCUM_K):
        raise AssertionError(f"accumulation check failed: {line}")

    def resumed(trainer):
        return {"same": same_as_checkpoint(trainer),
                "steps": _StepWatch(trainer)}
    _, run2, secs2, peak2 = _run_cli(flags + ["--resume"], opts, log,
                                     resumed)
    after = dict(kernel_lib.LAUNCHES)
    same, steps = run2["checked"]["same"], run2["checked"]["steps"]
    loop2, _ = _loop_numbers(run2, 4)
    line = {"phase": "scale_accumulation_resume",
            "start_iter": run2["start_iter"], "checked": same,
            "rows": loop2["rows"], "params_moved": steps.moved,
            "seconds": secs2, "peak_mem_gib": peak2,
            "launches": {k: v - launches[k] for k, v in after.items()}}
    emit(line)
    if not (run2["start_iter"] == ACCUM_PERIOD and same["model"] and
            same["momentum"] and same["accumulation"] and
            same["mini_step"] == ACCUM_PERIOD % ACCUM_K and
            same["scheduler_step"] == ACCUM_PERIOD // ACCUM_K and
            steps.moved == moves[ACCUM_PERIOD:] and
            loop2["rows"] == list(range(ACCUM_PERIOD, ACCUM_ITER))):
        raise AssertionError(f"accumulation resume check failed: {line}")
    torch.cuda.empty_cache()
    return after


def _global_batch(root, seed_path, workdir, log):
    """configs/coco_lsm_global.yaml (the global contrastive scope,
    ``PAIRWISE_CHUNK`` 128) at its batch of 32 on one card, with
    ``TPU.REMAT_BACKBONE``: three steps through ``train_ovnet``; finite
    losses, the peak memory and the loop's images/s."""
    import torch
    from locov_torch.config import config_path
    from locov_torch.ops import kernel_lib
    from locov_torch.tools.timing import nvidia_smi_line
    opts = _scale_opts(root, seed_path, os.path.join(workdir, "global"),
                       GLOBAL_BATCH, GLOBAL_ITER, 1000) + [
        "TPU.REMAT_BACKBONE", "True"]

    def settings(trainer):
        return {"scope": trainer.cfg.TPU.CONTRASTIVE_SCOPE,
                "remat": trainer.model.backbone.remat,
                "pairwise_chunk":
                    trainer.model.mmss_heads.transformer_head.tcfg
                    .pairwise_chunk}
    kernel_lib.reset_launches()
    _, run, secs, peak = _run_cli(
        ["--config-file", config_path("coco_lsm_global.yaml")], opts, log,
        settings)
    launches = dict(kernel_lib.LAUNCHES)
    loop, rows = _loop_numbers(run, GLOBAL_BATCH)
    finite = all(math.isfinite(v) for r in rows for k, v in r.items()
                 if "loss" in k.lower())
    line = {"phase": "scale_global_batch",
            "config": "configs/coco_lsm_global.yaml",
            "batch": GLOBAL_BATCH, "pairs_a_pass": GLOBAL_BATCH ** 2,
            "settings": run["checked"], **loop,
            "total_loss": [r.get("total_loss") for r in rows],
            "finite_losses": finite, "seconds": secs, "peak_mem_gib": peak,
            "launches": launches, "nvidia_smi": nvidia_smi_line()}
    emit(line)
    if not (finite and run["checked"] == {"scope": "global", "remat": True,
                                          "pairwise_chunk": 128} and
            loop["rows"] == list(range(GLOBAL_ITER))):
        raise AssertionError(f"global batch check failed: {line}")
    torch.cuda.empty_cache()
    return launches


def _lsm_cfg(name, dtype, **extra):
    """``configs/<name>`` with ``TPU.COMPUTE_DTYPE`` ``dtype``, the
    joint encoder's and the language backbone's dropout at 0 (runs that
    are compared take the same draws) and the ``extra`` overrides."""
    from locov_torch.config import config_path, get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(config_path(name))
    cfg.TPU.COMPUTE_DTYPE = dtype
    for node in (cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG,
                 cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG):
        node.hidden_dropout_prob = node.attention_probs_dropout_prob = 0.0
    for key, value in extra.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def _remat_chunk_variants(seed):
    """One LSM training step (``losses`` and its backward) at batch 8 of
    configs/coco_lsm_global.yaml in bfloat16, on the same batch and
    draws, in four variants: neither remat nor chunk, remat only, chunk
    only (``VARIANT_CHUNK`` pairs), both. Per variant, after a warm-up
    step, the peak memory over what was allocated before, the median
    ms of ``VARIANT_RUNS`` steps, each waited for, and the largest
    difference of any gradient (but ``ZERO_BY_SHIFT``'s) from the plain
    variant's over that tensor's largest |gradient|, held to
    ``VARIANT_GRAD_TOL``."""
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.tools.bench import lsm_inputs
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    cfg = _lsm_cfg("coco_lsm_global.yaml", "bfloat16")
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    build_optimizer(cfg, model)  # frozen parameters take no gradient
    batch, class_emb = lsm_inputs(VARIANT_BATCH, device="cuda")
    head = model.mmss_heads.transformer_head

    def run(remat, chunk):
        model.backbone.remat = remat
        head.tcfg = head.tcfg._replace(pairwise_chunk=chunk)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, losses = model.losses(batch, class_emb, gen, deterministic=False)
        sum(losses[k] for k in sorted(losses)).backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in model.named_parameters() if p.grad is not None}
        return ms, peak, grads, {k: float(v.detach())
                                 for k, v in losses.items()}

    kernel_lib.reset_launches()
    variants = (("neither", False, 0), ("remat", True, 0),
                ("chunk", False, VARIANT_CHUNK),
                ("both", True, VARIANT_CHUNK))
    results, all_ms = {}, {}
    for name, remat, chunk in variants:
        run(remat, chunk)  # warm-up: the first call at new shapes
        runs = [run(remat, chunk) for _ in range(VARIANT_RUNS)]
        all_ms[name] = [r[0] for r in runs]
        results[name] = (statistics.median(all_ms[name]),) + runs[-1][1:]
    launches = dict(kernel_lib.LAUNCHES)
    plain = results["neither"][2]
    lines = []
    for name, remat, chunk in variants:
        ms, peak, grads, losses = results[name]
        worst, worst_name = 0.0, None
        for k, g in plain.items():
            scale = float(g.abs().max())
            if k.endswith(ZERO_BY_SHIFT) or scale == 0:
                continue
            rel = float((grads[k] - g).abs().max()) / scale
            if rel > worst:
                worst, worst_name = rel, k
        lines.append({"phase": "scale_remat_chunk", "variant": name,
                      "remat": remat, "pairwise_chunk": chunk,
                      "batch": VARIANT_BATCH,
                      "pairs_a_pass": VARIANT_BATCH ** 2,
                      "peak_mem_gib": peak, "ms": ms,
                      "ms_all": all_ms[name],
                      "max_grad_rel_diff": worst, "worst": worst_name,
                      "same_gradients": set(grads) == set(plain),
                      "finite": all(math.isfinite(v)
                                    for v in losses.values()),
                      "tolerance": VARIANT_GRAD_TOL})
        emit(lines[-1])
    bad = [ln for ln in lines if not (ln["finite"] and ln["same_gradients"]
                                      and ln["max_grad_rel_diff"] <=
                                      VARIANT_GRAD_TOL)]
    del model, results, plain
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"remat / chunk variants disagree: {bad}")
    return launches


def _lsm_draws(model, batch, gen):
    """The uniform draws of ``DistillProposalMMSSRCNN.losses`` for
    ``batch`` (the RPN and ROI samplers' pairs, the grid and box spatial
    dropout's keys), from ``gen``: one set that runs take rows of."""
    import torch
    b, h, w = batch.images.image.shape[:3]
    rpn, rcfg = model.rpn_cfg, model.rcfg
    n_anchor = (-(-h // 16)) * (-(-w // 16)) * len(rpn.sizes) * \
        len(rpn.aspect_ratios)
    n_roi = rpn.post_nms_topk_train + (
        batch.gt.boxes.shape[1] if rcfg.proposal_append_gt else 0)
    n_grid = (-(-h // 32)) * (-(-w // 32))

    def rand(n):
        return torch.rand((b, n), generator=gen, device="cuda")
    return {"rpn": (rand(n_anchor), rand(n_anchor)),
            "roi": (rand(n_roi), rand(n_roi)),
            "grid_drop": rand(n_grid),
            "box_drop": rand(rcfg.batch_size_per_image)}


def _draws_to(draws, device):
    return {k: tuple(x.to(device) for x in v) if isinstance(v, tuple)
            else v.to(device) for k, v in draws.items()}


def _draw_rows(draws, start, stop):
    return {k: tuple(x[start:stop] for x in v) if isinstance(v, tuple)
            else v[start:stop] for k, v in draws.items()}


def _flat_params(model):
    import torch
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _dp_rank(rank, world, url, in_path, out_dir):
    """One rank of the data-parallel check: a gloo process group on the
    one card, the float32 LSM model from the saved weights, one step in
    each contrastive scope on its rows of the batch and the draws;
    whether the ranks' parameters are the same bits after it (one
    all_reduce), rank 0's parameters, the metrics, the launch counts and
    the kernels' signatures (``KernelShapes``) to ``out_dir``."""
    import torch
    import torch.distributed as dist
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import (initialize_distributed,
                                           make_train_step)
    from locov_torch.structures.batches import take_rows, to_torch
    torch.cuda.set_device(0)
    initialize_distributed(url, world, rank, "gloo")
    try:
        data = torch.load(in_path, weights_only=False)
        cfg = _lsm_cfg("coco_lsm.yaml", "float32",
                       **{"SOLVER.BASE_LR": DP_LR, "SOLVER.WARMUP_ITERS": 0})
        lo, hi = rank * DP_PER_RANK, (rank + 1) * DP_PER_RANK
        mine = to_torch(take_rows(data["batch"], lo, hi), "cuda")
        draws = _draw_rows(_draws_to(data["draws"], "cuda"), lo, hi)
        class_emb = data["class_emb"].cuda()
        out = {}
        with KernelShapes() as shapes:
            kernel_lib.reset_launches()
            for scope in ("local", "global"):
                model = build_meta_arch(cfg, device="cuda")
                model.load_state_dict(data["weights"])
                step = make_train_step(model, *build_optimizer(cfg, model),
                                       contrastive_scope=scope)
                t0 = time.perf_counter()
                metrics = step(mine, class_emb, None, draws)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                flat = _flat_params(model)
                total = flat.clone()
                dist.all_reduce(total)
                if rank == 0:
                    torch.save(flat.cpu(), os.path.join(out_dir,
                                                        f"dp_{scope}.pt"))
                out[scope] = {"metrics": {k: float(v)
                                          for k, v in metrics.items()},
                              "same_on_ranks": torch.equal(total,
                                                           flat * world),
                              "step_s": secs}
                del model, step, flat, total
                torch.cuda.empty_cache()
            launches = dict(kernel_lib.LAUNCHES)
        shapes.check_counts(launches)
        torch.save({"out": out, "launches": launches, "seen": shapes.seen},
                   os.path.join(out_dir, f"dp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _data_parallel(seed, workdir):
    """Two ranks on the one card (spawned processes, gloo: NCCL takes no
    two ranks on one GPU), the configs/coco_lsm.yaml model at full width
    in float32, 2 images a rank, every run on the same draws: local
    scope over 2 ranks against accumulation 2 on one rank over the same
    4 images, global scope over 2 ranks against one rank at batch 4
    (updates within ``DP_UPDATE_RTOL``, losses within ``DP_LOSS_RTOL``),
    both ranks the same bits, and the scopes' losses differ (2 x 2
    against 4 x 4 negatives)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import local_url, make_train_step
    from locov_torch.structures.batches import take_rows, to_torch
    from locov_torch.tools.bench import lsm_inputs
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    t_start = time.perf_counter()
    cfg = _lsm_cfg("coco_lsm.yaml", "float32",
                   **{"SOLVER.BASE_LR": DP_LR, "SOLVER.WARMUP_ITERS": 0})
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n = DP_WORLD * DP_PER_RANK
    batch, class_emb = lsm_inputs(n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = _lsm_draws(model, batch, gen)
    in_path = os.path.join(workdir, "dp_in.pt")
    torch.save({"weights": {k: v.cpu() for k, v in weights.items()},
                "batch": to_torch(batch, "cpu"),
                "draws": _draws_to(draws, "cpu"),
                "class_emb": class_emb.cpu()}, in_path)
    names = [(k, p.numel()) for k, p in model.named_parameters()]
    start = _flat_params(model)

    kernel_lib.reset_launches()
    acc_cfg = _lsm_cfg("coco_lsm.yaml", "float32", **{
        "SOLVER.BASE_LR": DP_LR, "SOLVER.WARMUP_ITERS": 0,
        "SOLVER.GRADIENT_ACCUMULATION_STEPS": DP_WORLD})
    step = make_train_step(model, *build_optimizer(acc_cfg, model))
    for r in range(DP_WORLD):
        lo, hi = r * DP_PER_RANK, (r + 1) * DP_PER_RANK
        step(take_rows(batch, lo, hi), class_emb, None,
             _draw_rows(draws, lo, hi))
    accum = _flat_params(model)
    model.load_state_dict(weights)
    step = make_train_step(model, *build_optimizer(cfg, model))
    whole = {k: float(v) for k, v in step(batch, class_emb, None,
                                          draws).items()}
    batch_n = _flat_params(model)
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    parent_launches = dict(kernel_lib.LAUNCHES)
    del model, step, weights, batch, draws
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    mp.spawn(_dp_rank, args=(DP_WORLD, local_url(), in_path, workdir),
             nprocs=DP_WORLD)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"dp_rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]

    def worst_update(got, ref):
        worst, name, off = 0.0, None, 0
        for k, numel in names:
            sl = slice(off, off + numel)
            off += numel
            if k in frozen or k.endswith(ZERO_BY_SHIFT):
                continue
            d_ref = ref[sl] - start[sl]
            scale = float(d_ref.abs().max())
            floor = 2 * float(np.spacing(np.float32(
                start[sl].abs().max().item())))
            err = float(((got[sl] - start[sl]) - d_ref).abs().max())
            rel = (err - floor) / scale if scale > 0 else \
                (0.0 if err <= floor else math.inf)
            if rel > worst:
                worst, name = rel, k
        return worst, name

    checks = {}
    for scope, ref in (("local", accum), ("global", batch_n)):
        got = torch.load(os.path.join(workdir, f"dp_{scope}.pt")).cuda()
        checks[scope] = worst_update(got, ref)
        del got
    metrics = {s: ranks[0]["out"][s]["metrics"] for s in ("local", "global")}
    loss_keys = [k for k in whole if "loss" in k.lower()]
    loss_err = max(abs(metrics["global"][k] - whole[k]) /
                   max(abs(whole[k]), 1e-12) for k in loss_keys)
    differ = {k: (metrics["local"][k], metrics["global"][k])
              for k in ("Image Caption Matching Loss",
                        "Box Image Caption Matching Loss")}
    launches = dict(parent_launches)
    seen = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in r["seen"].items():
            seen[k] = seen.get(k, 0) + v
    line = {"phase": "scale_data_parallel", "config": "configs/coco_lsm.yaml",
            "dtype": "float32", "ranks": DP_WORLD, "backend": "gloo",
            "images_a_rank": DP_PER_RANK,
            "same_on_ranks": {s: [r["out"][s]["same_on_ranks"]
                                  for r in ranks] for s in metrics},
            "local_vs_accumulation": {"max_update_rel_err": checks["local"][0],
                                      "worst": checks["local"][1]},
            "global_vs_one_rank": {"max_update_rel_err": checks["global"][0],
                                   "worst": checks["global"][1],
                                   "max_loss_rel_err": loss_err},
            "scopes_differ": differ,
            "rank_step_s": {s: [r["out"][s]["step_s"] for r in ranks]
                            for s in metrics},
            "reference_s": ref_s, "ranks_s": ranks_s,
            "update_rtol": DP_UPDATE_RTOL, "loss_rtol": DP_LOSS_RTOL,
            "launches_parent": parent_launches,
            "launches_ranks": [r["launches"] for r in ranks]}
    emit(line)
    ok = (all(all(v) for v in line["same_on_ranks"].values()) and
          checks["local"][0] <= DP_UPDATE_RTOL and
          checks["global"][0] <= DP_UPDATE_RTOL and
          loss_err <= DP_LOSS_RTOL and
          all(abs(a - b) > 1e-3 * abs(b) for a, b in differ.values()))
    del accum, batch_n, start
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"data-parallel check failed: {line}")
    missing = [k for k in TRAIN_KERNELS
               if any(r["launches"][k] == 0 for r in ranks)]
    if missing:
        raise AssertionError(f"kernels not launched in the ranks: {missing}")
    return parent_launches, launches, seen


def scale_path(seed, workdir):
    """Both published LSM recipes at their batch of 32 on the card
    (``_accumulation_recipe``: coco_lsm.yaml as 4 x 8 accumulation with
    a resume in the middle of an accumulation; ``_global_batch``:
    coco_lsm_global.yaml at batch 32 with remat and chunk 128), what
    remat and the chunk cost and save (``_remat_chunk_variants``), and
    two data-parallel ranks on the one card (``_data_parallel``), on the
    trainer path's tree and seed checkpoint in ``workdir``. Every
    sub-phase must launch K1-fwd, K1-bwd, K3-fwd and K3-bwd. Returns
    {"launches": this process's and the ranks' counts, "parent_launches":
    this process's, "rank_seen": the ranks' ``KernelShapes`` records}."""
    root = os.path.join(workdir, "coco")
    log = os.path.join(workdir, "trainer.log")
    seed_path = seed_checkpoint(workdir, seed)
    t0 = time.perf_counter()
    parts = {"accumulation": _accumulation_recipe(root, seed_path, workdir,
                                                  log),
             "global_batch": _global_batch(root, seed_path, workdir, log),
             "remat_chunk": _remat_chunk_variants(seed)}
    parent_dp, launches_dp, seen = _data_parallel(seed, workdir)
    parts["data_parallel"] = launches_dp
    for name, counts in parts.items():
        missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in the scale path's "
                                 f"{name}: {missing}")
    parent = {k: sum(parts[p][k] for p in ("accumulation", "global_batch",
                                           "remat_chunk")) + parent_dp[k]
              for k in parent_dp}
    total = {k: sum(parts[p][k] for p in parts) for k in parent_dp}
    emit({"phase": "scale_path", "seconds": time.perf_counter() - t0,
          "launches": total, "launches_by_part": parts})
    return {"launches": total, "parent_launches": parent,
            "rank_seen": seen}


# ---------------------------------------------------------- family path
FAMILY_GRID_RUNS = (("MMSSGridModel", 3, ["MODEL.MMSS_HEAD.DISTILLATION_LOSS",
                                    "False"]),
              ("DistillMMSSGridModel", 4, []))
GRID_RESUME_ITER = 6  # DistillMMSSGridModel resumed from iteration 4
FAMILY_STEPS = 3  # timed steps of a family model, after one warm-up
FUSED_TURNS = 2  # turns of (unfused, fused, fused, unfused)
# fused against unfused, bfloat16: the losses within 2e-2 relative
# (tests/test_torch_mmss_heads.py's bfloat16 bound) and each gradient
# within VARIANT_GRAD_TOL of its largest value (products of other shapes,
# as the scale path's chunks)
FUSED_LOSS_TOL = 2e-2
STT_TOKENS = 4  # the most tokens a class name of the grounding predictor
STT_STEP_KERNELS = ("relu_maxpool", "roi_align_fused",
                    "roi_align_bwd")  # coco_stt.yaml: FREEZE_AT 2


def _grid_models(seed, workdir, root, seed_path, log):
    """The grid models through the CLI twin on the trainer path's tree:
    configs/coco_lsm.yaml with ``MODEL.META_ARCHITECTURE`` overridden,
    batch 4, from the LSM seed checkpoint (through the rename map: the
    LSM's roi_heads.res5 seeds the grid model's trunk res5, the rest by
    name), a checkpoint every 2 iterations, the 'ovr' evaluation of
    coco_captions_val (the loss-only pass, no detection evaluation);
    ``DistillMMSSGridModel`` resumed to ``GRID_RESUME_ITER`` (the model
    and the momentum the checkpoint's bits). Returns the Distill model's
    ``model_final`` path."""
    import math
    from locov_torch.config import config_path
    common = ["DATASETS.ROOT", root, "TPU.IMAGE_BUCKETS", "()",
              "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.LOG_PERIOD", "1",
              "TEST.EVAL_PERIOD", "0", "MODEL.WEIGHTS", seed_path,
              "SOLVER.IMS_PER_BATCH", "4",
              "DATASETS.TEST", "('coco_captions_val',)"]
    flags = ["--config-file", config_path("coco_lsm.yaml")]
    final = None
    for arch, iters, extra in FAMILY_GRID_RUNS:
        opts = common + extra + ["MODEL.META_ARCHITECTURE", arch,
                                 "OUTPUT_DIR", os.path.join(workdir, arch)]
        res, run, secs, peak = _run_cli(
            flags, opts + ["SOLVER.MAX_ITER", str(iters)], log)
        tr = run["trainer"]
        loop, rows = _loop_numbers(run, 4)
        res = res["coco_captions_val"]
        rep = tr.last_import_report
        finite = all(math.isfinite(v) for r in rows for k, v in r.items()
                     if "loss" in k.lower())
        distill = arch.startswith("Distill")
        line = {"phase": "family_grid", "arch": arch,
                "config": "configs/coco_lsm.yaml",
                "dtype": tr.cfg.TPU.COMPUTE_DTYPE, "batch": 4,
                "max_iter": iters, **loop, "finite_losses": finite,
                "ovr_results": res, "seconds": secs, "peak_mem_gib": peak,
                "import": {"loaded": len(rep.loaded),
                           "missing": rep.missing,
                           "mismatched": rep.mismatched,
                           "unused_src": len(rep.unused_src)},
                "trunk_res5_loaded": any(k.startswith("backbone.res5.")
                                         for k in rep.loaded)}
        emit(line)
        if not (finite and type(tr.model).__name__ == arch and
                loop["rows"] == list(range(iters)) and
                "Total Loss" in res and
                not any(k.startswith("AP") for k in res) and
                ("kd_loss" in res) == distill and
                line["trunk_res5_loaded"] and rep.mismatched == [] and
                all(math.isfinite(v) for v in res.values()
                    if isinstance(v, float))):
            raise AssertionError(f"family grid model check failed: {line}")
        if distill:
            res2, run2, secs2, peak2 = _run_cli(
                flags + ["--resume"],
                opts + ["SOLVER.MAX_ITER", str(GRID_RESUME_ITER)], log,
                same_as_checkpoint)
            loop2, _ = _loop_numbers(run2, 4)
            line = {"phase": "family_grid_resume", "arch": arch,
                    "start_iter": run2["start_iter"],
                    "checked": run2["checked"], "rows": loop2["rows"],
                    "ms_per_step": loop2["ms_per_step"],
                    "seconds": secs2, "peak_mem_gib": peak2}
            emit(line)
            c = run2["checked"]
            if not (run2["start_iter"] == iters and c["model"] and
                    c["momentum"] and c["momentum_buffers"] > 50 and
                    loop2["rows"] == list(range(iters, GRID_RESUME_ITER))):
                raise AssertionError(f"grid resume check failed: {line}")
            final = os.path.join(tr.cfg.OUTPUT_DIR, "model_final")
    return final


def _grid_handoff(seed, grid_final):
    """The grid -> STT hand-off (OVR-CNN's recipe): the grid model's
    ``model_final`` into ``OvrRCNN`` from configs/coco_stt.yaml in
    bfloat16 through ``load_weights_standalone`` (the trunk's stem to
    res4 by name, its res5 into the ROI res5, the tied projection into
    ``emb_pred``, nothing mismatched), then detection of the main path's
    batch of 8."""
    import torch
    from locov_torch.tools.bench import build_stt_eval
    from locov_torch.utils.checkpoint import load_weights_standalone
    cfg, model, data, class_emb = build_stt_eval(device="cuda", seed=seed)
    rep = load_weights_standalone(model, grid_final)
    grid = torch.load(grid_final, map_location="cpu",
                      weights_only=True)["model"]
    sd = model.state_dict()
    res5 = [k for k in grid if k.startswith("backbone.res5.")]
    checks = {
        "roi_res5_is_trunk_res5": len(res5) > 40 and all(
            torch.equal(sd["roi_heads" + k[len("backbone"):]].cpu(),
                        grid[k]) for k in res5),
        "emb_pred_is_projection": all(torch.equal(
            sd[f"roi_heads.box_predictor.emb_pred.{leaf}"].cpu(),
            grid[f"mmss_heads.v2l_projection.{leaf}"])
            for leaf in ("weight", "bias")),
        "trunk_equal": all(torch.equal(sd[k].cpu(), grid[k])
                           for k in grid if k.startswith("backbone.res4.")),
        "mismatched": rep.mismatched, "missing": rep.missing}
    dets = model.inference(data, class_emb)
    torch.cuda.synchronize()
    n_dets = int(dets.mask.sum())
    finite = bool(torch.isfinite(dets.boxes).all() and
                  torch.isfinite(dets.scores).all())
    line = {"phase": "family_grid_handoff",
            "config": "configs/coco_stt.yaml", "batch": 8, **checks,
            "detections": n_dets, "finite": finite}
    emit(line)
    if not (checks["roi_res5_is_trunk_res5"] and
            checks["emb_pred_is_projection"] and checks["trunk_equal"] and
            rep.mismatched == [] and finite and n_dets > 0 and
            all(k.startswith(("rpn_head.", "roi_heads.box_predictor."
                              "bbox_pred.")) for k in rep.missing)):
        raise AssertionError(f"grid -> STT hand-off failed: {line}")
    del model
    torch.cuda.empty_cache()


def _since(before):
    """The launches of each kernel since the counts ``before``."""
    from locov_torch.ops import kernel_lib
    return {k: v - before[k] for k, v in kernel_lib.LAUNCHES.items()}


def _timed_steps(step, batch, class_emb, gen, n=FAMILY_STEPS):
    """One warm-up and ``n`` timed steps, each waited for: (median ms,
    every ms, the metrics as floats)."""
    import torch
    step(batch, class_emb, gen)
    torch.cuda.synchronize()
    times, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(batch, class_emb, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return statistics.median(times), times, metrics


def _distill_only(seed, batch, class_emb):
    """``DistillOnlyProposalMMSSRCNN`` from configs/coco_lsm.yaml at full
    width in bfloat16, batch 4 (the bench twin's inputs): the box pass
    alone, so ``box_kd_loss`` and no ``kd_loss`` or ``mixbox_kd_loss``."""
    import math
    import torch
    from locov_torch.ops import kernel_lib
    cfg = _lsm_cfg("coco_lsm.yaml", "bfloat16", **{
        "MODEL.META_ARCHITECTURE": "DistillOnlyProposalMMSSRCNN"})
    model, step, _ = _train_model(cfg, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernel_lib.LAUNCHES)
    ms, times, metrics = _timed_steps(step, batch, class_emb, gen)
    launches = _since(before)
    keys = set(metrics[-1])
    line = {"phase": "family_distill_only",
            "arch": "DistillOnlyProposalMMSSRCNN", "batch": 4,
            "ms_per_step": ms, "ms_per_step_all": times,
            "images_per_s": 4 / ms * 1e3, "metrics": metrics[-1],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}
    emit(line)
    if not ("box_kd_loss" in keys and "kd_loss" not in keys and
            "mixbox_kd_loss" not in keys and
            not any(k.startswith("CE_loss") for k in keys) and
            all(math.isfinite(v) for m in metrics for v in m.values()) and
            all(launches[k] > 0 for k in LSM_KERNELS)):
        raise AssertionError(f"DistillOnly check failed: {line}")
    del model, step
    torch.cuda.empty_cache()


def _fused_ab(seed, batch, class_emb):
    """``TPU.FUSED_MMSS_PASSES`` off and on: one model of
    configs/coco_lsm.yaml at full width in bfloat16, batch 4, dropout
    off, the same draws (a generator seeded anew each run), a run being
    ``losses`` and its backward, in turns (unfused, fused, fused,
    unfused) ``FUSED_TURNS`` times after one warm-up each. The fused
    run's losses within ``FUSED_LOSS_TOL`` and its gradients within
    ``VARIANT_GRAD_TOL`` of the unfused run's; the median ms of each;
    one run of each under torch.profiler (the MMSS stages' host and
    kernel ms, the kernel launches a run)."""
    import torch
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    cfg = _lsm_cfg("coco_lsm.yaml", "bfloat16")
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    build_optimizer(cfg, model)  # frozen parameters take no gradient

    def run(fused):
        model.fused_mmss = fused
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = model.losses(batch, class_emb, gen, deterministic=True)
        sum(losses[k] for k in sorted(losses)).backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, losses

    before = dict(kernel_lib.LAUNCHES)
    run(False)
    run(True)
    ms = {False: [], True: []}
    for _ in range(FUSED_TURNS):
        for fused in (False, True, True, False):
            ms[fused].append(run(fused)[0])
    res = {}
    for fused in (False, True):
        _, losses = run(fused)
        res[fused] = ({k: float(v.detach()) for k, v in losses.items()},
                      {k: p.grad.detach().float().cpu()
                       for k, p in model.named_parameters()
                       if p.grad is not None})
    (lu, gu), (lf, gf) = res[False], res[True]
    loss_err = {k: abs(lf[k] - v) / max(abs(v), 1e-6)
                for k, v in lu.items()}
    worst, worst_name = 0.0, None
    for k, g in gu.items():
        scale = float(g.abs().max())
        if k.endswith(ZERO_BY_SHIFT) or scale == 0:
            continue
        rel = float((gf[k] - g).abs().max()) / scale
        if rel > worst:
            worst, worst_name = rel, k
    profiles = {}
    for fused in (False, True):
        prof = profile_run(f"family_fused_profile_{'on' if fused else 'off'}",
                           lambda: run(fused),
                           statistics.median(ms[fused]))
        profiles[fused] = {
            "kernel_launches": prof["kernel_launches"],
            "device_busy_ms": prof["device_busy_ms"],
            "mmss_stages": {k: v for k, v in prof["stages"].items()
                            if k in ("grid_mmss", "box_mmss", "fused_mmss",
                                     "box_regions")}}
    launches = _since(before)
    line = {"phase": "family_fused_ab", "config": "configs/coco_lsm.yaml",
            "dtype": "bfloat16", "batch": 4, "run": "losses + backward",
            "unfused_ms_median": statistics.median(ms[False]),
            "fused_ms_median": statistics.median(ms[True]),
            "unfused_ms_all": ms[False], "fused_ms_all": ms[True],
            "loss_rel_err": loss_err, "max_grad_rel_diff": worst,
            "worst": worst_name, "same_keys": set(lu) == set(lf)
            and set(gu) == set(gf),
            "profile_unfused": profiles[False],
            "profile_fused": profiles[True], "launches": launches,
            "tolerances": {"loss": FUSED_LOSS_TOL,
                           "grad": VARIANT_GRAD_TOL}}
    emit(line)
    del model, res, gu, gf
    torch.cuda.empty_cache()
    if not (line["same_keys"] and worst <= VARIANT_GRAD_TOL and
            all(e <= FUSED_LOSS_TOL for e in loss_err.values()) and
            "fused_mmss" in profiles[True]["mmss_stages"] and
            "fused_mmss" not in profiles[False]["mmss_stages"]):
        raise AssertionError(f"fused MMSS A/B check failed: {line}")


def _mlp_and_random(seed, batch, class_emb):
    """``MMSS_HEAD.TYPES ("GroundingHead", "MLPHead")`` from
    configs/coco_lsm.yaml at full width in bfloat16, batch 4: one step;
    then, on the same model, one step of each of the grounding head's
    branches that draw random numbers (``random_categorical``,
    ``random_top3``, triplet with ``random`` negatives), drawn from the
    step's generator on the card."""
    import math
    import torch
    from locov_torch.ops import kernel_lib
    cfg = _lsm_cfg("coco_lsm.yaml", "bfloat16", **{
        "MODEL.MMSS_HEAD.TYPES": ("GroundingHead", "MLPHead")})
    model, step, _ = _train_model(cfg, seed)
    head = model.mmss_heads.grounding_head
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = dict(kernel_lib.LAUNCHES)
    lines = []
    for case, over in (("mlp_head", {}),
                       ("random_categorical",
                        {"alignment": "random_categorical"}),
                       ("random_top3", {"alignment": "random_top3"}),
                       ("triplet_random", {"loss_type": "triplet",
                                           "negative_mining": "random"})):
        head.gcfg = head.gcfg._replace(**over)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(batch, class_emb, gen).items()}
        torch.cuda.synchronize()
        lines.append({"phase": "family_heads", "case": case, "batch": 4,
                      "types": list(cfg.MODEL.MMSS_HEAD.TYPES),
                      "grounding": head.gcfg._asdict(),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "metrics": m,
                      "finite": all(math.isfinite(v) for v in m.values())})
        emit(lines[-1])
    launches = _since(before)
    del model, step
    torch.cuda.empty_cache()
    bad = [ln["case"] for ln in lines if not ln["finite"]]
    if bad or "Triplet Loss (Align Words, Choose Caption)" not in \
            lines[-1]["metrics"] or any(launches[k] == 0
                                        for k in LSM_KERNELS):
        raise AssertionError(f"MLP head / random branch steps failed: "
                             f"{bad} {launches}")


def _class_tokens(rng, n_classes, dim=768):
    """``ClassTokenEmbeddings`` on the card: ``n_classes`` synthetic
    class names of 1 to ``STT_TOKENS`` tokens and the background."""
    from locov_torch.models.box_emb_grounding import ClassTokenEmbeddings
    return ClassTokenEmbeddings.from_ragged(
        [rng.randn(rng.randint(1, STT_TOKENS + 1), dim)
         for _ in range(n_classes)], dim, device="cuda")


def _grounding_stt(seed):
    """STT with ``EmbeddingGroundingFastRCNNOutputLayers`` from
    configs/coco_stt.yaml at full width in bfloat16: inference of the
    train path's images of a batch of 8 (``_train_batch``) against the
    65 test classes (1 warm-up, ``FAMILY_STEPS`` timed), and
    ``FAMILY_STEPS`` training steps on that batch against the 48 seen
    classes, multi-token class names."""
    import math
    import numpy as np
    import torch
    from locov_torch.config import config_path, get_cfg
    from locov_torch.models.box_emb_grounding import (
        EmbeddingGroundingBoxPredictor)
    from locov_torch.ops import kernel_lib
    from locov_torch.structures.batches import DetectionBatch, to_torch
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_BOX_HEAD.NAME = GROUNDING_PREDICTOR
    # at the default temperature of 10 random-init scores spread over
    # the 66 classes below SCORE_THRESH_TEST
    cfg.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE = 1.0
    model, step, _ = _train_model(cfg, seed)
    assert isinstance(model.roi_heads.box_predictor,
                      EmbeddingGroundingBoxPredictor)
    rng = np.random.RandomState(seed)
    test_tokens, train_tokens = _class_tokens(rng, 65), _class_tokens(rng, 48)
    batch = to_torch(_train_batch(rng, 8), "cuda")
    images = DetectionBatch(images=batch.images)
    before = dict(kernel_lib.LAUNCHES)
    model.inference(images, test_tokens)
    torch.cuda.synchronize()
    times = []
    for _ in range(FAMILY_STEPS):
        t0 = time.perf_counter()
        dets = model.inference(images, test_tokens)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    infer_launches = _since(before)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = dict(kernel_lib.LAUNCHES)
    ms, step_times, metrics = _timed_steps(step, batch, train_tokens, gen)
    train_launches = _since(before)
    line = {"phase": "family_grounding_stt",
            "config": "configs/coco_stt.yaml", "dtype": "bfloat16",
            "predictor": GROUNDING_PREDICTOR,
            "tokens_a_class_max": int(test_tokens.mask.sum(1).max()),
            "inference_batch": 8, "inference_ms": statistics.median(times),
            "inference_ms_all": times,
            "detections": int(dets.mask.sum()),
            "train_batch": 8, "ms_per_step": ms,
            "ms_per_step_all": step_times, "metrics": metrics[-1],
            "inference_launches": infer_launches,
            "train_launches": train_launches}
    emit(line)
    if not (line["detections"] > 0 and
            bool(torch.isfinite(dets.scores).all()) and
            all(math.isfinite(v) for m in metrics for v in m.values()) and
            line["tokens_a_class_max"] > 1 and
            all(infer_launches[k] > 0 for k in INFERENCE_KERNELS) and
            all(train_launches[k] > 0 for k in STT_STEP_KERNELS)):
        raise AssertionError(f"grounding predictor STT check failed: "
                             f"{line}")
    del model, step
    torch.cuda.empty_cache()


def family_path(seed, workdir):
    """The rest of the model family on the card at full width, on the
    trainer path's tree and seed checkpoint in ``workdir``: the grid
    models through the CLI twin and their hand-off to STT
    (``_grid_models``, ``_grid_handoff``), ``DistillOnlyProposalMMSSRCNN``
    (``_distill_only``), the fused MMSS passes against the unfused ones
    (``_fused_ab``), the MLP head and the grounding head's random
    branches (``_mlp_and_random``), and STT with the grounding box
    predictor (``_grounding_stt``). Launch counts are zeroed before the
    path and read after it: K1-fwd, K1-bwd, K2/K3-fwd and K3-bwd must
    each have launched. Returns the path's launches."""
    import torch
    from locov_torch.ops import kernel_lib
    from locov_torch.tools.bench import lsm_inputs
    root = os.path.join(workdir, "coco")
    log = os.path.join(workdir, "trainer.log")
    seed_path = seed_checkpoint(workdir, seed)
    t0 = time.perf_counter()
    kernel_lib.reset_launches()
    grid_final = _grid_models(seed, workdir, root, seed_path, log)
    _grid_handoff(seed, grid_final)
    batch, class_emb = lsm_inputs(4, device="cuda")
    _distill_only(seed, batch, class_emb)
    _fused_ab(seed, batch, class_emb)
    _mlp_and_random(seed, batch, class_emb)
    del batch, class_emb
    torch.cuda.empty_cache()
    _grounding_stt(seed)
    total = dict(kernel_lib.LAUNCHES)
    emit({"phase": "family_path", "seconds": time.perf_counter() - t0,
          "launches": total})
    missing = [k for k in TRAIN_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the family path: "
                             f"{missing}")
    return total


# ------------------------------------------------------ serving, TTA
SERVING_BATCH = 8
SERVING_TURNS = 5  # timed batches of each of exported and eager
SERVING_BOX_TOL = 1e-3  # px, small_reference's card-against-CPU bounds
SERVING_SCORE_TOL = 1e-5
TTA_IMAGES = 16


def _serving_inputs(seed):
    """The serving path's batch (numpy): 8 images of 800 x 1344 (valid
    800 x 1312, original 640 x 640), as the main path builds them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = SERVING_BATCH
    return ((rng.rand(b, 800, 1344, 3) * 255).astype(np.float32),
            np.stack([np.full(b, 800), np.full(b, 1312)], 1).astype(
                np.int32),
            np.full((b, 2), 640, np.int32))


def _stt_cfg():
    from locov_torch.config import config_path, get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


def serve_fresh(artifact, seed):
    """The consumer of the serving path, run in a fresh process: load the
    artifact with ``locov_torch.serving.load_exported`` and run 1 + 5
    batches; prints one JSON line (its launches, the ms of each timed
    batch, the ``locov_torch`` modules it imported)."""
    import torch
    from locov_torch.ops import kernel_lib
    from locov_torch.serving import load_exported
    t0 = time.perf_counter()
    call, variables, class_emb = load_exported(artifact)
    load_s = time.perf_counter() - t0
    args = [torch.from_numpy(a).cuda() for a in _serving_inputs(seed)]
    kernel_lib.reset_launches()
    times = []
    for _ in range(1 + SERVING_TURNS):
        t0 = time.perf_counter()
        out = call(variables, *args, class_emb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    finite = bool(torch.isfinite(out["boxes"]).all() and
                  torch.isfinite(out["scores"]).all())
    print(json.dumps({"launches": dict(kernel_lib.LAUNCHES),
                      "load_s": load_s, "first_ms": times[0],
                      "ms": times[1:], "finite": finite,
                      "kept": int(out["mask"].sum()),
                      "modules": sorted(m for m in sys.modules
                                        if m.startswith("locov_torch"))}),
          flush=True)


def serving_path(gen, seed, workdir):
    """Serving at full width: configs/coco_stt.yaml in bfloat16, seeded
    weights at a trained scale (``trained_scale_``) saved as a checkpoint,
    class embeddings like the eval path's (a 768-d standard normal a
    class, 65 classes; the background row is zero). The export twin
    (``locov_torch.tools.export_serving.main``) exports the inference at
    batch 8, 800 x 1344 under ``workdir`` (its seconds, each file's
    bytes). A fresh ``python`` process (``serve_fresh``) loads the
    artifact, must import no ``locov_torch.models`` module, runs 1 + 5
    batches, and must launch K1-fwd and K2. Here the loaded program runs
    again under ``KernelShapes`` (every launch signature then checked
    with ``check_path_shapes``) and is compared with eager
    ``model.inference`` on the same inputs: classes and mask equal, boxes
    and scores equal or within 1e-3 px and 1e-5 (the maximum differences
    printed); then the ms a batch of each, the median of 5 turns each in
    turns. Returns the fresh process's launches."""
    import subprocess
    import numpy as np
    import torch
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.serving import load_exported
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch)
    from locov_torch.tools import export_serving
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = _stt_cfg()
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    weights = os.path.join(workdir, "stt_seed")
    torch.save({"model": model.state_dict()}, weights)
    rng = np.random.RandomState(seed + 1)
    names = sorted(c["name"] for c in _coco_categories())
    emb = os.path.join(workdir, "class_emb.json")
    with open(emb, "w") as f:
        json.dump({k: rng.randn(768).tolist() for k in names}, f)
    out = os.path.join(workdir, "stt_serving")
    b = SERVING_BATCH
    t0 = time.perf_counter()
    export_serving.main([
        "--config-file", os.path.join(here, "configs", "coco_stt.yaml"),
        "--weights", weights, "--embeddings", emb, "--out", out,
        "--batch", str(b), "--height", "800", "--width", "1344",
        "TPU.COMPUTE_DTYPE", "bfloat16", "MODEL.WEIGHTS", "''"])
    export_s = time.perf_counter() - t0
    files = {}
    for d, _, fs in os.walk(out):
        for fname in fs:
            path = os.path.join(d, fname)
            files[os.path.relpath(path, out)] = os.path.getsize(path)
    with open(os.path.join(out, "signature.json")) as f:
        sig = json.load(f)

    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.serve_fresh(sys.argv[1], int(sys.argv[2]))", out,
         str(seed)], capture_output=True, text=True, env=env, cwd=here,
        timeout=600)
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serving consumer failed:\n"
                             f"{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    models = [m for m in fresh["modules"]
              if m.startswith("locov_torch.models")]

    call, variables, class_emb = load_exported(out)
    args = [torch.from_numpy(a).cuda() for a in _serving_inputs(seed)]
    batch = DetectionBatch(images=ImageBatch(*args))
    call(variables, *args, class_emb)  # warm-up
    torch.cuda.synchronize()
    kernel_lib.reset_launches()
    with KernelShapes() as shapes:
        got = call(variables, *args, class_emb)
        torch.cuda.synchronize()
    launches = dict(kernel_lib.LAUNCHES)
    shapes.check_counts(launches)
    want = model.inference(batch, class_emb)
    want = dict(zip(("boxes", "scores", "classes", "mask"), want))
    same = {k: bool(torch.equal(got[k], want[k].to(got[k].dtype)))
            for k in want}
    m = want["mask"]
    box_err = float((got["boxes"][m] - want["boxes"][m]).abs().max()) \
        if m.any() else 0.0
    score_err = float((got["scores"] - want["scores"]).abs().max())
    times = {"exported": [], "eager": []}
    for _ in range(SERVING_TURNS):
        for name, run in (("exported",
                           lambda: call(variables, *args, class_emb)),
                          ("eager",
                           lambda: model.inference(batch, class_emb))):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    line = {"phase": "serving_path", "config": "configs/coco_stt.yaml",
            "dtype": "bfloat16", "batch": b, "image": [800, 1344],
            "export_s": export_s, "artifact_bytes": files,
            "signature": {k: sig[k] for k in ("platforms", "nr_devices")},
            "fresh_process_s": fresh_s, "fresh": {
                k: fresh[k] for k in ("launches", "load_s", "first_ms",
                                      "ms", "finite", "kept")},
            "fresh_model_modules": models, "same": same,
            "max_box_err_px": box_err, "max_score_err": score_err,
            "detections_kept": int(m.sum()),
            "ms_per_batch": {k: statistics.median(v)
                             for k, v in times.items()},
            "ms_all": times, "launches": launches}
    emit(line)
    ok = (not models and fresh["finite"] and
          all(fresh["launches"][k] > 0 for k in INFERENCE_KERNELS) and
          all(launches[k] > 0 for k in INFERENCE_KERNELS) and
          same["classes"] and same["mask"] and int(m.sum()) > 0 and
          box_err <= SERVING_BOX_TOL and score_err <= SERVING_SCORE_TOL)
    if not ok:
        raise AssertionError(f"serving path check failed: {line}")
    del model, call, variables, got, want, args, batch
    torch.cuda.empty_cache()
    check_path_shapes(gen, shapes.seen, "serving")
    return fresh["launches"]


def tta_path(gen, seed, workdir):
    """Evaluation with test-time augmentation at full width:
    ``engine/trainer.py:test`` with configs/coco_stt.yaml in bfloat16
    (seeded weights at a trained scale), TEST.AUG.ENABLED at its default
    sizes (400-1200 by 100, MAX_SIZE 4000, flip: 18 passes), batch 8, on
    ``write_coco_val``'s tree of 16 JPEGs: seconds, passes, AP keys, peak
    memory, the detections before and after the merge; every launch
    signature checked with ``check_path_shapes``. Then, at the test size
    alone (MAX_SIZE the test's), two checks on arrays (the seeded weights
    score an AP of 0, so AP keys alone would not tell): the unflipped
    pass's detections before the merge (img, box, score, cls) equal the
    plain evaluation's exactly, and so does the count after the merge
    (the merge's per-class NMS, float64, on boxes in the original image,
    at the threshold inference applied; how many it removed is printed),
    with the AP keys within ``eval_reference``'s 1e-6 AP points; the
    flipped pass's images are the unflipped pass's mirrored, and its
    boxes (``collect_detections(mirror_x=True)``) are a direct mirror of
    that pass's own boxes. Returns the TTA run's launches."""
    import numpy as np
    import torch
    from locov_torch.data import MetadataCatalog
    from locov_torch.engine.trainer import (build_test_loader,
                                            load_embeddings, test)
    from locov_torch.evaluation.evaluator import (add_seen_unseen_summary,
                                                  build_evaluator_for,
                                                  collect_detections,
                                                  dataset_id_lut,
                                                  score_detections)
    from locov_torch.evaluation.tta import (build_tta_loaders,
                                            inference_with_tta,
                                            merge_tta_detections)
    from locov_torch.models import build_meta_arch
    from locov_torch.ops import kernel_lib
    from locov_torch.parallel.mesh import make_eval_step
    from locov_torch.utils.weights import seeded_init_, trained_scale_
    root = os.path.join(workdir, "coco")
    write_coco_val(root, seed, n_images=TTA_IMAGES)
    cfg = _stt_cfg()
    cfg.DATASETS.ROOT = root
    cfg.DATASETS.TEST = (EVAL_DATASET,)
    cfg.TEST.IMS_PER_BATCH = 8
    model = trained_scale_(seeded_init_(build_meta_arch(cfg), seed))
    tta = cfg.clone()
    tta.TEST.AUG.ENABLED = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()
    t0 = time.perf_counter()
    with KernelShapes() as shapes:
        res = test(tta, model, "cuda")[EVAL_DATASET]
    seconds = time.perf_counter() - t0
    launches = dict(kernel_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shapes.check_counts(launches)

    meta = MetadataCatalog.get(EVAL_DATASET)
    inv = dataset_id_lut(meta)
    nms_thresh = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    class_emb = load_embeddings(cfg, EVAL_DATASET, "cuda")
    step = make_eval_step(model)
    with build_test_loader(cfg, EVAL_DATASET, None, False) as loader:
        flat, _ = collect_detections(step, None, loader, class_emb, inv)
    merged = merge_tta_detections(flat, nms_thresh, topk)
    evaluator = build_evaluator_for(EVAL_DATASET)
    score_detections(evaluator, merged)
    want = add_seen_unseen_summary(evaluator.summarize(per_category=True),
                                   meta)
    removed = len(flat["img"]) - len(merged["img"])

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    passes = []

    def recording(batch, ce):
        """``step``, keeping each batch's first image and raw outputs."""
        dets = step(batch, ce)
        im = batch.images
        passes[-1].append((host(im.image[0]), host(im.hw[0]),
                           host(im.image_id), host(im.orig_hw),
                           host(dets.boxes.float()), host(dets.mask)))
        return dets
    recording.device = step.device
    before = []

    def gather(dets):
        before.append(dets)
        return dets
    one = cfg.clone()
    one.TEST.AUG.ENABLED = True
    one.TEST.AUG.MIN_SIZES = (cfg.INPUT.MIN_SIZE_TEST,)
    one.TEST.AUG.MAX_SIZE = cfg.INPUT.MAX_SIZE_TEST
    one.TEST.AUG.FLIP = True
    (plain_loader, _), (flip_loader, _) = build_tta_loaders(one,
                                                            EVAL_DATASET)
    try:
        passes.append([])
        res_one = inference_with_tta(recording, None, [(plain_loader, False)],
                                     class_emb, EVAL_DATASET, nms_thresh,
                                     topk, gather_fn=gather)
        passes.append([])
        flipped, _ = collect_detections(recording, None, flip_loader,
                                        class_emb, inv, mirror_x=True)
    finally:
        plain_loader.close()
        flip_loader.close()
    same_flat = {k: bool(np.array_equal(before[0][k], flat[k]))
                 for k in flat}
    images_mirrored = all(
        np.array_equal(f[:h, :w], u[:h, :w][:, ::-1])
        for (u, (h, w), *_), (f, *_) in zip(*passes))
    mirrored = []
    for _, _, ids, orig_hw, boxes, mask in passes[1]:
        for i, img_id in enumerate(ids):
            if img_id >= 0 and mask[i].any():
                box = boxes[i][mask[i]].astype(np.float64)[:, [2, 1, 0, 3]]
                box[:, [0, 2]] = float(orig_hw[i][1]) - box[:, [0, 2]]
                mirrored.append(box)
    boxes_mirrored = bool(len(mirrored) > 0 and np.array_equal(
        np.concatenate(mirrored), flipped["box"]))
    ap_err = {k: abs(res_one[k] - want[k]) for k in EVAL_AP_KEYS}
    line = {"phase": "tta_path", "config": "configs/coco_stt.yaml",
            "dtype": "bfloat16", "images": TTA_IMAGES,
            "sizes": list(tta.TEST.AUG.MIN_SIZES),
            "max_size": tta.TEST.AUG.MAX_SIZE, "flip": tta.TEST.AUG.FLIP,
            "passes": res["tta_passes"], "seconds": seconds,
            "ap": {k: res[k] for k in EVAL_AP_KEYS},
            "detections": res["tta_detections"],
            "merged": res["tta_merged"], "peak_mem_gib": peak,
            "launches": launches,
            "launch_signatures": len(shapes.seen),
            "one_size": {"detections": res_one["tta_detections"],
                         "plain_detections": len(flat["img"]),
                         "same_as_plain": same_flat,
                         "merged": res_one["tta_merged"],
                         "merge_removed": removed,
                         "ap_err_vs_merged_plain": ap_err,
                         "flip_images_mirrored": images_mirrored,
                         "flip_detections": len(flipped["img"]),
                         "flip_boxes_mirrored": boxes_mirrored}}
    emit(line)
    print(f"tta_path: the one-size merge removed {removed} of "
          f"{len(flat['img'])} detections", file=sys.stderr, flush=True)
    ok = (res["tta_passes"] == 18 and
          all(0 <= res[k] <= 100 for k in EVAL_AP_KEYS) and
          all(launches[k] > 0 for k in INFERENCE_KERNELS) and
          all(same_flat.values()) and
          res_one["tta_merged"] == len(merged["img"]) and
          all(e <= 1e-6 for e in ap_err.values()) and
          images_mirrored and boxes_mirrored)
    if not ok:
        raise AssertionError(f"tta path check failed: {line}")
    del model, step, recording, passes
    torch.cuda.empty_cache()
    check_path_shapes(gen, shapes.seen, "tta")
    return launches


class KernelShapes:
    """While a path runs: how many launches each of K1-fwd, K1-bwd,
    K2/K3-fwd and K3-bwd made at each signature (the dtype and shapes of
    its tensors, its other arguments), read by wrapping the four
    wrappers that the ``locov::`` ops' CUDA implementations call (by
    their module's name, at call time). ``check_counts`` holds the sums against the launch
    counts, so that no launch of the path went past the wrappers."""

    def __enter__(self):
        from locov_torch.ops import kernel_lib
        from locov_torch.ops import relu_maxpool as rp
        from locov_torch.ops import roi_align as ra
        self.seen, self._orig = {}, []

        def wrap(mod, attr, kernel, sig):
            orig = getattr(mod, attr)

            def fn(*a, **k):
                before = kernel_lib.LAUNCHES[kernel]
                out = orig(*a, **k)
                if kernel_lib.LAUNCHES[kernel] > before:
                    key = (kernel,) + sig(*a, **k)
                    self.seen[key] = self.seen.get(key, 0) + 1
                return out
            self._orig.append((mod, attr, orig))
            setattr(mod, attr, fn)

        def dt(t):
            return str(t.dtype).split(".")[1]
        wrap(rp, "relu_maxpool_cuda", "relu_maxpool",
             lambda x: (dt(x), tuple(x.shape)))
        wrap(rp, "relu_maxpool_bwd_cuda", "relu_maxpool_bwd",
             lambda x, dy: (dt(x), tuple(x.shape)))
        wrap(ra, "roi_align_cuda", "roi_align_fused",
             lambda features, boxes, spatial_scale, pooled=14,
             sampling_ratio=2: (dt(features), tuple(features.shape),
                                boxes.shape[1], float(spatial_scale),
                                pooled, int(sampling_ratio)))
        wrap(ra, "roi_align_bwd_cuda", "roi_align_bwd",
             lambda g, boxes, spatial_scale, h, w, pooled=14,
             sampling_ratio=2: (dt(g), (g.shape[0], h, w, g.shape[-1]),
                                boxes.shape[1], float(spatial_scale),
                                pooled, int(sampling_ratio)))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)

    def check_counts(self, launches):
        per = {k: 0 for k in TRAIN_KERNELS}
        for key, n in self.seen.items():
            per[key[0]] += n
        if any(per[k] != launches[k] for k in per):
            raise AssertionError(f"launches past the wrappers: seen {per}, "
                                 f"counted {launches}")


def check_path_shapes(gen, seen, path):
    """Each kernel at each signature that ``path``'s launches had
    (``KernelShapes.seen``), on fresh inputs of that dtype and shape,
    against its plain version with phase 2's tolerances: K1-fwd
    bit-exact; K1-bwd (into a NaN-filled dx) bit-exact in float32, in
    bfloat16 within one ulp with NaN in the same places; K2/K3-fwd
    ``_roi_fwd_within``; K3-bwd ``_roi_bwd_within``. ROIAlign's boxes
    are training boxes (``train_boxes``: 20 gt-sized a batch row, or all
    of them where there are fewer) over the image the features cover.
    Runs after the path's counts are read."""
    import torch
    from locov_torch.ops.relu_maxpool import (_launch_bwd,
                                              relu_maxpool_bwd_plain,
                                              relu_maxpool_cuda,
                                              relu_maxpool_plain)
    from locov_torch.ops.roi_align import (roi_align_batched,
                                           roi_align_bwd_cuda,
                                           roi_align_bwd_plain,
                                           roi_align_cuda)
    from locov_torch.tools.bench_roi_bwd import train_boxes
    for key in sorted(seen, key=str):
        kernel, dt, shape = key[:3]
        dtype = getattr(torch, dt)
        line = {"phase": "kernel_check", "kernel": kernel,
                "case": f"{path}_path", "dtype": dt, "shape": list(shape),
                "path_launches": seen[key]}
        if kernel.startswith("relu_maxpool"):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if kernel == "relu_maxpool":
            got, want = relu_maxpool_cuda(x), relu_maxpool_plain(x)
            ok = _same_bits(got, want)
            err = (got.float() - want.float()).abs().max().item()
            del x
        elif kernel == "relu_maxpool_bwd":
            n, h, w, c = shape
            dy = torch.randn((n, (h + 1) // 2, (w + 1) // 2, c),
                             generator=gen, device="cuda").to(dtype)
            got = _launch_bwd(x, dy, fill=math.nan)
            want = relu_maxpool_bwd_plain(x, dy)
            ok = _same_bits(got, want)
            diff = torch.nan_to_num((got.float() - want.float()).abs())
            err = diff.max().item()
            if dtype == torch.bfloat16:
                ulp = _bf16_ulp(torch.maximum(got.float().abs(),
                                              want.float().abs()))
                ok = torch.equal(torch.isnan(got), torch.isnan(want)) \
                    and not bool((diff > ulp).any())
                del ulp
            del x, dy, diff
        else:
            n_boxes, scale, pooled, sr = key[3:]
            b, h, w, c = shape
            bx = train_boxes(gen, b, n_boxes, min(20, n_boxes),
                             h / scale, w / scale)
            line.update(boxes=[b, n_boxes], sampling_ratio=sr)
            if kernel == "roi_align_fused":
                f = torch.randn(shape, generator=gen,
                                device="cuda").to(dtype)
                got = roi_align_cuda(f, bx, scale, pooled, sr)
                want = roi_align_batched(f, bx, scale, pooled, sr)
                ok, err = _roi_fwd_within(got, want,
                                          f.float().abs().max().item())
                del f
            else:
                g = torch.randn((b, n_boxes, pooled, pooled, c),
                                generator=gen, device="cuda").to(dtype)
                got = roi_align_bwd_cuda(g, bx, scale, h, w, pooled, sr)
                want = roi_align_bwd_plain(g, bx, scale, h, w, pooled, sr)
                absbwd = roi_align_bwd_plain(g.abs(), bx, scale, h, w,
                                             pooled, sr).float()
                ok, err = _roi_bwd_within(got, want, absbwd)
                del g, absbwd
            del bx
        line.update(max_abs_err=err, within_tolerance=ok)
        emit(line)
        if not ok:
            raise AssertionError(f"{kernel} at a {path} path shape: {line}")
        del got, want
        torch.cuda.empty_cache()


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
    # PyTorch's defaults: float32 matmuls in float32, cuDNN allowed TF32;
    # the port's float32 convolutions turn TF32 off themselves
    # (locov_torch/ops/conv.py), and the small references check it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True

    from locov_torch.tools.timing import nvidia_smi_line
    smi = nvidia_smi_line()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    build_s = kernel_lib.build()
    regs = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
            for k, v in kernel_lib.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": regs})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    check_relu_maxpool(gen, results)
    check_relu_maxpool_bwd(gen, results)
    check_roi_align(gen, results)
    torch.cuda.empty_cache()
    check_roi_align_train(gen, results)
    torch.cuda.empty_cache()
    check_bottleneck_block(gen, results)
    torch.cuda.empty_cache()
    check_stem_conv_bn(gen, results)
    torch.cuda.empty_cache()
    check_roi_align_lsm(gen)
    torch.cuda.empty_cache()
    small_reference(args.seed)
    small_reference_train(args.seed)
    small_reference_lsm(args.seed)
    small_reference_family(args.seed)
    workdir = os.path.join(here, "build", "chip_smoke_eval")
    shutil.rmtree(workdir, ignore_errors=True)
    eval_reference(args.seed, workdir)
    paths = {"inference": main_path(args.seed, args.batches)}
    torch.cuda.empty_cache()
    paths["train"], paths["train_freeze0"] = train_path(args.seed)
    torch.cuda.empty_cache()
    paths["lsm"] = lsm_path(args.seed)
    torch.cuda.empty_cache()
    try:
        paths["eval"] = eval_path(args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = os.path.join(here, "build", "chip_smoke_trainer")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        with KernelShapes() as shapes:
            paths["trainer"] = trainer_path(args.seed, workdir)
        shapes.check_counts(paths["trainer"])
        check_path_shapes(gen, shapes.seen, "trainer")
        torch.cuda.empty_cache()
        with KernelShapes() as shapes:
            scale = scale_path(args.seed, workdir)
        shapes.check_counts(scale["parent_launches"])
        for key, n in scale["rank_seen"].items():
            shapes.seen[key] = shapes.seen.get(key, 0) + n
        check_path_shapes(gen, shapes.seen, "scale")
        paths["scale"] = scale["launches"]
        torch.cuda.empty_cache()
        with KernelShapes() as shapes:
            paths["family"] = family_path(args.seed, workdir)
        shapes.check_counts(paths["family"])
        check_path_shapes(gen, shapes.seen, "family")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = os.path.join(here, "build", "chip_smoke_serving")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        paths["serving"] = serving_path(gen, args.seed, workdir)
        torch.cuda.empty_cache()
        paths["tta"] = tta_path(gen, args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    from locov_torch.tools import bench_block, bench_stem
    # bf16 against cuDNN's chain, which rounds t1 and t2 at other places
    paths["block"] = bench_path("block", bench_block.main,
                                "bottleneck_block", 2e-2)
    # against one cuDNN call that adds the shift in bf16
    paths["stem"] = bench_path("stem", bench_stem.main, "stem_conv_bn", 1e-2)

    kernels = []
    for name, source, replaces, path, check in KERNEL_ROWS:
        r = results[(check, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path][name],
            "launches_path": path,
            "launches_by_path": {k: v[name] for k, v in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16",
            "shape": r.get("shape") or r.get("features"),
            "f32_ms": results[(check, "float32")]["kernel_ms"],
            "f32_plain_ms": results[(check, "float32")]["plain_ms"],
            "f32_bound_ms": results[(check, "float32")]["bound_ms"],
            "f32_library_ms": results[(check, "float32")]["library_ms"],
            **({"ref_chain_ms": r["ref_chain_ms"]} if "ref_chain_ms" in r
               else {})})
    emit({"kernels": kernels,
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
