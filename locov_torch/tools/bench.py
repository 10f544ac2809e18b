"""Throughput of the port on the card: the two workloads of the
repository's ``bench.py``.

    python -m locov_torch.tools.bench [--mode stt_eval] [--batch N]
                                      [--device cpu]

The default mode is the image-caption (LSM) training step:
``DistillProposalMMSSRCNN`` from configs/coco_lsm.yaml in bfloat16 at
full width, batch 4 of 800 x 1344 images (valid 800 x 1312), 200 binary
gt boxes an image (object proposals as gt), 70 caption tokens (20
valid) and an [81, 768] class-embedding matrix, through
``build_optimizer`` and ``make_train_step``. ``--mode stt_eval`` is STT
detection inference: ``OvrRCNN`` from configs/coco_stt.yaml in bfloat16,
batch 8, a [66, 768] class-embedding matrix. Both take seeded random
weights (the training model at the scale of trained weights,
``utils/weights.py:trained_scale_``, or its losses are not finite) and
the synthetic inputs ``bench.py`` builds. As in ``bench.py``, the
environment variable ``LOCOV_FUSED_MMSS`` (1 or 0), where set, turns the
fused grid + box MMSS pass (``TPU.FUSED_MMSS_PASSES``) on or off, and
for ``stt_eval`` ``LOCOV_INT8_EVAL=1`` turns on the int8 serving mode
(``TPU.INT8_EVAL``) with ``LOCOV_INT8_SCHEME`` (dynamic, the default, or
static: then one calibration pass over the synthetic batch first) and
``LOCOV_INT8_ROIALIGN`` (1 or 0, where set: ``TPU.INT8_ROIALIGN``); the
line's ``variant`` says which (bf16, int8-dynamic or int8-static).

Timing follows ``bench.py``: warm-up, then bursts of sequentially
dependent steps (each training step updates the weights the next one
reads; each inference batch feeds its scores, times 0, into the next
one's class embeddings) with one synchronisation at the end of a burst,
best burst of four; beside it, the median of four steps each waited
for on its own (``*_synced``). It prints ONE JSON line: the metric
(``lsm_train_images_per_sec_per_chip`` or
``stt_eval_images_per_sec_per_chip``), the card's name and power limit;
on any failure the same metric at 0 with the error, and exit code 1.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from ..config import config_path, get_cfg
from ..engine.solver import build_optimizer
from ..models import build_meta_arch
from ..parallel.mesh import make_train_step
from ..structures.batches import (DetectionBatch, GtBatch, ImageBatch,
                                  TextBatch, to_torch)
from ..utils.device import resolve_device
from ..utils.weights import seeded_init_, trained_scale_
from .timing import describe, sync

METRICS = {"lsm": "lsm_train_images_per_sec_per_chip",
           "stt_eval": "stt_eval_images_per_sec_per_chip"}


def _images(rng, b, height, width):
    return ImageBatch(
        image=(rng.rand(b, height, width, 3) * 255).astype(np.float32),
        hw=np.stack([np.full(b, 800), np.full(b, 1312)], 1).astype(np.int32),
        orig_hw=np.full((b, 2), 640, np.int32))


def build_full(batch=4, height=800, width=1344, text_len=70, device=None,
               seed=0):
    """(cfg, model, batch, class_emb) of the LSM training workload, as
    ``bench.py:build_full`` builds it, on ``device``."""
    dev = resolve_device(device)
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if "LOCOV_FUSED_MMSS" in os.environ:  # A/B the fused grid + box pass
        cfg.TPU.FUSED_MMSS_PASSES = os.environ["LOCOV_FUSED_MMSS"] == "1"
    model = trained_scale_(seeded_init_(build_meta_arch(cfg, device=dev),
                                        seed))
    return (cfg, model) + lsm_inputs(batch, height, width, text_len, dev)


def lsm_inputs(batch=4, height=800, width=1344, text_len=70, device=None):
    """(batch, class_emb) of the LSM training workload on ``device``:
    ``build_full``'s synthetic images, gt, captions and class
    embeddings."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    b = batch
    images = _images(rng, b, height, width)
    ngt = 200  # object proposals converted to binary gt
    xy = rng.rand(b, ngt, 2) * 600
    wh = rng.rand(b, ngt, 2) * 200 + 16
    gt = GtBatch(boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
                 classes=np.ones((b, ngt), np.int32),
                 mask=np.ones((b, ngt), bool))
    ids = rng.randint(1000, 30000, (b, text_len)).astype(np.int32)
    attn = np.ones((b, text_len), np.int32)
    attn[:, 20:] = 0
    special = np.zeros((b, text_len), np.int32)
    special[:, 0] = 1
    special[:, 19] = 1
    special[:, 20:] = 1
    mlm = np.zeros((b, text_len), np.int32)
    mlm[:, 5] = 1
    text = TextBatch(input_ids=ids, attention_mask=attn,
                     special_tokens_mask=special, target_ids=ids,
                     mlm_mask=mlm)
    data = to_torch(DetectionBatch(images=images, gt=gt, text=text), dev)
    class_emb = torch.from_numpy(
        rng.randn(81, 768).astype(np.float32)).to(dev)
    return data, class_emb


def build_stt_eval(batch=8, height=800, width=1344, device=None, seed=0):
    """(cfg, model, batch, class_emb) of the STT inference workload, as
    ``bench.py:build_stt_eval`` builds it, on ``device``."""
    dev = resolve_device(device)
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_stt.yaml"))
    cfg.MODEL.WEIGHTS = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if os.environ.get("LOCOV_INT8_EVAL") == "1":
        cfg.TPU.INT8_EVAL = True
        cfg.TPU.INT8_SCHEME = os.environ.get("LOCOV_INT8_SCHEME", "dynamic")
    if "LOCOV_INT8_ROIALIGN" in os.environ:  # A/B the full-int8 op
        cfg.TPU.INT8_ROIALIGN = os.environ["LOCOV_INT8_ROIALIGN"] == "1"
    model = seeded_init_(build_meta_arch(cfg, device=dev), seed)
    rng = np.random.RandomState(0)
    data = to_torch(DetectionBatch(images=_images(rng, batch, height,
                                                  width)), dev)
    # the generalized test set: 65 classes and the background row
    class_emb = torch.from_numpy(
        rng.randn(66, 768).astype(np.float32)).to(dev)
    return cfg, model, data, class_emb


def _best_burst(run_burst, n_iter: int, reps: int = 4) -> float:
    """Seconds per step of the best of ``reps`` bursts; ``run_burst(n)``
    runs n dependent steps and ends in one read of the last result."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_burst(n_iter)
        best = min(best, (time.perf_counter() - t0) / n_iter)
    return best


def _synced_ms(run_burst, n: int = 4) -> float:
    """Median ms of ``n`` steps each ended by a read of its result: the
    burst's time plus what the device still had to do when the host
    had enqueued the step (no overlap across steps)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run_burst(1)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_lsm(batch=4, device=None) -> dict:
    dev = resolve_device(device)
    cfg, model, data, class_emb = build_full(batch=batch, device=dev)
    step = make_train_step(model, *build_optimizer(cfg, model))
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(5):  # warm-up: cuDNN plans, allocator, caches
        metrics = step(data, class_emb, gen)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def burst(n):
        for _ in range(n):
            m = step(data, class_emb, gen)
        return float(m["total_loss"])  # one wait, at the end

    dt = _best_burst(burst, n_iter=8)
    synced = _synced_ms(burst)
    metrics = step(data, class_emb, gen)
    losses_finite = bool(all(torch.isfinite(v).all()
                             for v in metrics.values()))
    return {"metric": METRICS["lsm"], "value": batch / dt, "unit": "img/s",
            "batch": batch, "ms_per_step": dt * 1e3,
            "ms_per_step_synced": synced, "dtype": "bfloat16",
            "config": "configs/coco_lsm.yaml",
            "losses_finite": losses_finite, **_memory(dev),
            **describe(dev)}


def variant(cfg) -> str:
    """bf16, int8-dynamic or int8-static (``bench.py``'s ``variant``)."""
    if not cfg.TPU.INT8_EVAL:
        return "bf16"
    return f"int8-{cfg.TPU.INT8_SCHEME}"


def run_stt_eval(batch=8, device=None) -> dict:
    dev = resolve_device(device)
    cfg, model, data, class_emb = build_stt_eval(batch=batch, device=dev)
    if cfg.TPU.INT8_EVAL and cfg.TPU.INT8_SCHEME == "static":
        # one calibration pass over the synthetic batch fills the
        # max-abs buffers
        model.calibrate_int8(data, class_emb)
    for _ in range(4):  # warm-up
        dets = model.inference(data, class_emb)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def burst(n):
        ce = class_emb
        for _ in range(n):
            dets = model.inference(data, ce)
            # chain the batches: the next one reads this one's scores
            ce = class_emb + dets.scores.sum() * 0.0
        return float(dets.scores.sum())

    dt = _best_burst(burst, n_iter=10)
    return {"metric": METRICS["stt_eval"], "value": batch / dt,
            "unit": "img/s", "batch": batch, "ms_per_batch": dt * 1e3,
            "ms_per_batch_synced": _synced_ms(burst),
            "dtype": "bfloat16", "variant": variant(cfg),
            "config": "configs/coco_stt.yaml",
            **_memory(dev), **describe(dev)}


def _memory(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {}
    return {"peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("lsm", "stt_eval"), default="lsm")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run = run_stt_eval if args.mode == "stt_eval" else run_lsm
    kwargs = {"device": args.device}
    if args.batch:
        kwargs["batch"] = args.batch
    try:
        line = run(**kwargs)
    except Exception as e:  # noqa: BLE001 -- the contract is one line
        traceback.print_exc()
        print(json.dumps({"metric": METRICS[args.mode], "value": 0.0,
                          "unit": "img/s",
                          "error": f"{type(e).__name__}: {e}"[:400]}),
              flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
