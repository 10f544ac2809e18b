"""The host input pipeline's sustained images/s on real-sized JPEGs,
against what the training step consumes. Twin of
``tools/bench_loader.py``.

    python -m locov_torch.tools.bench_loader [--images 256] [--batch 4]
        [--seconds 12] [--workers 0 4 8] [--backend threads|processes]
        [--device-rate IMG_S] [--device cpu]

Measures the whole host path the trainer runs: JPEG decode ->
resize-shortest-edge (800 / 1333) -> flip -> box transform -> caption
choice -> tokenize + MLM mask -> bucket grouping -> static collate,
through the port's ``DetectionMapper`` and ``DataLoader`` (``data/``)
as ``engine/trainer.py:build_train_loader`` wires them, on JPEGs at
COCO-typical sizes that ``make_dataset`` writes from a seed (the same
bytes, records, captions and proposals as JAX's tool writes).

``--device-rate`` is the img/s the training step consumes on the card
(the bench twin's ``lsm_train_images_per_sec_per_chip``, or
``chip_smoke.py``'s LSM path); it has no default, and without it
``vs_baseline`` is null. The loader runs on the host; ``--device``
names the card whose rate that is (``timing.describe``) and, as in
every entry point of the port, is ``cuda`` unless ``--device cpu`` is
given. Prints one line a worker count on stderr, then one JSON line
with JAX's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..utils.device import resolve_device
from .timing import describe


def make_dataset(root: str, n_images: int, seed: int = 0):
    """Write n JPEGs at COCO-typical sizes with synthetic annotations,
    captions and OLN-style proposals."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    records = []
    captions = {}
    proposals = {}
    sizes = [(640, 480), (640, 427), (500, 375), (612, 612), (640, 640)]
    for i in range(n_images):
        w, h = sizes[i % len(sizes)]
        # realistic JPEG entropy: smooth gradients + noise compresses
        # like a photo, unlike pure noise (worst case) or flat (best)
        yy, xx = np.mgrid[0:h, 0:w]
        base = (np.sin(xx / 37.0) * 60 + np.cos(yy / 23.0) * 60 + 128)
        img = np.clip(base[..., None] + rng.randn(h, w, 3) * 18, 0,
                      255).astype(np.uint8)
        path = os.path.join(root, f"{i:06d}.jpg")
        Image.fromarray(img).save(path, quality=90)
        nb = rng.randint(2, 12)
        xy = rng.rand(nb, 2) * [w * 0.7, h * 0.7]
        wh2 = rng.rand(nb, 2) * [w * 0.3, h * 0.3] + 8
        anns = [{"bbox": [float(x), float(y), float(x + bw),
                          float(y + bh)],
                 "category_id": int(rng.randint(0, 48)), "iscrowd": 0}
                for (x, y), (bw, bh) in zip(xy, wh2)]
        records.append({"file_name": path, "image_id": i, "height": h,
                        "width": w, "annotations": anns})
        captions[i] = [f"a photo of thing {i} doing something"]
        pb = np.concatenate([xy, xy + wh2], 1).astype(np.float32)
        proposals[i] = np.concatenate(
            [pb, rng.rand(nb, 1).astype(np.float32) * 0.3 + 0.7], 1)
    return records, captions, proposals


def build_loader(records, captions, proposals, batch, workers,
                 backend="threads"):
    from ..config import config_path, get_cfg
    from ..data.loader import DataLoader, TrainingSampler, derive_buckets
    from ..data.mappers import DetectionMapper
    from ..data.tokenization import WordPieceTokenizer, build_tiny_vocab

    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    metadata = {
        "thing_classes": [f"c{i}" for i in range(48)],
        "captions_dict": captions,
        "object_proposals": proposals,
    }
    tok = WordPieceTokenizer(build_tiny_vocab(
        "a photo of thing doing something".split()))
    mapper = DetectionMapper(cfg, metadata, is_train=True, tokenizer=tok,
                             mlm=True)
    sampler = TrainingSampler(len(records), shuffle=True, seed=1)
    return DataLoader(records, mapper, sampler, batch,
                      derive_buckets(cfg, True),
                      gt_slots=cfg.TPU.MAX_GT_BOXES, has_text=True,
                      is_train=True, num_workers=workers,
                      worker_backend=backend)


def measure(loader, batch, seconds):
    it = iter(loader)
    next(it)  # warm caches
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        next(it)
        n += batch
    return n / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 4, 8])
    ap.add_argument("--device-rate", type=float, default=None,
                    help="img/s the training step consumes on the card")
    ap.add_argument("--backend", default="threads",
                    choices=["threads", "processes"],
                    help="DATALOADER.WORKER_BACKEND to benchmark")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as root:
        print(f"generating {args.images} jpegs...", file=sys.stderr)
        records, captions, proposals = make_dataset(root, args.images)
        results = {}
        for w in args.workers:
            loader = build_loader(records, captions, proposals,
                                  args.batch, w,
                                  backend=args.backend if w else "threads")
            with loader:
                ips = measure(loader, args.batch, args.seconds)
            results[w] = ips
            ratio = ("" if args.device_rate is None
                     else f" ({ips / args.device_rate:.2f}x device rate)")
            print(f"workers={w}: {ips:.1f} img/s{ratio}", file=sys.stderr)
        best = max(results.values())
        line = {
            "metric": "loader_images_per_sec",
            "value": best,
            "unit": "img/s",
            "vs_baseline": (None if args.device_rate is None
                            else best / args.device_rate),
            "per_workers": results,
            "device_rate": args.device_rate, **describe(device),
        }
        print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
