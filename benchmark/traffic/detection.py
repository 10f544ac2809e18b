"""The one generator of the detection cells' traffic, driven by a data
file of parameters (``benchmark/traffic/<traffic>.json``):

- ``batch``: images a request (a training step, or an inference call);
- ``buckets``: {name: {"padded": [h, w], "valid": [h, w], "orig":
  [h, w]}}, the canvases and the valid sizes inside them;
- ``first``: the buckets of the first requests (set-up meets every
  shape there), then blocks of ``block`` ({bucket: count}), shuffled
  from the seed, so every seed sends the same mix in another order;
- ``pool``: host batches made a bucket, used in turn;
- ``class_emb``: {"rows", "dim", "std"} of the class embeddings;
- training only: ``gt`` ({"boxes": n, "side": [lo, hi]}, binary gt of
  object proposals), ``text`` (captions, ``common.captions``) and
  ``draws`` (true: the RPN and ROI samplers' and the spatial dropout's
  uniform draws made on the device from the seed, handed in).

Requests are numpy arrays on the host; the same seed gives the same
requests in the same order.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

import numpy as np
import torch

from . import common

MAX_REQUESTS = 100000


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.params = params
        rng = np.random.default_rng(seed)
        self.class_emb = common.class_emb(rng, params["class_emb"])
        self.order = common.bucket_order(params, rng, MAX_REQUESTS)
        self.pool = {name: [self._batch(rng, bucket)
                            for _ in range(params["pool"])]
                     for name, bucket in sorted(params["buckets"].items())}
        self._uses: Dict[int, int] = {}
        counts = collections.Counter()
        for i, name in enumerate(self.order[:MAX_REQUESTS]):
            self._uses[i] = counts[name]
            counts[name] += 1
        self.draw_seed = seed + 1

    def _batch(self, rng, bucket: dict) -> dict:
        p, b = self.params, self.params["batch"]
        out = {"images": common.images(rng, b, bucket)}
        if "gt" in p:
            out["gt"] = common.binary_gt(rng, b, bucket, p["gt"]["boxes"],
                                         p["gt"]["side"])
        if "text" in p:
            out["text"] = common.captions(rng, b, p["text"])
        return out

    def request(self, i: int) -> Tuple[str, dict]:
        """(bucket, host arrays) of the ``i``-th request."""
        name = self.order[i]
        pool = self.pool[name]
        return name, pool[self._uses[i] % len(pool)]

    def padded(self, name: str) -> Tuple[int, int]:
        return tuple(self.params["buckets"][name]["padded"])


def draw_shapes(cfg, b: int, h: int, w: int, n_gt: int) -> Dict[str, int]:
    """The sizes of a training step's uniform draws on an h x w canvas:
    anchors (15 a location of the stride-16 map), proposals and gt (the
    ROI sampler's candidates), grid cells (stride 32) and sampled ROIs
    (the box pass's spatial dropout)."""
    a = cfg.MODEL.ANCHOR_GENERATOR
    h16, w16 = -(-h // 16), -(-w // 16)
    n_roi = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + (
        n_gt if cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT else 0)
    return {"anchors": h16 * w16 * len(a.SIZES[0]) * len(a.ASPECT_RATIOS[0]),
            "rois": n_roi, "grid": (-(-h16 // 2)) * (-(-w16 // 2)),
            "sampled": cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE}


def draws(shapes: Dict[str, int], b: int, gen: torch.Generator,
          device) -> dict:
    """One training step's uniforms, as the models take them: the RPN
    and ROI samplers' (u_pos, u_neg) pairs and the grid and box spatial
    dropout's keys."""
    def rand(n):
        return torch.rand((b, n), generator=gen, device=device)
    return {"rpn": (rand(shapes["anchors"]), rand(shapes["anchors"])),
            "roi": (rand(shapes["rois"]), rand(shapes["rois"])),
            "grid_drop": rand(shapes["grid"]),
            "box_drop": rand(shapes["sampled"])}
