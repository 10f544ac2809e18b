"""Seeded input builders shared by the traffic generators: the image
buckets and their order, images, binary gt, captions and class
embeddings. Seeded copies of the port's ``tools/bench.py`` builders
(``_images``, ``lsm_inputs``, ``build_stt_eval``), with the bucket mix
of COCO that ``chip_smoke.py:_synthetic_images`` takes.

Every array is numpy on the host, drawn from a ``numpy.random.Generator``
that the caller seeds; the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def bucket_order(params: dict, rng: np.random.Generator, n: int
                 ) -> List[str]:
    """``n`` bucket names: ``params["first"]`` (one of each shape, so
    that set-up meets every shape), then blocks of ``params["block"]``
    ({bucket: count}), each shuffled. Every seed gets the same counts in
    a block, in another order."""
    order = list(params["first"])
    block = [name for name, k in sorted(params["block"].items())
             for _ in range(k)]
    while len(order) < n:
        order.extend(rng.permutation(block).tolist())
    return order[:n]


def images(rng: np.random.Generator, b: int, bucket: dict) -> Dict:
    """``b`` images of one bucket as ``collate`` pads them: 8-bit pixels
    uniform in 0..255 (as float32) inside the valid ``bucket["valid"]``
    (h, w) of the ``bucket["padded"]`` canvas, zeros outside; ``orig_hw``
    the size before the resize."""
    hp, wp = bucket["padded"]
    hv, wv = bucket["valid"]
    img = np.zeros((b, hp, wp, 3), np.float32)
    img[:, :hv, :wv] = rng.integers(0, 256, (b, hv, wv, 3), dtype=np.uint8)
    return {"image": img,
            "hw": np.tile(np.array([[hv, wv]], np.int32), (b, 1)),
            "orig_hw": np.tile(np.array([bucket["orig"]], np.int32), (b, 1))}


def binary_gt(rng: np.random.Generator, b: int, bucket: dict, n: int,
              side: List[float]) -> Dict:
    """``n`` object proposals an image as binary gt (class 1 of the
    LSM's one foreground class, every slot valid): sides uniform in
    ``side`` px, inside the valid image."""
    hv, wv = bucket["valid"]
    wh = rng.uniform(side[0], side[1], (b, n, 2))
    lim = np.array([wv, hv], np.float64)
    wh = np.minimum(wh, lim - 1)
    xy = rng.random((b, n, 2)) * (lim - wh)
    return {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "classes": np.ones((b, n), np.int32),
            "mask": np.ones((b, n), bool)}


def captions(rng: np.random.Generator, b: int, text: dict) -> Dict:
    """Tokenized captions in ``text["slots"]`` slots: [CLS], a number of
    words uniform in ``text["words"]``, [SEP], padding; word ids uniform
    in ``text["ids"]``; each word masked for MLM with probability
    ``text["mlm"]``, at least one a caption (the target is the word)."""
    slots = text["slots"]
    ids = rng.integers(text["ids"][0], text["ids"][1], (b, slots),
                       dtype=np.int64).astype(np.int32)
    attn = np.zeros((b, slots), np.int32)
    special = np.ones((b, slots), np.int32)
    mlm = np.zeros((b, slots), np.int32)
    for i in range(b):
        words = int(rng.integers(text["words"][0], text["words"][1] + 1))
        attn[i, :words + 2] = 1
        special[i, 1:words + 1] = 0
        masked = rng.random(words) < text["mlm"]
        if not masked.any():
            masked[rng.integers(words)] = True
        mlm[i, 1:words + 1] = masked
    return {"input_ids": ids, "attention_mask": attn,
            "special_tokens_mask": special, "target_ids": ids.copy(),
            "mlm_mask": mlm}


def class_emb(rng: np.random.Generator, spec: dict) -> np.ndarray:
    """[rows, dim] class embeddings N(0, std^2), the last row the
    background."""
    return (rng.standard_normal((spec["rows"], spec["dim"]),
                                dtype=np.float32) * spec["std"])
