"""Host-side image/box transforms (numpy + PIL).

The port's own copy of ``locov_tpu/data/transforms.py``, whole (the
evaluation path reads ``resize_shortest_edge`` and the box transforms;
the training loader reads the rest). Replaces detectron2's ``ResizeShortestEdge`` / ``RandomFlip`` transform
stack and the torchvision strong augmentations the reference wires in
(``basic_mappers.py:60-66``, ``detection_utils.py:60-100``). All box
coordinate updates mirror the image ops exactly; images stay HWC numpy
until the collator pads them into a bucket.
"""
from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from PIL import Image, ImageFilter


def resize_shortest_edge(image: np.ndarray, short: int, max_size: int
                         ) -> Tuple[np.ndarray, float]:
    """d2 ResizeShortestEdge semantics: scale so the shorter side equals
    ``short``, then shrink if the longer side would exceed ``max_size``.
    Bilinear (PIL) like d2's default. Returns (image, scale)."""
    h, w = image.shape[:2]
    size = short * 1.0
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        scale2 = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale2, neww * scale2
    newh = int(newh + 0.5)
    neww = int(neww + 0.5)
    if (newh, neww) == (h, w):
        return image, 1.0
    # cv2 INTER_LINEAR, where installed, is several times faster than
    # PIL BILINEAR; enlarging (COCO's 640 x 480 -> 1067 x 800) the two
    # agree to +/-1 LSB (same bilinear math, different rounding — below
    # JPEG-decode noise), shrinking they do not (PIL filters over the
    # source footprint); PIL fallback keeps the path alive without cv2
    try:
        import cv2
        return cv2.resize(image, (neww, newh),
                          interpolation=cv2.INTER_LINEAR), None
    except ImportError:
        pil = Image.fromarray(image)
        pil = pil.resize((neww, newh), Image.BILINEAR)
        return np.asarray(pil), None  # scale via explicit dims


def resize_boxes(boxes: np.ndarray, orig_hw, new_hw) -> np.ndarray:
    """Scale XYXY boxes from orig (h, w) frame to new (h, w) frame."""
    if len(boxes) == 0:
        return boxes
    sy = new_hw[0] * 1.0 / orig_hw[0]
    sx = new_hw[1] * 1.0 / orig_hw[1]
    out = boxes.astype(np.float32).copy()
    out[:, [0, 2]] *= sx
    out[:, [1, 3]] *= sy
    return out


def hflip_image(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[:, ::-1])


def vflip_image(image: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(image[::-1])


def hflip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    if len(boxes) == 0:
        return boxes
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2]
    out[:, 2] = width - boxes[:, 0]
    return out


def vflip_boxes(boxes: np.ndarray, height: int) -> np.ndarray:
    if len(boxes) == 0:
        return boxes
    out = boxes.copy()
    out[:, 1] = height - boxes[:, 3]
    out[:, 3] = height - boxes[:, 1]
    return out


def clip_boxes(boxes: np.ndarray, hw) -> np.ndarray:
    if len(boxes) == 0:
        return boxes
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2], 0, hw[0])
    return out


def nonempty_boxes(boxes: np.ndarray, thr: float = 0.0) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,), bool)
    return ((boxes[:, 2] - boxes[:, 0]) > thr) & \
        ((boxes[:, 3] - boxes[:, 1]) > thr)


# ------------------------------------------------------------------ strong
# SimCLR-style strong augmentations (reference build_complete_augmentation,
# detection_utils.py:60-100) — pure-PIL/numpy equivalents of the
# torchvision transforms (no box changes: they are photometric only).

def color_jitter(image: np.ndarray, strength: float,
                 rng: random.Random) -> np.ndarray:
    """ColorJitter(cj, cj, cj, 0.1) applied with p=0.8."""
    if rng.random() >= 0.8:
        return image
    img = image.astype(np.float32)
    # brightness / contrast / saturation in random order
    ops = ["b", "c", "s", "h"]
    rng.shuffle(ops)
    for op in ops:
        if op == "b":
            f = rng.uniform(max(0, 1 - strength), 1 + strength)
            img = img * f
        elif op == "c":
            f = rng.uniform(max(0, 1 - strength), 1 + strength)
            mean = img.mean()
            img = (img - mean) * f + mean
        elif op == "s":
            f = rng.uniform(max(0, 1 - strength), 1 + strength)
            gray = img.mean(axis=2, keepdims=True)
            img = (img - gray) * f + gray
        elif op == "h":
            # hue shift via PIL HSV roll
            f = rng.uniform(-0.1, 0.1)
            pil = Image.fromarray(
                np.clip(img, 0, 255).astype(np.uint8)).convert("HSV")
            hsv = np.asarray(pil).copy()
            hsv[..., 0] = (hsv[..., 0].astype(int)
                           + int(f * 255)) % 256
            img = np.asarray(
                Image.fromarray(hsv, "HSV").convert("RGB")).astype(
                np.float32)
    return np.clip(img, 0, 255).astype(image.dtype)


def random_grayscale(image: np.ndarray, rng: random.Random,
                     p: float = 0.2) -> np.ndarray:
    if rng.random() >= p:
        return image
    gray = (0.299 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2])
    return np.stack([gray] * 3, axis=-1).astype(image.dtype)


def gaussian_blur(image: np.ndarray, rng: random.Random,
                  p: float = 0.5, sigma=(0.1, 2.0)) -> np.ndarray:
    if rng.random() >= p:
        return image
    s = rng.uniform(*sigma)
    pil = Image.fromarray(image.astype(np.uint8))
    return np.asarray(pil.filter(ImageFilter.GaussianBlur(s)))


def random_erase(image: np.ndarray, rng: random.Random) -> np.ndarray:
    """Three stacked RandomErasing passes (detection_utils.py:81-95)."""
    img = image.copy()
    h, w = img.shape[:2]
    for p, scale, ratio in [(0.7, (0.05, 0.2), (0.3, 3.3)),
                            (0.5, (0.02, 0.2), (0.1, 6.0)),
                            (0.3, (0.02, 0.2), (0.05, 8.0))]:
        if rng.random() >= p:
            continue
        for _ in range(10):
            area = h * w * rng.uniform(*scale)
            r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
            eh = int(round(np.sqrt(area * r)))
            ew = int(round(np.sqrt(area / r)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                y = rng.randrange(0, h - eh)
                x = rng.randrange(0, w - ew)
                img[y:y + eh, x:x + ew] = np.random.randint(
                    0, 256, (eh, ew, img.shape[2]))
                break
    return img


def build_strong_augmentation(cfg):
    """Returns fn(image, rng) or None (mirrors
    build_complete_augmentation, detection_utils.py:60-100)."""
    steps = []
    if cfg.INPUT.COLOR_JITTER > 0:
        cj = cfg.INPUT.COLOR_JITTER
        steps.append(lambda im, r: color_jitter(im, cj, r))
    if cfg.INPUT.RANDOM_GRAY_SCALE:
        steps.append(random_grayscale)
    if cfg.INPUT.GAUSSIAN_BLUR:
        steps.append(gaussian_blur)
    if cfg.INPUT.RANDOM_ERASE:
        steps.append(random_erase)
    if not steps:
        return None

    def apply(image, rng):
        for s in steps:
            image = s(image, rng)
        return image
    return apply
