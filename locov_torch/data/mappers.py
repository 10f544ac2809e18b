"""Per-sample mappers: raw dataset dict -> fixed-shape numpy record.

The port's own copy of ``locov_tpu/data/mappers.py``. Behavioral ports of the reference mapper stack
(``ovr/data/mappers/basic_mappers.py``, ``coco_mappers.py``,
``detection_utils.py`` noise injectors): image read with black-image
fallback (basic_mappers.py:100-106, caption replaced by "A black
image." :189-190), resize-shortest-edge + flip, strong augs, caption
selection, OLN proposal attachment and ``change_proposals_as_gt``
(objectness > 0.7 proposals become binary-class gt with the real gt
stashed as ``gt_obj``, coco_mappers.py:88-106), label-noise injection
(detection_utils.py:105-213), and host-side tokenization + MLM masking.

The output record is all fixed-size numpy arrays so the collator just
stacks into one static batch per size bucket.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from . import transforms as Tr
from .tokenization import WordPieceTokenizer, apply_mlm_masking


def read_image(path: str, fmt: str = "BGR"):
    """Decode an image file to HWC uint8. cv2 (libjpeg, GIL-free,
    returns BGR directly — the detector's native channel order) with a
    PIL fallback; both wrap the same libjpeg so pixels match."""
    try:
        import cv2
        arr = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR
        if arr is not None:
            if fmt != "BGR":
                arr = arr[:, :, ::-1]
            return np.ascontiguousarray(arr)
    except ImportError:
        pass
    img = Image.open(path).convert("RGB")
    arr = np.asarray(img)
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


# -------------------------------------------------------------- noise (QA)
# Robustness-study label-noise injectors. Faithful ports of the
# reference semantics (ovr/data/detection_utils.py:105-213): boxes here
# are xyxy (the repo convention) but every random draw mirrors the
# reference's xywh-space computation.

def rm_annotation(anns: List[dict], frac: float,
                  rng: random.Random) -> List[dict]:
    """Keep a random int((1-frac)*N) subset; if that would drop below
    one box, keep everything (detection_utils.py:148-161)."""
    n_keep = int((1 - frac) * len(anns))
    if n_keep < 1:
        return anns
    idx_keep = set(rng.sample(range(len(anns)), n_keep))
    return [a for i, a in enumerate(anns) if i in idx_keep]


def add_noise_annotation(anns: List[dict], frac: float, num_classes: int,
                         hw, rng: random.Random) -> List[dict]:
    """Append int(frac*N) (or int(frac) if frac>=1) random boxes with
    random labels; sizes drawn in [dim//6, dim*4//6]
    (detection_utils.py:105-135)."""
    h, w = hw
    n_add = int(frac * len(anns)) if 0 < frac < 1 else int(frac)
    out = list(anns)
    for _ in range(n_add):
        bw = rng.randint(max(w // 6, 1), max(w * 4 // 6, 2))
        bh = rng.randint(max(h // 6, 1), max(h * 4 // 6, 2))
        x = rng.randint(0, max(w - bw - 1, 1))
        y = rng.randint(0, max(h - bh - 1, 1))
        out.append({"bbox": [x, y, x + bw, y + bh],
                    "category_id": rng.randrange(num_classes),
                    "iscrowd": 0, "area": bw * bh, "id": -1})
    return out


def add_noise_cls(anns: List[dict], num_classes: int,
                  rng: random.Random) -> List[dict]:
    """Relabel EVERY box with an independent random class
    (detection_utils.py:137-146)."""
    out = [dict(a) for a in anns]
    for a in out:
        a["category_id"] = rng.randrange(num_classes)
    return out


def add_noise_loc(anns: List[dict], hw,
                  rng: random.Random) -> List[dict]:
    """Jitter EVERY box: origin shifted by up to box_dim//8, size
    changed by up to box_dim//8 and clamped to image_dim-1
    (detection_utils.py:198-213; the reference's noise_loc argument is
    only the activation gate, the jitter amount is fixed at 1/8)."""
    h, w = hw
    out = [dict(a) for a in anns]
    for a in out:
        x0, y0, x1, y1 = a["bbox"]
        bw, bh = x1 - x0, y1 - y0
        dx8, dy8 = max(int(bw) // 8, 0), max(int(bh) // 8, 0)
        nx = max(x0 + rng.randint(-dx8, dx8), 0)
        ny = max(y0 + rng.randint(-dy8, dy8), 0)
        nw = min(bw + rng.randint(-dx8, dx8), w - 1)
        nh = min(bh + rng.randint(-dy8, dy8), h - 1)
        a["bbox"] = [nx, ny, nx + nw, ny + nh]
    return out


def ign_annotation(anns: List[dict], frac: float, num_classes: int,
                   rng: random.Random) -> List[dict]:
    """Offline variant: mark a random complement of int((1-frac)*N)
    kept boxes as ignored by setting category_id to num_classes (the
    reference's len(thing_classes) 'ignore' slot,
    detection_utils.py:163-186); if fewer than one box would survive,
    leave everything untouched."""
    n_keep = int((1 - frac) * len(anns))
    if n_keep < 1:
        return anns
    idx_keep = set(rng.sample(range(len(anns)), n_keep))
    out = [dict(a) for a in anns]
    for i, a in enumerate(out):
        if i not in idx_keep:
            a["category_id"] = num_classes
    return out


def online_ign_annotation(anns: List[dict],
                          thing_classes: List[str]) -> List[dict]:
    """Online variant: any box whose class is literally named 'ignore'
    gets category_id -1 (detection_utils.py:188-196)."""
    out = [dict(a) for a in anns]
    for a in out:
        cid = a["category_id"]
        if 0 <= cid < len(thing_classes) and \
                thing_classes[cid] == "ignore":
            a["category_id"] = -1
    return out


# ------------------------------------------------------------------ mapper
class DetectionMapper:
    """Maps one dataset dict to a fixed-size record.

    Output keys (all numpy):
      image [H, W, 3] float32 (resized, NOT yet padded),
      hw [2], orig_hw [2], image_id scalar,
      gt_boxes [Ngt, 4] f32, gt_classes [Ngt] i32  (variable; collator
      pads to TPU.MAX_GT_BOXES),
      optional: caption str, proposal_boxes/objectness,
      gt_obj_boxes/classes.
    """

    def __init__(self, cfg, metadata, is_train: bool,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 text_max_len: Optional[int] = None,
                 mlm: bool = False, seed: int = 0):
        self.cfg = cfg
        self.metadata = metadata
        self.is_train = is_train
        self.fmt = cfg.INPUT.FORMAT
        self.min_sizes = (tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train
                          else (cfg.INPUT.MIN_SIZE_TEST,))
        self.max_size = (cfg.INPUT.MAX_SIZE_TRAIN if is_train
                         else cfg.INPUT.MAX_SIZE_TEST)
        self.flip_mode = cfg.INPUT.RANDOM_FLIP if is_train else "none"
        self.strong_aug = (Tr.build_strong_augmentation(cfg)
                           if is_train else None)
        self.use_proposals = (cfg.MODEL.LOAD_OBJ_PROPOSALS
                              and metadata.get("object_proposals"))
        self.max_proposals = cfg.TPU.MAX_PRECOMPUTED_PROPOSALS
        # RPN-less meta-arch: proposals are MODEL INPUTS, so the record
        # must carry them past change_proposals_as_gt
        self.emit_proposals = (cfg.MODEL.PROPOSAL_GENERATOR.NAME
                               == "PrecomputedProposals")
        self.tokenizer = tokenizer
        self.text_max_len = text_max_len or cfg.TPU.TEXT_MAX_LEN
        self.mlm = mlm
        t = cfg.MODEL.MMSS_HEAD.TRANSFORMER
        self.mlm_prob = t.MASKED_LANGUAGE_MODELING_PROB
        self.mlm_prob_mask = t.MASKED_LANGUAGE_MODELING_PROB_MASK
        self.mlm_prob_noise = t.MASKED_LANGUAGE_MODELING_PROB_NOISE
        self.mlm_validation = t.MASKED_LANGUAGE_MODELING_VALIDATION
        self.noise = dict(
            offline=cfg.INPUT.NOISE_OFFLINE, bbox=cfg.INPUT.NOISE_BBOX,
            cls=cfg.INPUT.NOISE_CLS, rm=cfg.INPUT.NOISE_RM_BBOX,
            loc=cfg.INPUT.NOISE_LOC, ign=cfg.INPUT.NOISE_IGN)
        # keep the configured seed visible: the process-pool loader
        # derives per-worker seeds from it (loader._proc_init) — without
        # this attribute cfg.SEED silently never reached the workers
        self.seed = seed
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    # .................................................................
    def __call__(self, dataset_dict: dict) -> dict:
        d = dict(dataset_dict)
        rng = self.rng

        loaded = True
        try:
            image = read_image(d["file_name"], self.fmt)
        except Exception:
            image = np.zeros((d.get("height", 480), d.get("width", 640), 3),
                             np.uint8)
            loaded = False
        # WH-swap fix (detection_utils.check_image_size:21-58)
        ih, iw = image.shape[:2]
        if (d.get("width"), d.get("height")) not in (
                (iw, ih), (None, None)):
            d["width"], d["height"] = iw, ih

        anns = [a for a in d.get("annotations", [])
                if a.get("iscrowd", 0) == 0]

        # noise injection — gating mirrors the reference mapper
        # (basic_mappers.py:221-234): cls/loc fire per-sample with
        # probability 1-p; NOISE_IGN>0 activates the online
        # 'ignore'-class pass regardless of NOISE_OFFLINE.
        thing_classes = list(self.metadata.get("thing_classes", []) or [])
        num_classes = len(thing_classes) or 1
        if self.is_train and not self.noise["offline"]:
            if self.noise["rm"] > 0:
                anns = rm_annotation(anns, self.noise["rm"], rng)
            if self.noise["cls"] > 0 and rng.random() > self.noise["cls"]:
                anns = add_noise_cls(anns, num_classes, rng)
            if self.noise["loc"] > 0 and rng.random() > self.noise["loc"]:
                anns = add_noise_loc(anns, (ih, iw), rng)
            if self.noise["bbox"] > 0:
                anns = add_noise_annotation(anns, self.noise["bbox"],
                                            num_classes, (ih, iw), rng)
        if self.noise["ign"] > 0:
            anns = online_ign_annotation(anns, thing_classes)

        # resize (+ flip)
        short = rng.choice(self.min_sizes)
        image_r, _ = Tr.resize_shortest_edge(image, short, self.max_size)
        nh, nw = image_r.shape[:2]
        boxes = np.asarray([a["bbox"] for a in anns],
                           np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in anns], np.int32)
        boxes = Tr.resize_boxes(boxes, (ih, iw), (nh, nw))

        flipped = False
        if self.flip_mode == "horizontal_always" or (
                self.flip_mode == "horizontal" and rng.random() < 0.5):
            # "_always" is the deterministic TTA flip (evaluation/tta.py)
            image_r = Tr.hflip_image(image_r)
            boxes = Tr.hflip_boxes(boxes, nw)
            flipped = True
        elif self.flip_mode == "vertical" and rng.random() < 0.5:
            image_r = Tr.vflip_image(image_r)
            boxes = Tr.vflip_boxes(boxes, nh)
            flipped = True

        boxes = Tr.clip_boxes(boxes, (nh, nw))
        keep = Tr.nonempty_boxes(boxes)
        boxes, classes = boxes[keep], classes[keep]

        if self.strong_aug is not None:
            image_r = self.strong_aug(image_r, rng)

        record = {
            # native dtype (uint8 off the decoder): the float32 cast
            # happens ONCE in collate, fused with batch padding — the
            # per-record astype+pad+stack chain was 3 full-image copies
            # and the single largest host-pipeline cost (measured for
            # the JAX package by its tools/bench_loader.py)
            "image": image_r,
            "hw": np.array([nh, nw], np.int32),
            "orig_hw": np.array([d.get("height", ih), d.get("width", iw)],
                                np.int32),
            "image_id": np.int64(d.get("image_id", 0)),
            "gt_boxes": boxes.astype(np.float32),
            "gt_classes": classes,
        }

        # captions (CocoImageDatasetMapper, coco_mappers.py:44-66)
        captions_dict = self.metadata.get("captions_dict")
        if captions_dict is not None:
            caps = captions_dict.get(d["image_id"], [])
            if caps:
                caption = rng.choice(caps) if self.is_train else caps[0]
            else:
                caption = ""
            if not loaded:
                caption = "A black image."
            record["caption"] = caption

        # OLN proposals: transformed like gt boxes, then (a) emitted as
        # model-input proposals when the meta-arch runs WITHOUT an RPN
        # (reference ovr_rcnn.py:59-61 / distill_prop_mmss_gcnn.py:243-250
        # read batched_inputs["proposals"] when
        # MODEL.PROPOSAL_GENERATOR.NAME == 'PrecomputedProposals'), and
        # (b) converted to binary gt (change_proposals_as_gt,
        # coco_mappers.py:88-106)
        if self.use_proposals:
            proposals = self.metadata.get("object_proposals").get(
                d["image_id"])
            if proposals is not None:
                if isinstance(proposals, list):
                    proposals = proposals[0]
                pboxes = np.asarray(proposals[:, :4], np.float32)
                pobj = np.asarray(proposals[:, 4], np.float32)
                pboxes = Tr.resize_boxes(pboxes, (ih, iw), (nh, nw))
                if flipped and self.flip_mode == "horizontal":
                    pboxes = Tr.hflip_boxes(pboxes, nw)
                elif flipped:
                    pboxes = Tr.vflip_boxes(pboxes, nh)
                pboxes = Tr.clip_boxes(pboxes, (nh, nw))
                nonempty = Tr.nonempty_boxes(pboxes)
                if self.emit_proposals:
                    # model-input proposals: top-K by objectness (d2
                    # transform_proposals semantics,
                    # DATASETS.PRECOMPUTED_PROPOSAL_TOPK_*)
                    keep_p = np.flatnonzero(nonempty)
                    order_p = keep_p[np.argsort(-pobj[keep_p])]
                    order_p = order_p[:self.max_proposals]
                    record["proposal_boxes"] = pboxes[order_p]
                    record["proposal_objectness"] = pobj[order_p]
                sel = (pobj > 0.7) & nonempty
                gboxes, gobj = pboxes[sel], pobj[sel]
                if len(gboxes) > self.max_proposals:
                    order = np.argsort(-gobj)[:self.max_proposals]
                    gboxes, gobj = gboxes[order], gobj[order]
                # real gt stashed aside; proposals become binary gt
                record["gt_obj_boxes"] = record["gt_boxes"]
                record["gt_obj_classes"] = record["gt_classes"]
                record["gt_boxes"] = gboxes
                record["gt_classes"] = np.ones(len(gboxes), np.int32)

        # tokenization + MLM
        if self.tokenizer is not None and "caption" in record:
            ids, attn, special = self.tokenizer.encode(
                record["caption"], self.text_max_len)
            enabled = self.mlm and (self.is_train or self.mlm_validation)
            ids2, target, mlm_mask, special2 = apply_mlm_masking(
                ids, attn, special, self.tokenizer.mask_id,
                len(self.tokenizer), self.np_rng, self.mlm_prob,
                self.mlm_prob_mask, self.mlm_prob_noise, enabled)
            record.update(input_ids=ids2, attention_mask=attn,
                          special_tokens_mask=special2, target_ids=target,
                          mlm_mask=mlm_mask)
        return record
