"""COCO open-vocabulary dataset registration.

The port's own copy of ``locov_tpu/data/datasets/coco.py``. Behavioral
port of ``ovr/data/datasets/coco_instances.py``: named
dataset configs mapping to {img_dir, ann_file, cap_file, obj_prop},
the 48-seen / 17-unseen COCO category split (public constants from the
zero-shot detection literature, coco_instances.py:11-81), caption-dict
attachment, class-embedding-matrix construction with a zero background
row (:240-254), and OLN proposal-pickle loading (:257-262). COCO JSON
is parsed directly (no pycocotools dependency) with d2's
dataset-id -> contiguous-id convention.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog

# 48 seen (base) COCO categories for the zero-shot split
categories_seen = [
    {"id": 1, "name": "person"}, {"id": 2, "name": "bicycle"},
    {"id": 3, "name": "car"}, {"id": 4, "name": "motorcycle"},
    {"id": 7, "name": "train"}, {"id": 8, "name": "truck"},
    {"id": 9, "name": "boat"}, {"id": 15, "name": "bench"},
    {"id": 16, "name": "bird"}, {"id": 19, "name": "horse"},
    {"id": 20, "name": "sheep"}, {"id": 23, "name": "bear"},
    {"id": 24, "name": "zebra"}, {"id": 25, "name": "giraffe"},
    {"id": 27, "name": "backpack"}, {"id": 31, "name": "handbag"},
    {"id": 33, "name": "suitcase"}, {"id": 34, "name": "frisbee"},
    {"id": 35, "name": "skis"}, {"id": 38, "name": "kite"},
    {"id": 42, "name": "surfboard"}, {"id": 44, "name": "bottle"},
    {"id": 48, "name": "fork"}, {"id": 50, "name": "spoon"},
    {"id": 51, "name": "bowl"}, {"id": 52, "name": "banana"},
    {"id": 53, "name": "apple"}, {"id": 54, "name": "sandwich"},
    {"id": 55, "name": "orange"}, {"id": 56, "name": "broccoli"},
    {"id": 57, "name": "carrot"}, {"id": 59, "name": "pizza"},
    {"id": 60, "name": "donut"}, {"id": 62, "name": "chair"},
    {"id": 65, "name": "bed"}, {"id": 70, "name": "toilet"},
    {"id": 72, "name": "tv"}, {"id": 73, "name": "laptop"},
    {"id": 74, "name": "mouse"}, {"id": 75, "name": "remote"},
    {"id": 78, "name": "microwave"}, {"id": 79, "name": "oven"},
    {"id": 80, "name": "toaster"}, {"id": 82, "name": "refrigerator"},
    {"id": 84, "name": "book"}, {"id": 85, "name": "clock"},
    {"id": 86, "name": "vase"}, {"id": 90, "name": "toothbrush"},
]

# 17 unseen (novel) categories
categories_unseen = [
    {"id": 5, "name": "airplane"}, {"id": 6, "name": "bus"},
    {"id": 17, "name": "cat"}, {"id": 18, "name": "dog"},
    {"id": 21, "name": "cow"}, {"id": 22, "name": "elephant"},
    {"id": 28, "name": "umbrella"}, {"id": 32, "name": "tie"},
    {"id": 36, "name": "snowboard"}, {"id": 41, "name": "skateboard"},
    {"id": 47, "name": "cup"}, {"id": 49, "name": "knife"},
    {"id": 61, "name": "cake"}, {"id": 63, "name": "couch"},
    {"id": 76, "name": "keyboard"}, {"id": 81, "name": "sink"},
    {"id": 87, "name": "scissors"},
]

COCO_DATASETS = {
    "coco_captions_train": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/coco/annotations/instances_train2017.json",
        "cap_file": "datasets_data/coco/annotations/captions_train2017.json",
    },
    "coco_captions_val": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/coco/annotations/instances_val2017.json",
        "cap_file": "datasets_data/coco/annotations/captions_val2017.json",
    },
    "coco_captions_train_seen": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_train2017_seen_2.json",
        "cap_file": "datasets_data/coco/annotations/captions_train2017.json",
    },
    "coco_captions_val_seen": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_val2017_seen_2.json",
        "cap_file": "datasets_data/coco/annotations/captions_val2017.json",
    },
    "coco_captions_train_proposals": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/coco/annotations/instances_train2017.json",
        "cap_file": "datasets_data/coco/annotations/captions_train2017.json",
        "obj_prop": "datasets_data/proposals/coco_train2017_voc.pkl",
    },
    "coco_captions_train_seen_proposals": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/coco/annotations/instances_train2017.json",
        "cap_file": "datasets_data/coco/annotations/captions_train2017.json",
        "obj_prop": "datasets_data/proposals/coco_train2017_seen.pkl",
    },
    "coco_train": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/coco/annotations/instances_train2017.json",
    },
    "coco_zeroshot_train": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_train2017_seen_2.json",
    },
    "coco_zeroshot_val": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_val2017_unseen_2.json",
    },
    "coco_generalized_zeroshot_val": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_val2017_all_2.json",
        "cap_file": "datasets_data/coco/annotations/captions_val2017.json",
    },
    "coco_not_zeroshot_val": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_val2017_seen_2.json",
    },
    "coco_zeroshot_plus_unseen_train": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_train2017_all_2.json",
    },
    "coco_2017_train": {
        "img_dir": "datasets_data/coco/train2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_train2017_full.json",
        "cap_file": "datasets_data/coco/annotations/captions_train2017.json",
    },
    "coco_2017_val": {
        "img_dir": "datasets_data/coco/val2017",
        "ann_file": "datasets_data/zero-shot/coco/instances_val2017_full.json",
        "cap_file": "datasets_data/coco/annotations/captions_val2017.json",
    },
}

DEFAULT_EMBEDDINGS = "datasets_data/embeddings/coco_nouns_bertemb.json"


def load_coco_json(json_file: str, image_root: str) -> List[dict]:
    """Minimal reimplementation of d2's ``load_coco_json`` (bbox path):
    returns per-image dicts with file_name, height, width, image_id and
    annotations [{bbox (XYXY abs), category_id (contiguous), iscrowd,
    area, id}], plus metadata side effects via the caller."""
    with open(json_file, "r") as f:
        data = json.load(f)

    cats = sorted(data["categories"], key=lambda c: c["id"])
    thing_classes = [c["name"] for c in cats]
    id_map = {c["id"]: i for i, c in enumerate(cats)}

    anns_by_img: Dict[int, list] = {}
    for ann in data.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    out = []
    for img in data["images"]:
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "annotations": [],
        }
        for ann in anns_by_img.get(img["id"], []):
            if ann.get("ignore", 0) == 1:
                continue
            x, y, w, h = ann["bbox"]
            record["annotations"].append({
                "bbox": [x, y, x + w, y + h],  # XYXY_ABS
                "category_id": id_map[ann["category_id"]],
                "iscrowd": ann.get("iscrowd", 0),
                "area": ann.get("area", w * h),
                "id": ann.get("id", 0),
            })
        out.append(record)
    return out, thing_classes, id_map


def register_dataset(dataset_name: str, root: str = ".") -> None:
    """Port of the reference ``register_dataset``
    (coco_instances.py:193-264)."""
    if dataset_name not in COCO_DATASETS:
        raise NotImplementedError("No paths for dataset " + dataset_name)
    paths = {k: os.path.join(root, v)
             for k, v in COCO_DATASETS[dataset_name].items()}

    meta = MetadataCatalog.get(dataset_name)
    if dataset_name not in DatasetCatalog:
        def loader():
            records, thing_classes, id_map = load_coco_json(
                paths["ann_file"], paths["img_dir"])
            meta.set(thing_classes=thing_classes,
                     thing_dataset_id_to_contiguous_id=id_map,
                     json_file=paths["ann_file"],
                     image_root=paths["img_dir"],
                     evaluator_type="coco")
            return records
        DatasetCatalog.register(dataset_name, loader)

    DatasetCatalog.get(dataset_name)  # force load (sets thing_classes)

    if "cap_file" in paths:
        print("Adding captions for " + dataset_name)
        with open(paths["cap_file"], "r") as f:
            captions_file = json.load(f)
        captions_dict: Dict[int, List[str]] = {}
        for ann in captions_file["annotations"]:
            captions_dict.setdefault(ann["image_id"], []).append(
                ann["caption"])
        meta.set(captions_dict=captions_dict)

    # class-name embeddings -> [K+1, emb_dim] matrix with zero bg row
    noun_emb_file = paths.get(
        "obj_file", os.path.join(root, DEFAULT_EMBEDDINGS))
    if os.path.exists(noun_emb_file):
        print("Adding embeddings for " + dataset_name)
        with open(noun_emb_file, "r") as f:
            noun_embeddings = json.load(f)
        thing_classes = meta.thing_classes
        emb_dim = len(noun_embeddings[next(iter(noun_embeddings))])
        mtx = np.zeros((len(thing_classes) + 1, emb_dim), np.float32)
        for idx, noun in enumerate(thing_classes):
            mtx[idx, :] = np.asarray(noun_embeddings[noun], np.float32)
        meta.set(class_emb_mtx=mtx)

    if "obj_prop" in paths and os.path.exists(paths["obj_prop"]):
        print("Adding object proposals for " + dataset_name)
        with open(paths["obj_prop"], "rb") as f:
            object_proposals = pickle.load(f, encoding="latin1")
        meta.set(object_proposals={s[0]: s[1] for s in object_proposals})
