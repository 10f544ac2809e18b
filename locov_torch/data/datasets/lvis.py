"""LVIS v1 open-vocabulary dataset registration.

The port's own copy of ``locov_tpu/data/datasets/lvis.py``. Behavioral
port of ``ovr/data/datasets/lvis_instances.py``: named
configs layered as common + split + dataset-specific
(lvis_instances.py:19-64,280-296), frequency-based base (c, f) /
novel (r) category filtering with contiguous-id remapping (:197-227),
caption glob-merge across caption files (:163-195), OLN proposal
attachment (:229-246), and class-embedding matrices with a zero
background row (:260-278). LVIS json is parsed directly — category
entries carry ``synonyms`` (first synonym is the class name) and
``frequency`` in {'r','c','f'}; image file names derive from
``coco_url``.
"""
from __future__ import annotations

import copy
import glob
import json
import logging
import os
import pickle
from typing import Dict, List

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger(__name__)

LVIS_DATASETS = {
    "common_dict": {
        "img_dir": "datasets_data/coco/",
        "cap_file": "datasets_data/coco/annotations/captions_*2017.json",
    },
    "common_train_dict": {
        "ann_file": "datasets_data/lvis/lvis_v1_train.json"},
    "common_val_dict": {
        "ann_file": "datasets_data/lvis/lvis_v1_val.json"},
    "lvis_v1_caption_train_proposals": {
        "obj_prop": "datasets_data/proposals/coco_train2017_seen.pkl",
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_caption_train": {
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_caption_val": {
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_instance_v1_train": {},
    "lvis_instance_v1_val": {},
    "lvis_v1_all_train": {
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_base_train": {
        "obj_set": ["c", "f"],
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_generalized_val": {
        "obj_set": ["all"],
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_novel_val": {
        "obj_set": ["r"],
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
    "lvis_v1_base_val": {
        "obj_set": ["c", "f"],
        "obj_file": "datasets_data/embeddings/lvis_v1_nouns_bertemb.json"},
}


def load_lvis_json(json_file: str, image_root: str):
    """Parse LVIS v1 json: returns (records, categories). File names are
    derived from each image's coco_url (d2 load_lvis_json convention)."""
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    anns_by_img: Dict[int, list] = {}
    for ann in data.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in data["images"]:
        url = img.get("coco_url", "")
        # ".../train2017/000000123.jpg" -> "train2017/000000123.jpg"
        rel = "/".join(url.split("/")[-2:]) if url else img.get(
            "file_name", "")
        rec = {
            "file_name": os.path.join(image_root, rel),
            "height": img["height"], "width": img["width"],
            "image_id": img["id"],
            "neg_category_ids": img.get("neg_category_ids", []),
            "not_exhaustive_category_ids": img.get(
                "not_exhaustive_category_ids", []),
            "annotations": [],
        }
        for ann in anns_by_img.get(img["id"], []):
            x, y, w, h = ann["bbox"]
            rec["annotations"].append({
                "bbox": [x, y, x + w, y + h],
                "category_id": id_map[ann["category_id"]],
                "iscrowd": 0,
                "area": ann.get("area", w * h),
                "id": ann.get("id", 0),
            })
        records.append(rec)
    return records, cats


def register_dataset(dataset_name: str, root: str = ".") -> None:
    if dataset_name not in LVIS_DATASETS:
        raise NotImplementedError("No paths for dataset " + dataset_name)
    paths = copy.deepcopy(LVIS_DATASETS["common_dict"])
    common = ("common_val_dict" if "_val" in dataset_name
              else "common_train_dict")
    paths.update(LVIS_DATASETS[common])
    paths.update(LVIS_DATASETS[dataset_name])
    if "caption" not in dataset_name:
        paths.pop("cap_file", None)
    paths = {k: (os.path.join(root, v) if isinstance(v, str) else v)
             for k, v in paths.items()}

    if dataset_name in DatasetCatalog:
        DatasetCatalog.get(dataset_name)
        return
    meta = MetadataCatalog.get(dataset_name)

    def loader():
        records, cats = load_lvis_json(paths["ann_file"],
                                       paths["img_dir"])
        thing_classes = [c["synonyms"][0] if "synonyms" in c
                         else c["name"] for c in cats]
        freq_classes: Dict[str, List[str]] = {}
        for c, name in zip(cats, thing_classes):
            if "frequency" in c:
                freq_classes.setdefault(c["frequency"], []).append(name)
        id_map = {c["id"]: i for i, c in enumerate(cats)}

        obj_set = paths.get("obj_set")
        if obj_set:
            consider = set()
            for s in obj_set:
                if s in ("r", "c", "f"):
                    consider |= set(freq_classes.get(s, []))
                elif s == "all":
                    consider = set(thing_classes)
            keep_idx = [i for i, n in enumerate(thing_classes)
                        if n in consider]
            remap = {old: new for new, old in enumerate(keep_idx)}
            new_classes = [thing_classes[i] for i in keep_idx]
            inv_id = {v: k for k, v in id_map.items()}
            new_id_map = {inv_id[old]: new for old, new in remap.items()}
            for rec in records:
                rec["annotations"] = [
                    {**a, "category_id": remap[a["category_id"]]}
                    for a in rec["annotations"]
                    if a["category_id"] in remap]
            thing_classes = new_classes
            id_map = new_id_map

        meta.set(thing_classes=thing_classes, freq_classes=freq_classes,
                 thing_dataset_id_to_contiguous_id=id_map,
                 json_file=paths["ann_file"],
                 image_root=paths["img_dir"], evaluator_type="lvis")

        # captions (glob merge, lvis_instances.py:169-186)
        cap_file = paths.get("cap_file")
        if cap_file:
            captions: Dict[int, List[str]] = {}
            for f in sorted(glob.glob(cap_file)):
                with open(f) as fh:
                    capd = json.load(fh)
                for ann in capd["annotations"]:
                    captions.setdefault(ann["image_id"], []).append(
                        ann["caption"])
            meta.set(captions_dict=captions)

        if "obj_prop" in paths and os.path.exists(paths["obj_prop"]):
            with open(paths["obj_prop"], "rb") as f:
                props = pickle.load(f, encoding="latin1")
            meta.set(object_proposals={int(s[0]): s[1] for s in props})

        obj_file = paths.get("obj_file")
        if obj_file and os.path.exists(obj_file):
            with open(obj_file) as f:
                noun_embeddings = json.load(f)
            emb_dim = len(noun_embeddings[next(iter(noun_embeddings))])
            mtx = np.zeros((len(thing_classes) + 1, emb_dim), np.float32)
            for i, n in enumerate(thing_classes):
                if n in noun_embeddings:
                    mtx[i] = np.asarray(noun_embeddings[n], np.float32)
            meta.set(class_emb_mtx=mtx)
        return records

    DatasetCatalog.register(dataset_name, loader)
    DatasetCatalog.get(dataset_name)
