"""Generate open-vocabulary annotation splits from full COCO files.

The twin of the repository's ``tools/convert_annotations_to_ov_sets.py``
(a port of the reference tool,
``tools/convert_annotations_to_ov_sets.py:45-108``): writes
instances_{split}2017_{seen_2,unseen_2,all_2,full}.json. The seen file
keeps only seen-category annotations (images without any remaining
annotation are dropped), unseen keeps only unseen-category annotations,
all keeps the union of the 65 OVD categories. Same arguments, same
files, byte for byte.

Usage:
    python -m locov_torch.tools.convert_annotations_to_ov_sets \\
        --ann datasets_data/coco/annotations/instances_val2017.json \\
        --out-dir datasets_data/zero-shot/coco --split val
"""
import argparse
import json
import os

from locov_torch.data.datasets.coco import (categories_seen,
                                            categories_unseen)


def subset(data, keep_cat_ids, drop_empty_images=True):
    keep = set(keep_cat_ids)
    anns = [a for a in data["annotations"] if a["category_id"] in keep]
    img_with_ann = {a["image_id"] for a in anns}
    images = data["images"]
    if drop_empty_images:
        images = [im for im in images if im["id"] in img_with_ann]
    cats = [c for c in data["categories"] if c["id"] in keep]
    return {"images": images, "annotations": anns, "categories": cats,
            **{k: v for k, v in data.items()
               if k not in ("images", "annotations", "categories")}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--split", default="val", choices=["train", "val"])
    args = ap.parse_args(argv)

    with open(args.ann) as f:
        data = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)

    seen_ids = [c["id"] for c in categories_seen]
    unseen_ids = [c["id"] for c in categories_unseen]

    outputs = {
        f"instances_{args.split}2017_seen_2.json": subset(data, seen_ids),
        f"instances_{args.split}2017_unseen_2.json":
            subset(data, unseen_ids),
        f"instances_{args.split}2017_all_2.json":
            subset(data, seen_ids + unseen_ids),
        f"instances_{args.split}2017_full.json": data,
    }
    for name, d in outputs.items():
        path = os.path.join(args.out_dir, name)
        with open(path, "w") as f:
            json.dump(d, f)
        print(f"{path}: {len(d['images'])} images, "
              f"{len(d['annotations'])} annotations, "
              f"{len(d['categories'])} categories")


if __name__ == "__main__":
    main()
