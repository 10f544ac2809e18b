"""Synthetic micro-COCO dataset generator.

The port's own copy of ``locov_tpu/data/synthetic.py``, on the port's
config and tokenizer: it writes the same tree, byte for byte.
Fabricates a complete, tiny dataset tree in the reference's expected
layout (``datasets_data/``: COCO images + instances + captions,
zero-shot split JSONs, OLN-style proposal pickles, class-embedding
JSON, LVIS-format annotations, tiny BERT vocab) so the ENTIRE
pipeline runs with zero real data. The port's parity tests and
``chip_smoke.py`` (its ``eval_reference`` phase) run on it (the
reference has no equivalent; its smoke-testing requires real COCO on
disk, see SURVEY.md §4)."""
import json
import os
import pickle

import numpy as np
from PIL import Image

CLASS_NAMES = ["cat", "dog", "car"]


def make_micro_coco(root: str, n_train: int = 8, n_val: int = 4,
                    img_size: int = 64, emb_dim: int = 16, seed: int = 0):
    """Fabricate a COCO-format dataset tree under ``root`` matching the
    reference's expected layout (datasets_data/...)."""
    rng = np.random.RandomState(seed)
    dd = os.path.join(root, "datasets_data")
    coco = os.path.join(dd, "coco")
    os.makedirs(os.path.join(coco, "train2017"), exist_ok=True)
    os.makedirs(os.path.join(coco, "val2017"), exist_ok=True)
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(dd, "zero-shot", "coco"), exist_ok=True)
    os.makedirs(os.path.join(dd, "embeddings"), exist_ok=True)
    os.makedirs(os.path.join(dd, "proposals"), exist_ok=True)
    os.makedirs(os.path.join(dd, "bert"), exist_ok=True)

    categories = [{"id": i + 1, "name": n}
                  for i, n in enumerate(CLASS_NAMES)]

    def build_split(split, n, id_base):
        images, annotations, captions = [], [], []
        ann_id = id_base * 1000
        for i in range(n):
            img_id = id_base + i
            h = img_size + (i % 2) * 8
            w = img_size + ((i + 1) % 2) * 8
            arr = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            fname = f"{img_id:012d}.jpg"
            Image.fromarray(arr).save(
                os.path.join(coco, f"{split}2017", fname))
            images.append({"id": img_id, "file_name": fname,
                           "height": h, "width": w})
            for b in range(2):
                x0 = float(rng.randint(0, w // 2))
                y0 = float(rng.randint(0, h // 2))
                bw = float(rng.randint(8, w // 2))
                bh = float(rng.randint(8, h // 2))
                annotations.append({
                    "id": ann_id, "image_id": img_id,
                    "category_id": int(rng.randint(1, 4)),
                    "bbox": [x0, y0, bw, bh], "area": bw * bh,
                    "iscrowd": 0})
                ann_id += 1
            captions.append({
                "id": ann_id, "image_id": img_id,
                "caption": f"a photo of a {CLASS_NAMES[i % 3]} and "
                           f"a {CLASS_NAMES[(i + 1) % 3]}"})
            ann_id += 1
        return images, annotations, captions

    tr_im, tr_an, tr_cap = build_split("train", n_train, 1000)
    va_im, va_an, va_cap = build_split("val", n_val, 2000)

    def dump(path, images, annotations):
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)

    dump(os.path.join(coco, "annotations", "instances_train2017.json"),
         tr_im, tr_an)
    dump(os.path.join(coco, "annotations", "instances_val2017.json"),
         va_im, va_an)
    zs = os.path.join(dd, "zero-shot", "coco")
    for name in ["instances_train2017_seen_2.json"]:
        dump(os.path.join(zs, name), tr_im, tr_an)
    for name in ["instances_val2017_unseen_2.json",
                 "instances_val2017_seen_2.json",
                 "instances_val2017_all_2.json"]:
        dump(os.path.join(zs, name), va_im, va_an)

    for split, caps in [("train", tr_cap), ("val", va_cap)]:
        with open(os.path.join(coco, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": [], "annotations": caps}, f)

    # class-name embeddings
    emb = {n: rng.randn(emb_dim).tolist() for n in CLASS_NAMES}
    with open(os.path.join(dd, "embeddings", "coco_nouns_bertemb.json"),
              "w") as f:
        json.dump(emb, f)

    # OLN-style proposals: [x0,y0,x1,y1,objectness]
    props = []
    for im in tr_im:
        n_p = 6
        boxes = np.zeros((n_p, 5), np.float32)
        for p in range(n_p):
            x0 = rng.randint(0, im["width"] // 2)
            y0 = rng.randint(0, im["height"] // 2)
            boxes[p] = [x0, y0, x0 + rng.randint(8, im["width"] // 2),
                        y0 + rng.randint(8, im["height"] // 2),
                        rng.uniform(0.5, 1.0)]
        props.append((im["id"], boxes))
    for name in ["coco_train2017_seen.pkl", "coco_train2017_voc.pkl"]:
        with open(os.path.join(dd, "proposals", name), "wb") as f:
            pickle.dump(props, f)

    # LVIS-format annotations over the same val images (synonyms +
    # frequency buckets; file names via coco_url like lvis v1)
    lvis_dir = os.path.join(dd, "lvis")
    os.makedirs(lvis_dir, exist_ok=True)
    lvis_cats = [
        {"id": 1, "synonyms": ["cat"], "frequency": "f"},
        {"id": 2, "synonyms": ["dog"], "frequency": "c"},
        {"id": 3, "synonyms": ["car"], "frequency": "r"},
    ]
    def lvis_images(images, split, anns):
        """Federated-dataset knowledge sets: each image verifies one
        absent category as negative and flags its first gt category as
        not-exhaustively annotated on every other image."""
        by_img = {}
        for a in anns:
            by_img.setdefault(a["image_id"], []).append(a["category_id"])
        out = []
        for j, im in enumerate(images):
            present = sorted(set(by_img.get(im["id"], [])))
            absent = [c["id"] for c in lvis_cats
                      if c["id"] not in present]
            out.append({
                "id": im["id"], "height": im["height"],
                "width": im["width"],
                "coco_url": f"http://images.cocodataset.org/"
                            f"{split}2017/{im['file_name']}",
                "neg_category_ids": absent[:1],
                "not_exhaustive_category_ids":
                    present[:1] if j % 2 else []})
        return out
    for split, ims, anns in [("train", tr_im, tr_an),
                             ("val", va_im, va_an)]:
        with open(os.path.join(lvis_dir,
                               f"lvis_v1_{split}.json"), "w") as f:
            json.dump({"images": lvis_images(ims, split, anns),
                       "annotations": anns,
                       "categories": lvis_cats}, f)
    with open(os.path.join(dd, "embeddings",
                           "lvis_v1_nouns_bertemb.json"), "w") as f:
        json.dump({n: rng.randn(emb_dim).tolist()
                   for n in CLASS_NAMES}, f)

    # tiny BERT vocab covering the caption words
    from .tokenization import build_tiny_vocab
    vocab = build_tiny_vocab(
        CLASS_NAMES + ["a", "photo", "of", "and", "black", "image"])
    with open(os.path.join(dd, "bert", "vocab.txt"), "w") as f:
        inv = sorted(vocab, key=vocab.get)
        f.write("\n".join(inv) + "\n")
    return root


def micro_cfg(root: str, arch: str = "OvrRCNN"):
    """A tiny config running the given meta-arch on the micro dataset,
    on the default tree (``get_default_cfg``, the JAX package's), so that
    its dump is the JAX tool's byte for byte."""
    from ..config import get_default_cfg
    cfg = get_default_cfg()
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.DATASETS.ROOT = root
    cfg.OUTPUT_DIR = os.path.join(root, "output")
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = True
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 16
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = True
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 32
    cfg.INPUT.MIN_SIZE_TRAIN = (64,)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 96
    cfg.TPU.IMAGE_BUCKETS = ((96, 96),)
    cfg.TPU.MAX_GT_BOXES = 16
    cfg.TPU.MAX_PRECOMPUTED_PROPOSALS = 8
    cfg.TPU.TEXT_MAX_LEN = 12
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.TEST.IMS_PER_BATCH = 8
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.LOG_PERIOD = 1
    cfg.SOLVER.WARMUP_ITERS = 1
    # raw RPN losses on random init are ~1e4; without clipping a few
    # SGD steps at BASE_LR explode (the reference LSM config also
    # clips, coco_lsm.yaml:112-113)
    cfg.SOLVER.BASE_LR = 0.0001
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 5.0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.vocab_size = 200
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_size = 16
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_hidden_layers = 2
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_attention_heads = 2
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.intermediate_size = 32
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_dropout_prob = 0.0
    return cfg
