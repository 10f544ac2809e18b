"""Run open-vocabulary detection on image files and visualize it.

The twin of the repository's ``tools/demo.py``: cfg + weights +
class-name embeddings -> drawn detections, with the eval-time
preprocessing (resize-shortest-edge into the static test bucket, the
bucket set the evaluator uses), one image a batch.

Usage:
  python -m locov_torch.tools.demo --config-file configs/coco_stt.yaml \\
      --weights output/locov/stt/model_final \\
      --embeddings datasets_data/embeddings/coco_nouns_bertemb.json \\
      --input img1.jpg img2.jpg --output demo_out \\
      [--confidence-threshold 0.5] [--device cpu] [KEY VALUE ...]

Writes ``<output>/<name>.jpg`` (boxes + class + score burned in) and
``<output>/<name>.json`` (the raw detections) per input. Omit --weights
for a seeded random-weight smoke run; omit --embeddings to label classes
by index. ``--device``: the card unless ``cpu`` is given.
"""
import argparse
import json
import os

import numpy as np

# BGR palette (distinct hues, dark enough for white label text)
COLORS = [(180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214),
          (189, 103, 148), (75, 86, 140), (194, 119, 227), (127, 127, 127),
          (34, 189, 188), (207, 190, 23)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", default="")
    p.add_argument("--embeddings", default="",
                   help="class-name -> vector JSON; classes labeled by "
                        "index if omitted")
    p.add_argument("--input", nargs="+", required=True,
                   help="image file paths")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--confidence-threshold", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the CPU)")
    p.add_argument("opts", nargs="*", default=[])
    return p


def draw(image_bgr: np.ndarray, dets: list) -> np.ndarray:
    """Burn boxes/labels into a BGR uint8 image (cv2, PIL where cv2 is
    not installed)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        from PIL import Image, ImageDraw
        im = Image.fromarray(image_bgr[:, :, ::-1])
        dr = ImageDraw.Draw(im)
        for d in dets:
            color = tuple(COLORS[d["class_index"] % len(COLORS)][::-1])
            dr.rectangle(d["bbox_xyxy"], outline=color, width=2)
            dr.text((d["bbox_xyxy"][0], max(0, d["bbox_xyxy"][1] - 12)),
                    f"{d['class_name']} {d['score']:.2f}", fill=color)
        return np.asarray(im)[:, :, ::-1]
    out = image_bgr.copy()
    for d in dets:
        x0, y0, x1, y1 = [int(round(v)) for v in d["bbox_xyxy"]]
        color = COLORS[d["class_index"] % len(COLORS)]
        cv2.rectangle(out, (x0, y0), (x1, y1), color, 2)
        label = f"{d['class_name']} {d['score']:.2f}"
        (tw, th), base = cv2.getTextSize(
            label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = y0 - 4 if y0 - th - base - 4 >= 0 else y1 + th + base + 4
        cv2.rectangle(out, (x0, ty - th - base), (x0 + tw, ty + base),
                      color, -1)
        cv2.putText(out, label, (x0, ty), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return out


def write_image(path: str, image_bgr: np.ndarray) -> None:
    try:
        import cv2
    except ImportError:
        from PIL import Image
        Image.fromarray(image_bgr[:, :, ::-1]).save(path)
        return
    cv2.imwrite(path, image_bgr)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import torch

    from locov_torch.config import get_cfg
    from locov_torch.data import transforms as Tr
    from locov_torch.data.loader import (_pad_image, _pick_bucket,
                                         derive_buckets)
    from locov_torch.data.mappers import read_image
    from locov_torch.models import build_meta_arch
    from locov_torch.serving import load_class_embeddings
    from locov_torch.structures.batches import (DetectionBatch,
                                                ImageBatch, to_torch)
    from locov_torch.utils.device import resolve_device
    from locov_torch.utils.weights import seeded_init_

    device = resolve_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.MODEL.WEIGHTS = ""  # loaded explicitly below
    model = seeded_init_(build_meta_arch(cfg, device=device), 0)
    if args.weights:
        from locov_torch.utils.checkpoint import load_weights_standalone
        load_weights_standalone(model, args.weights,
                                report_dir=args.output)

    if args.embeddings:
        names, class_emb = load_class_embeddings(args.embeddings)
    else:
        nc = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        dim = cfg.MODEL.ROI_BOX_HEAD.EMB_DIM
        names = [f"class_{i}" for i in range(nc)]
        class_emb = torch.from_numpy(np.random.RandomState(0).randn(
            nc + 1, dim).astype(np.float32))
    class_emb = class_emb.to(device)

    buckets = derive_buckets(cfg, is_train=False)
    os.makedirs(args.output, exist_ok=True)
    for path in args.input:
        img = read_image(path, cfg.INPUT.FORMAT)  # BGR uint8
        oh, ow = img.shape[:2]
        resized, _ = Tr.resize_shortest_edge(
            img, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
        nh, nw = resized.shape[:2]
        padded = _pad_image(resized, _pick_bucket((nh, nw), buckets))
        batch = to_torch(DetectionBatch(images=ImageBatch(
            image=padded.astype(np.float32)[None],
            hw=np.asarray([[nh, nw]], np.int32),
            orig_hw=np.asarray([[oh, ow]], np.int32))), device)
        d = model.inference(batch, class_emb)
        boxes, scores, classes, mask = (x[0].cpu().numpy() for x in d)
        keep = mask & (scores >= args.confidence_threshold)
        dets = [{
            "bbox_xyxy": [float(v) for v in boxes[i]],
            "score": float(scores[i]),
            "class_index": int(classes[i]),
            "class_name": (names[int(classes[i])]
                           if int(classes[i]) < len(names)
                           else f"class_{int(classes[i])}"),
        } for i in np.nonzero(keep)[0]]

        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(args.output, stem + ".json"), "w") as f:
            json.dump({"file": path, "detections": dets}, f, indent=1)
        out_img = os.path.join(args.output, stem + ".jpg")
        write_image(out_img, draw(img, dets))
        print(f"{path}: {len(dets)} detections >= "
              f"{args.confidence_threshold} -> {out_img}")


if __name__ == "__main__":
    main()
