"""Export the detection inference step as a serving artifact.

The twin of the repository's ``tools/export_serving.py``: packages
``OvrRCNN.inference`` (or any meta-arch exposing ``inference``) as a
``torch.export`` program plus the port's checkpoint of its weights (see
``locov_torch/serving.py``). A loaded artifact runs with no model
Python code, on the device kind it was exported on.

Usage:
  python -m locov_torch.tools.export_serving \\
      --config-file configs/coco_stt.yaml \\
      --weights output/locov/stt/model_final \\
      --embeddings datasets_data/embeddings/coco_nouns_bertemb.json \\
      --out exported/stt_serving --batch 8 --height 800 --width 1344 \\
      [--device cpu] [--n-devices N] [KEY VALUE ...]

Omit --weights to export with seeded random weights (shape and trace
validation). ``--device`` is where the program is traced and runs: the
card unless ``cpu`` is given (JAX's ``--platform``). ``TPU.INT8_EVAL``
is not ported (ROADMAP queue 1, item 9) and raises.
"""
import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--weights", default="",
                   help="port checkpoint or torch .pth/.pkl (defaults to "
                        "seeded random weights)")
    p.add_argument("--embeddings", default="",
                   help="class-embedding JSON (name -> vector); random "
                        "embeddings if omitted")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--device", default=None,
                   help="torch device the program is exported on and runs "
                        "on (default: cuda; 'cpu' for the CPU)")
    p.add_argument("--n-devices", type=int, default=1,
                   help="export for N-device serving (the batch split "
                        "over N devices of the --device kind, one copy "
                        "of the program each); N devices must be visible")
    p.add_argument("opts", nargs="*", default=[])
    return p


def visible_devices(device) -> int:
    """How many devices of ``device``'s kind PyTorch sees (the CPU is
    one)."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return torch.cpu.device_count()


def main(argv=None) -> str:
    ap = build_parser()
    args = ap.parse_args(argv)
    import torch

    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.serving import export_inference, load_class_embeddings
    from locov_torch.utils.device import resolve_device
    from locov_torch.utils.weights import seeded_init_

    device = resolve_device(args.device)
    if args.n_devices < 1 or args.n_devices > visible_devices(device):
        ap.error(f"--n-devices {args.n_devices}: "
                 f"{visible_devices(device)} {device.type} devices visible")
    if args.batch % args.n_devices:
        ap.error(f"--batch {args.batch} must divide by --n-devices "
                 f"{args.n_devices}")
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if cfg.TPU.INT8_EVAL:
        raise NotImplementedError(
            "TPU.INT8_EVAL: the int8 serving mode is not ported yet "
            "(ROADMAP queue 1, item 9)")
    model = seeded_init_(build_meta_arch(cfg, device=device), 0)
    if args.weights:
        from locov_torch.utils.checkpoint import load_weights_standalone
        load_weights_standalone(model, args.weights, report_dir=args.out)

    nc = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    dim = cfg.MODEL.ROI_BOX_HEAD.EMB_DIM
    if args.embeddings:
        _, class_emb = load_class_embeddings(args.embeddings)
    else:
        class_emb = torch.from_numpy(np.random.RandomState(0).randn(
            nc + 1, dim).astype(np.float32))
    path = export_inference(model, class_emb.to(device), args.out,
                            args.batch, args.height, args.width,
                            n_devices=args.n_devices)
    print(f"exported: {path}")
    return path


if __name__ == "__main__":
    main()
