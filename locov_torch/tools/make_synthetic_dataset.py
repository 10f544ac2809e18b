"""Generate a synthetic micro-COCO dataset + ready-to-run config.

The twin of the repository's ``tools/make_synthetic_dataset.py``:
fabricates a complete tiny dataset tree in the reference's expected
layout (``locov_torch/data/synthetic.py``) and writes a ``micro.yaml``
tuned to it, so that train -> eval -> export runs with no real data.
Same arguments, same files, byte for byte:

    python -m locov_torch.tools.make_synthetic_dataset --out /tmp/demo
    python -m locov_torch.train_ovnet --config-file /tmp/demo/micro.yaml
    python -m locov_torch.train_ovnet --config-file /tmp/demo/micro.yaml \\
        --eval-only
"""
import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True,
                   help="directory for the dataset tree + micro.yaml")
    p.add_argument("--n-train", type=int, default=8)
    p.add_argument("--n-val", type=int, default=4)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arch", default="OvrRCNN",
                   choices=["OvrRCNN", "DistillProposalMMSSRCNN",
                            "MMSSGridModel", "DistillMMSSGridModel"],
                   help="meta-architecture for the emitted config")
    args = p.parse_args(argv)

    from locov_torch.data.synthetic import make_micro_coco, micro_cfg

    root = os.path.abspath(args.out)
    os.makedirs(root, exist_ok=True)
    make_micro_coco(root, n_train=args.n_train, n_val=args.n_val,
                    img_size=args.img_size, seed=args.seed)

    cfg = micro_cfg(root, arch=args.arch)
    if args.arch == "OvrRCNN":
        cfg.DATASETS.TRAIN = ("coco_zeroshot_train",)
        cfg.DATASETS.TEST = ("coco_zeroshot_val",)
    else:
        # language-model stages train on the captioned split with OLN
        # proposals; tiny BERT dims matching the generated vocab
        cfg.DATASETS.TRAIN = ("coco_captions_train_seen_proposals",)
        cfg.DATASETS.TEST = ()
        cfg.MODEL.LOAD_OBJ_PROPOSALS = True
        cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = True
        cfg.MODEL.LANGUAGE_BACKBONE.TYPE = "build_bertemb_backbone"
        bc = cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG
        bc.vocab_size, bc.hidden_size = 200, 16
        bc.num_hidden_layers, bc.num_attention_heads = 2, 2
        bc.intermediate_size = 32
        cfg.MODEL.MMSS_HEAD.TYPES = ("GroundingHead", "TransformerHead")
        cfg.MODEL.MMSS_HEAD.TIE_VL_PROJECTION_WEIGHTS = True
        cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS = True
        cfg.MODEL.MMSS_HEAD.DISTILLATION_TEACHER_TRANSFORMER = False
        cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = 6
        cfg.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING = True
        cfg.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS = "cross_entropy"
        cfg.MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR = True
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    yaml_path = os.path.join(root, "micro.yaml")
    with open(yaml_path, "w") as f:
        f.write(cfg.dump())
    print(f"dataset tree: {root}/datasets_data")
    print(f"config:       {yaml_path}")
    print("run:          python -m locov_torch.train_ovnet --config-file "
          f"{yaml_path}")


if __name__ == "__main__":
    main()
