"""The keys of ``ViTDetRCNN`` (``models/meta_arch/vitdet_rcnn.py``) that
the default tree lacks, with Detectron2's defaults for ViTDet-B
(``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py``). LayerNorm
in the pyramid and the box head, and the relative-position bias in every
block, are the model's and take no key."""
from ..node import CfgNode


def add_config(cfg) -> None:
    vit = cfg.MODEL.VIT = CfgNode()
    vit.PATCH_SIZE = 16
    vit.EMBED_DIM = 768
    vit.DEPTH = 12
    vit.NUM_HEADS = 12
    vit.MLP_RATIO = 4.0
    vit.WINDOW_SIZE = 14
    # the blocks that attend within windows; the others are global
    vit.WINDOW_BLOCK_INDEXES = [0, 1, 3, 4, 6, 7, 9, 10]
    # the side that ``pos_embed`` was pretrained at (a cls row first)
    vit.PRETRAIN_IMG_SIZE = 224
    fpn = cfg.MODEL.SIMPLE_FPN = CfgNode()
    fpn.SCALE_FACTORS = [4.0, 2.0, 1.0, 0.5]
    fpn.OUT_CHANNELS = 256
    # every image zero-padded to a square canvas of this side
    fpn.SQUARE_PAD = 1024
    head = cfg.MODEL.ROI_BOX_HEAD
    head.NUM_CONV = 4
    head.CONV_DIM = 256
    head.NUM_FC = 1
    head.FC_DIM = 1024
