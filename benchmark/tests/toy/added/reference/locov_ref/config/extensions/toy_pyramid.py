"""The keys of ``ToyPyramidRCNN`` (``models/meta_arch/toy_pyramid.py``)
that the default tree lacks, with their defaults."""
from ..node import CfgNode


def add_config(cfg) -> None:
    cfg.MODEL.TOY_PYRAMID = CfgNode()
    cfg.MODEL.TOY_PYRAMID.CHANNELS = 16  # the trunk's and the pyramid's
