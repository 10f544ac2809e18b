"""Config tree of the PyTorch port.

The port's own copy of ``locov_tpu/config``: ``locov_torch`` imports
nothing of the JAX package. Key names, the ``TPU.*`` namespace
included (``TPU.COMPUTE_DTYPE`` picks the trunk dtype here too), are
the YAML surface of ``configs/`` and stay as they are.
"""
import importlib
import os
import pkgutil

from .node import CfgNode
from .defaults import get_default_cfg, add_ovr_config
from .config_utils import (auto_scale_workers,
                           edit_output_dir_exp_specific)
from . import extensions


def get_cfg() -> CfgNode:
    """The default tree (``get_default_cfg``, the JAX package's), then
    the ``add_config(cfg)`` of every module of ``extensions/`` in sorted
    name order: the keys, with their defaults, that an architecture
    outside the JAX package reads, one module an architecture."""
    cfg = get_default_cfg()
    for info in sorted(pkgutil.iter_modules(extensions.__path__),
                       key=lambda m: m.name):
        importlib.import_module(
            f"{extensions.__name__}.{info.name}").add_config(cfg)
    return cfg


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config_path(name: str) -> str:
    """Absolute path of a shipped experiment config (``configs/<name>``).

    The repo ships the two stage configs (coco_lsm.yaml / coco_stt.yaml,
    the product surface of the reference's configs/) so the framework is
    fully self-contained; tools and tests resolve them through here
    instead of hard-coding working-directory-relative paths.
    """
    return os.path.join(_REPO_ROOT, "configs", name)


__all__ = [
    "CfgNode", "get_cfg", "get_default_cfg", "add_ovr_config",
    "edit_output_dir_exp_specific", "auto_scale_workers", "config_path",
]
