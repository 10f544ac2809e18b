"""Model zoo + meta-architecture registry (counterpart of
``locov_tpu/models/__init__.py``)."""

META_ARCH_REGISTRY = {}


def register_meta_arch(name):
    def deco(cls):
        META_ARCH_REGISTRY[name] = cls
        return cls
    return deco


def build_meta_arch(cfg, device=None):
    """The ``cfg.MODEL.META_ARCHITECTURE`` model on ``device``: ``cuda``
    unless the caller passes ``device="cpu"``; raises when no GPU is
    present and the CPU was not asked for."""
    name = cfg.MODEL.META_ARCHITECTURE
    # imported here to avoid an import cycle with the registry
    from .meta_arch import mmss_gcnn, ovr_rcnn, vitdet_rcnn  # noqa: F401
    if name not in META_ARCH_REGISTRY:
        raise KeyError(f"Unknown META_ARCHITECTURE: {name}; "
                       f"available: {sorted(META_ARCH_REGISTRY)}")
    return META_ARCH_REGISTRY[name].from_cfg(cfg, device=device)
