"""Model zoo + meta-architecture registry (counterpart of
``locov_tpu/models/__init__.py``). Every module of ``meta_arch/`` is
imported before a model is built, so that a meta-architecture in a
module of its own registers itself."""
import importlib
import pkgutil

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
    from . import meta_arch
    for info in sorted(pkgutil.iter_modules(meta_arch.__path__),
                       key=lambda m: m.name):
        importlib.import_module(f"{meta_arch.__name__}.{info.name}")
    if name not in META_ARCH_REGISTRY:
        raise KeyError(f"Unknown META_ARCHITECTURE: {name}; "
                       f"available: {sorted(META_ARCH_REGISTRY)}")
    return META_ARCH_REGISTRY[name].from_cfg(cfg, device=device)
