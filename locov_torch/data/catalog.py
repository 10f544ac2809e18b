"""Lightweight DatasetCatalog / MetadataCatalog.

The port's own copy of ``locov_tpu/data/catalog.py`` (the port imports
nothing of the JAX package). Stand-in for detectron2's global catalogs
(used throughout the reference's registration code,
``coco_instances.py:4``): a dataset is a callable returning a list of
per-image dicts, metadata is an attribute bag attached per dataset
name.
"""
from __future__ import annotations

from typing import Callable, Dict, List


class _Metadata:
    def __init__(self, name):
        self.name = name

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable] = {}
        self._cache: Dict[str, List[dict]] = {}

    def register(self, name: str, fn: Callable):
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._cache:
            self._cache[name] = self._registry[name]()
        return self._cache[name]

    def __contains__(self, name):
        return name in self._registry

    def clear_cache(self):
        self._cache.clear()

    def remove(self, name):
        self._registry.pop(name, None)
        self._cache.pop(name, None)


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._store:
            self._store[name] = _Metadata(name)
        return self._store[name]

    def __contains__(self, name):
        return name in self._store

    def remove(self, name):
        self._store.pop(name, None)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
