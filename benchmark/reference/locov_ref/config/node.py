"""A minimal yacs-style config tree.

The reference drives everything off a frozen yacs ``CfgNode``
(detectron2.config + the reference's ovr/config/config.py). This is a
self-contained reimplementation of the surface actually used there:
attribute access, YAML merge, ``KEY VALUE`` list merge with
``literal_eval`` coercion (train_ovnet.py:49-56 in the reference), clone,
and freeze/defrost.
"""
from __future__ import annotations

import ast
import copy
from typing import Any, List

import yaml


class CfgNode(dict):
    """Nested dict with attribute access and yacs-compatible merging."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            super().__setitem__(k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        self[name] = value

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        super().__setitem__(name, value)

    # -- freeze ------------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return getattr(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v.clone()
            else:
                out[k] = copy.deepcopy(v)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, path: str, allow_unsafe: bool = True) -> None:
        import os
        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        # d2-style config inheritance: merge the base file first, then
        # this file's overrides on top (used by coco_lsm_global.yaml)
        base = loaded.pop("_BASE_", None)
        if base:
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(os.path.abspath(path)),
                                    base)
            self.merge_from_file(base, allow_unsafe)
        _merge_into(CfgNode(loaded), self, [])

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for k in keys[:-1]:
                if k not in node:
                    raise KeyError(f"Non-existent key: {full_key}")
                node = node[k]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_value(v)
            value = _check_and_coerce(value, node[leaf], full_key)
            dict.__setitem__(node, leaf, value)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), default_flow_style=False)

    def __str__(self) -> str:
        return self.dump()


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _decode_value(v: Any) -> Any:
    """yacs-style value decoding: strings that parse as python literals
    become those literals (so ``"(a, b)"`` in YAML becomes a tuple)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce(replacement, original, full_key):
    """Allow tuple<->list coercion and None; otherwise require same type."""
    if original is None or replacement is None:
        return replacement
    if isinstance(replacement, tuple) and isinstance(original, list):
        return list(replacement)
    if isinstance(replacement, list) and isinstance(original, tuple):
        return tuple(replacement)
    if isinstance(original, float) and isinstance(replacement, int):
        return float(replacement)
    return replacement


def _merge_into(src: CfgNode, dst: CfgNode, key_path: List[str]) -> None:
    for k, v in src.items():
        full = ".".join(key_path + [str(k)])
        v = _decode_value(v)
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full}")
        if isinstance(v, (dict, CfgNode)) and isinstance(dst[k], CfgNode):
            _merge_into(CfgNode(v) if not isinstance(v, CfgNode) else v,
                        dst[k], key_path + [str(k)])
        else:
            dict.__setitem__(dst, k, _check_and_coerce(v, dst[k], full))
