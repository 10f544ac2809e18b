"""Weights for the port's modules: import from a flat Flax parameter
dict, and seeded random initialisation.

The port's submodules carry the Flax scope names, so a Flax path maps
to a ``state_dict`` key by ``/`` -> ``.`` plus one transform per kind:
a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW), a Dense ``kernel``
([in, out]) becomes a Linear ``weight`` ([out, in]), and every other
leaf (biases, FrozenBN's four tensors) is kept as it is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.resnet import FrozenBatchNorm


def from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax parameters keyed by path (``backbone/res2/0/conv1/
    kernel``; a leading ``params/`` collection name is dropped) -> a
    ``state_dict`` for the port's module of the same structure."""
    out = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if arr.dim() == 4:
                arr = arr.permute(3, 2, 0, 1)
            elif arr.dim() == 2:
                arr = arr.t()
            else:
                raise ValueError(f"{path}: kernel of rank {arr.dim()}")
        out[".".join(parts)] = arr.contiguous()
    return out


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, with the JAX package's initialisers:
    trunk convs He-normal over fan-out (truncated at 2 sigma), RPN convs
    N(0, 0.01), ``emb_pred`` N(0, 0.01), ``bbox_pred`` N(0, 0.001),
    biases 0, FrozenBN the identity. Drawn on the CPU from one
    ``torch.Generator`` so that every device gets the same weights."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm):
            for buf, val in (("weight", 1.0), ("bias", 0.0),
                             ("running_mean", 0.0), ("running_var", 1.0)):
                getattr(mod, buf).fill_(val)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(mod.weight.shape)
            if isinstance(mod, nn.Linear):
                std = 0.001 if leaf == "bbox_pred" else 0.01
                w = normal(shape, std)
            elif ".rpn_head." in f".{name}.":
                w = normal(shape, 0.01)
            else:
                fan_out = shape[0] * shape[2] * shape[3]
                # variance_scaling(2.0, fan_out, truncated_normal): the
                # 0.879... undoes the truncation's variance loss
                std = (2.0 / fan_out) ** 0.5 / 0.87962566103423978
                w = torch.nn.init.trunc_normal_(
                    torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                    generator=gen)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
    return model
