"""Weights for the port's modules: import from a flat Flax parameter
dict, and seeded random initialisation.

The port's submodules carry the Flax scope names, so a Flax path maps
to a ``state_dict`` key by ``/`` -> ``.`` plus one transform per kind:
a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW), a Dense ``kernel``
([in, out]) becomes a Linear ``weight`` ([out, in]), a LayerNorm
``scale`` becomes ``weight``, and every other leaf (biases, FrozenBN's
four tensors, embedding tables, ``decoder_bias``) is kept as it is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.bert import BertEmbeddings, BertLMHead, Dense
from ..models.resnet import BottleneckBlock, FrozenBatchNorm


def torch_name(path: str) -> str:
    """The ``state_dict`` key of a Flax path: ``/`` -> ``.``, a
    ``kernel`` or ``scale`` leaf -> ``weight``, a leading ``params/``
    collection name dropped."""
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] in ("scale", "kernel"):
        parts[-1] = "weight"
    return ".".join(parts)


def from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax parameters keyed by path (``backbone/res2/0/conv1/
    kernel``) -> a ``state_dict`` for the port's module of the same
    structure, keyed by ``torch_name``."""
    out = {}
    for path, value in flat.items():
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if path.endswith("kernel"):
            if arr.dim() == 4:
                arr = arr.permute(3, 2, 0, 1)
            elif arr.dim() == 2:
                arr = arr.t()
            else:
                raise ValueError(f"{path}: kernel of rank {arr.dim()}")
        out[torch_name(path)] = arr.contiguous()
    return out


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, with the JAX package's initialisers:
    trunk convs He-normal over fan-out (truncated at 2 sigma), RPN convs
    N(0, 0.01), ``emb_pred`` N(0, 0.01), ``bbox_pred`` N(0, 0.001); the
    BERT dense layers and embedding tables N(0, initializer_range);
    ``v2l_projection`` and the other plain Dense layers Flax's
    ``lecun_normal`` (truncated normal over fan-in); biases 0, LayerNorm
    the identity, FrozenBN the identity. Drawn on the CPU from one
    ``torch.Generator`` so that every device gets the same weights."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def truncated(shape, std):
        # the 0.879... undoes the 2-sigma truncation's variance loss
        std = std / 0.87962566103423978
        return torch.nn.init.trunc_normal_(
            torch.empty(shape), std=std, a=-2 * std, b=2 * std,
            generator=gen)

    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm):
            for buf, val in (("weight", 1.0), ("bias", 0.0),
                             ("running_mean", 0.0), ("running_var", 1.0)):
                getattr(mod, buf).fill_(val)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BertEmbeddings):
            for p in (mod.word_embeddings, mod.position_embeddings,
                      mod.token_type_embeddings):
                p.copy_(normal(p.shape, mod.cfg.initializer_range))
        elif isinstance(mod, BertLMHead):
            mod.decoder_bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(mod.weight.shape)
            if isinstance(mod, Dense):
                w = truncated(shape, shape[1] ** -0.5) \
                    if mod.init_std is None else normal(shape, mod.init_std)
            elif isinstance(mod, nn.Linear):
                std = 0.001 if leaf == "bbox_pred" else 0.01
                w = normal(shape, std)
            elif ".rpn_head." in f".{name}.":
                w = normal(shape, 0.01)
            else:
                # variance_scaling(2.0, fan_out, truncated_normal)
                w = truncated(shape, (2.0 / (shape[0] * shape[2] *
                                             shape[3])) ** 0.5)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
    return model


@torch.no_grad()
def trained_scale_(model: nn.Module) -> nn.Module:
    """Give seeded weights the scale of trained ones, so that a
    full-width training step stays finite. Seeded He-normal weights with
    identity FrozenBN make the activations grow about 1.4x a residual
    block and take the 0..255 pixels (PIXEL_STD 1, Caffe) as they are:
    the first loss is ~1e10 and the next step NaN. A trained Caffe stem
    is scaled to raw pixels and a trained block's last FrozenBN scale is
    small; so the stem conv is divided by 57 (about the pixels' std) and
    each block's ``conv3_norm`` scale set to 0.2."""
    model.backbone.stem.conv1.weight.div_(57.0)
    for mod in model.modules():
        if isinstance(mod, BottleneckBlock):
            mod.conv3_norm.weight.fill_(0.2)
    return model
