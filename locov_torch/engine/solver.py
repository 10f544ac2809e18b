"""Optimizer and learning-rate schedule with d2's parameter-group
semantics.

Counterpart of ``locov_tpu/engine/solver.py``: torch-style SGD (momentum,
optional Nesterov) with a per-parameter learning-rate factor and weight
decay (bias lr factor and bias weight decay, no decay on norm
parameters), d2's WarmupMultiStepLR, and gradient clipping by value or
by global norm over the trainable parameters. Frozen parameters
(``BACKBONE.FREEZE_AT`` stages, ``ROI_BOX_HEAD.FREEZE_EMB_PRED``) are
left out of the optimizer, so they have no momentum buffer, and get
``requires_grad=False``, so the backward computes no gradient for them:
what the JAX package's update mask emulates. FrozenBN statistics are
buffers in the port, never parameters.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch


def _warmup_multistep_factor(steps, gamma: float, warmup_factor: float,
                             warmup_iters: int,
                             warmup_method: str = "linear") -> Callable:
    steps = tuple(int(s) for s in steps)

    def factor(step: int) -> float:
        if warmup_method == "linear" and warmup_iters > 0:
            alpha = min(max(step / warmup_iters, 0.0), 1.0)
            wf = warmup_factor * (1.0 - alpha) + alpha
        elif warmup_method == "constant" and warmup_iters > 0:
            wf = warmup_factor if step < warmup_iters else 1.0
        else:
            wf = 1.0
        return wf * gamma ** sum(step >= s for s in steps)
    return factor


def warmup_multistep_lr(base_lr: float, steps, gamma: float,
                        warmup_factor: float, warmup_iters: int,
                        warmup_method: str = "linear") -> Callable:
    """d2 WarmupMultiStepLR as a function step -> learning rate."""
    factor = _warmup_multistep_factor(steps, gamma, warmup_factor,
                                      warmup_iters, warmup_method)
    return lambda step: base_lr * factor(step)


def default_frozen_fn(cfg) -> Callable[[str], bool]:
    """Returns fn(parameter name) -> True where the parameter never
    trains: the stem and res2 .. res{i} under ``BACKBONE.FREEZE_AT``
    (d2 ResNet.freeze); ``emb_pred`` under ``FREEZE_EMB_PRED``
    (box_emb_head.py:141-143 of the reference); the language backbone
    under ``LANGUAGE_BACKBONE.FREEZE``, and all of it but the word
    embeddings without it (transf_models.py:71-76,156-164); the
    transformer head's unused pooler and ``bi_seq_relationship`` under
    ``MMM_LOSS`` "" (transformer_head.py:60-64). Names are the port's
    ``named_parameters`` names. A frozen word-embedding matrix trains
    nowhere: the tied MLM decoder reads the same parameter."""
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_AT
    freeze_emb_pred = cfg.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED
    lang_freeze = cfg.MODEL.LANGUAGE_BACKBONE.FREEZE
    mmm_loss = cfg.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS
    prefixes = ["backbone.stem."] if freeze_at >= 1 else []
    prefixes += [f"backbone.{stage}." for i, stage in
                 enumerate(["res2", "res3", "res4", "res5"], start=2)
                 if freeze_at >= i]

    def frozen(name: str) -> bool:
        parts = name.split(".")
        if any(name.startswith(p) for p in prefixes):
            return True
        if "language_backbone" in parts and (
                lang_freeze or parts[-1] != "word_embeddings"):
            return True
        if mmm_loss == "" and ("bi_seq_relationship" in parts or
                               "transformer_head.pooler." in name):
            return True
        return bool(freeze_emb_pred and "emb_pred" in parts)
    return frozen


def _param_opts(name: str, wd: float, wd_norm: float, bias_lr_factor: float,
                wd_bias: float, base_lr: float,
                overrides: Optional[Dict[str, Dict[str, float]]] = None
                ) -> Tuple[float, float]:
    """(lr factor, weight decay) of one parameter, as the JAX package's
    ``build_optimizer`` derives them from its path: norm parameters take
    ``wd_norm``, biases ``bias_lr_factor`` and ``wd_bias``; then every
    ``overrides`` entry whose key is in the name sets ``lr`` (absolute)
    and ``weight_decay``, later entries over earlier ones. Keys are
    substrings of Flax paths (``/``) or of ``state_dict`` names (``.``);
    a path's ``/`` is read as ``.``."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    lr_factor, decay = 1.0, wd
    if ("norm" in parent.lower() or parent.startswith("LayerNorm")) and \
            leaf in ("scale", "bias", "weight"):
        decay = wd_norm
    elif leaf == "bias":
        lr_factor, decay = bias_lr_factor, wd_bias
    for key, o in (overrides or {}).items():
        if key.replace("/", ".") in name:
            if "lr" in o:
                lr_factor = o["lr"] / base_lr
            decay = o.get("weight_decay", decay)
    return lr_factor, decay


def _clip_hook(params: List[torch.nn.Parameter], clip_cfg):
    """An optimizer step pre-hook: a parameter that got no gradient
    steps with a zero gradient (weight decay and momentum still act, as
    in the JAX package), then the gradients are clipped when
    ``CLIP_GRADIENTS.ENABLED``."""
    kind, value = clip_cfg.CLIP_TYPE, float(clip_cfg.CLIP_VALUE)
    if clip_cfg.ENABLED and kind not in ("value", "norm"):
        raise NotImplementedError(f"SOLVER.CLIP_GRADIENTS.CLIP_TYPE {kind}")

    @torch.no_grad()
    def hook(optimizer, args, kwargs):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if not clip_cfg.ENABLED:
            return
        grads = [p.grad for p in params]
        if kind == "value":
            for g in grads:
                g.clamp_(-value, value)
            return
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        scale = (value / norm.clamp(min=1e-12)).clamp(max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return hook


def build_optimizer(cfg, model: torch.nn.Module,
                    overrides: Optional[Dict[str, Dict[str, float]]] = None):
    """Returns (torch.optim.SGD, LambdaLR) for ``model``'s trainable
    parameters: one param group per (lr factor, weight decay), with
    ``overrides`` ({name substring: {"lr": ..., "weight_decay": ...}},
    JAX's argument) applied as ``_param_opts`` says, the
    schedule ``warmup_multistep_lr`` as a LambdaLR (``scheduler.step()``
    once per optimizer step), and the gradient handling of
    ``_clip_hook`` before each step. Parameters that
    ``default_frozen_fn(cfg)`` names, and parameters that already have
    ``requires_grad=False``, are left out. Training settings the port
    does not implement yet raise."""
    s = cfg.SOLVER
    if int(s.GRADIENT_ACCUMULATION_STEPS) > 1:
        raise NotImplementedError(
            "SOLVER.GRADIENT_ACCUMULATION_STEPS > 1 is not implemented in "
            "the port yet (ROADMAP queue 1, item 6)")
    if cfg.TPU.REMAT_BACKBONE:
        raise NotImplementedError(
            "TPU.REMAT_BACKBONE is not implemented in the port yet "
            "(ROADMAP queue 1, item 6)")
    frozen_fn = default_frozen_fn(cfg)
    wd_bias = s.WEIGHT_DECAY if s.WEIGHT_DECAY_BIAS is None \
        else s.WEIGHT_DECAY_BIAS
    groups: Dict[Tuple[float, float], List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        if frozen_fn(name) or not p.requires_grad:
            p.requires_grad_(False)
            continue
        key = _param_opts(name, s.WEIGHT_DECAY, s.WEIGHT_DECAY_NORM,
                          s.BIAS_LR_FACTOR, wd_bias, s.BASE_LR, overrides)
        groups.setdefault(key, []).append(p)
    optimizer = torch.optim.SGD(
        [{"params": ps, "lr": s.BASE_LR * lf, "weight_decay": dc}
         for (lf, dc), ps in groups.items()],
        lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=s.NESTEROV)
    optimizer.register_step_pre_hook(_clip_hook(
        [p for ps in groups.values() for p in ps], s.CLIP_GRADIENTS))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, _warmup_multistep_factor(
            s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS,
            s.WARMUP_METHOD))
    return optimizer, scheduler


def restore_opt_state(optimizer, scheduler, state: dict) -> None:
    """Restore the optimizer's and the scheduler's ``state_dict``s of a
    checkpoint (``state["optimizer"]``, ``state["scheduler"]``) into the
    ones ``build_optimizer`` built for the same model and config: the
    momentum buffers, each group's learning rate and the schedule's
    step. The counterpart of JAX's ``restore_opt_state``, which rebuilds
    optax's NamedTuples from orbax's dicts; JAX's collapse of a legacy
    full-shape momentum of frozen parameters has no counterpart, as no
    checkpoint of the port predates frozen parameters having no
    momentum."""
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
