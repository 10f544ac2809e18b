"""What the reference computes, on the frozen plain copy
(``reference/locov_ref``): the training step and the inference of the
detector from given proposals. Imports nothing of the program."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def forced_proposals(module, given: List):
    """The model's ``select_proposals`` (in ``module``) replaced by the
    given proposals, one a call in turn: the reference follows the
    program's proposals (the NMS keep set flips on a rounding), and the
    selection is checked on its own (``select_proposals`` of the
    program's RPN outputs). Where the program's call held fewer images
    than the reference's, the rest keep the reference's own selection."""
    orig = module.select_proposals
    it = iter(given)

    def forced(*args, **kwargs):
        g = next(it)
        n = g.boxes.shape[0]
        if n == args[1].shape[0]:
            return g
        own = orig(*args, **kwargs)
        return type(own)(*(torch.cat([a, b[n:]]) for a, b in zip(g, own)))
    module.select_proposals = forced
    try:
        yield
    finally:
        module.select_proposals = orig


def train_step(model, optimizer, scheduler, batch, class_emb, generator,
               uniforms) -> torch.Tensor:
    """One plain training step: the losses' sum in key order, its
    backward, one SGD and one schedule step. Returns the total loss."""
    optimizer.zero_grad(set_to_none=True)
    res = model.losses(batch, class_emb, generator, uniforms,
                       deterministic=False)
    losses = res[1] if isinstance(res, tuple) else res
    total = sum(losses[k] for k in sorted(losses))
    total.backward()
    optimizer.step()
    scheduler.step()
    return total.detach()


@torch.inference_mode()
def detect(model, batch, class_emb, proposals) -> Dict[str, torch.Tensor]:
    """The reference model's detector from the given proposals (the
    program's): ``model.detect_from_proposals``.

    The contract between an inference cell's meta-architecture and the
    check (``check.infer_numbers``), which holds for every family:

    - the reference model (``reference/locov_ref/models/meta_arch/``)
      has ``detect_from_proposals(batch, class_emb, proposals)``, which
      runs its own features, levels and heads from the given proposals
      and returns ``logits`` (the RPN's objectness [B, N_a], levels
      flattened in the order the program flattens them), ``probs``
      [B, N, K] (the background dropped), ``boxes`` [B, N, 4] (each
      proposal's refined box, original frame), ``valid`` [B, N] and the
      detections ``det_boxes`` (original frame), ``det_scores``,
      ``det_classes``, ``det_mask``;
    - the modules of the program's and of the reference's
      meta-architecture each expose ``select_proposals(anchors, logits,
      deltas, image_hw, rpn_cfg, training)``, which the model calls once
      a batch by that module-level name, with anchors [N_a, 4], logits
      [B, N_a] and deltas [B, N_a, 4] flattened over the levels, and the
      models carry the ``rpn_cfg`` it takes (``loops.captured``,
      ``check.proposals_differ``);
    - a trained model trains through ``losses(batch, class_emb,
      generator, uniforms, deterministic=...)``, a dict of losses
      (``train_step``)."""
    return model.detect_from_proposals(batch, class_emb, proposals)
