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
    """The detector from the given proposals: the reference's RPN
    logits, each proposal's class probabilities and refined box in the
    original image's frame, and the detections
    (``fast_rcnn_inference_batched``), as ``OvrRCNN._inference`` computes
    them."""
    from .locov_ref.models.box_predictor import fast_rcnn_inference_batched
    from .locov_ref.structures import boxes as box_ops
    images = batch.images
    x = model.preprocess(images)
    features = model.backbone(x)["res4"]
    _, logits, _ = model.run_rpn(features)
    feats = model.roi_heads.roi_features(features, proposals.boxes)
    scores, deltas = model.roi_heads.predict(feats.float(),
                                             class_emb.float())
    dets = fast_rcnn_inference_batched(scores, deltas, proposals.boxes,
                                       proposals.mask, images.hw,
                                       model.pcfg)
    scale = images.orig_hw.float() / images.hw.float()

    def to_orig(b):
        b = box_ops.scale(b, scale[:, None, 1], scale[:, None, 0])
        return box_ops.clip(b, (images.orig_hw[:, 0:1],
                                images.orig_hw[:, 1:2]))
    boxes = box_ops.apply_deltas(deltas, proposals.boxes,
                                 model.pcfg.bbox_reg_weights)
    boxes = box_ops.clip(boxes, (images.hw[:, 0:1], images.hw[:, 1:2]))
    return {"logits": logits, "probs": torch.softmax(scores, -1)[..., :-1],
            "boxes": to_orig(boxes), "valid": proposals.mask,
            "det_boxes": to_orig(dets.boxes), "det_scores": dets.scores,
            "det_classes": dets.classes, "det_mask": dets.mask}
