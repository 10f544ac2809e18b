"""The PyTorch port's twin of the repository's ``__graft_entry__.py``,
its compile-check and multi-device dry-run entry points:

- ``entry()`` returns the loss step of the flagship image-caption model
  (``DistillProposalMMSSRCNN``) at small widths and its example
  arguments: ``fn(*args)`` is the summed loss of one batch;
- ``dryrun_multichip(n)`` starts ``n`` ranks of ``torch.distributed``
  (gloo, on the CPU, spawned processes) and runs one full data-parallel
  training step (forward, backward, the gradients' all-reduce, SGD) on
  tiny shapes, each rank on its image of the batch; it raises unless
  every rank's loss is finite.

    python -c "from locov_torch import graft_entry as g; \\
        g.dryrun_multichip(2)"
"""
from __future__ import annotations

import numpy as np
import torch


def _build(batch: int = 2, hw: int = 128, text_len: int = 12,
           device=None):
    """(cfg, model, batch, class_emb): ``__graft_entry__._build``'s
    config and arrays, the model with seeded weights on ``device`` (the
    card unless the caller asks for the CPU)."""
    from .config import get_cfg
    from .models import build_meta_arch
    from .structures.batches import (DetectionBatch, GtBatch, ImageBatch,
                                     TextBatch)
    from .utils.device import resolve_device
    from .utils.weights import seeded_init_

    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "DistillProposalMMSSRCNN"
    cfg.MODEL.LANGUAGE_BACKBONE.TYPE = "build_bertemb_backbone"
    cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = True
    cfg.MODEL.MMSS_HEAD.TYPES = ("GroundingHead", "TransformerHead")
    cfg.MODEL.MMSS_HEAD.TIE_VL_PROJECTION_WEIGHTS = True
    cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS = True
    cfg.MODEL.MMSS_HEAD.DISTILLATION_TEACHER_TRANSFORMER = False
    cfg.MODEL.MMSS_HEAD.DISTILLATION_TEMPERATURE = 10.0
    cfg.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = 16
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING = True
    cfg.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS = "cross_entropy"
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR = True
    cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = True
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = True
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 32
    for k, v in dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64,
                     hidden_dropout_prob=0.0).items():
        setattr(cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG, k, v)
        setattr(cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG, k, v)
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"

    dev = resolve_device(device)
    model = seeded_init_(build_meta_arch(cfg, device=dev), 0)

    rng = np.random.RandomState(0)
    b, n_gt, n_tok = batch, 4, text_len

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)
    images = ImageBatch(
        image=t(rng.rand(b, hw, hw, 3).astype(np.float32) * 255),
        hw=t(np.full((b, 2), hw, np.int32)),
        orig_hw=t(np.full((b, 2), hw, np.int32)))
    corner = rng.rand(b, n_gt, 2) * hw / 2
    size = rng.rand(b, n_gt, 2) * hw / 4 + 8
    gt = GtBatch(
        boxes=t(np.concatenate([corner, corner + size], -1)
                .astype(np.float32)),
        classes=t(np.ones((b, n_gt), np.int32)),
        mask=t(np.ones((b, n_gt), bool)))
    special = np.zeros((b, n_tok), np.int32)
    special[:, 0] = 1
    text = TextBatch(
        input_ids=t(rng.randint(5, 500, (b, n_tok)).astype(np.int32)),
        attention_mask=t(np.ones((b, n_tok), np.int32)),
        special_tokens_mask=t(special),
        target_ids=t(rng.randint(5, 500, (b, n_tok)).astype(np.int32)),
        mlm_mask=t(np.zeros((b, n_tok), np.int32)))
    class_emb = t(rng.randn(4, cfg.MODEL.ROI_BOX_HEAD.EMB_DIM)
                  .astype(np.float32))
    return cfg, model, DetectionBatch(images=images, gt=gt,
                                      text=text), class_emb


def entry(device=None):
    """(fn, example_args): ``fn(batch, class_emb, generator)`` is the
    summed loss dict of the tiny LSM model's ``losses`` on ``device``
    (the card unless the caller asks for the CPU)."""
    _, model, batch, class_emb = _build(device=device)
    generator = torch.Generator(device=class_emb.device).manual_seed(0)

    def fn(batch, class_emb, generator):
        _, losses = model.losses(batch, class_emb, generator)
        return sum(losses[k] for k in sorted(losses))

    return fn, (batch, class_emb, generator)


def _dryrun_rank(rank: int, world: int, url: str) -> None:
    """One rank of ``dryrun_multichip``: its image of the batch through
    one training step of the data-parallel ``make_train_step``."""
    import torch.distributed as dist
    from .engine.solver import build_optimizer
    from .parallel.mesh import initialize_distributed, make_train_step
    from .structures.batches import take_rows
    torch.set_num_threads(1)
    initialize_distributed(url, world, rank, "gloo")
    try:
        cfg, model, batch, class_emb = _build(batch=world, hw=64,
                                              text_len=10, device="cpu")
        mine = take_rows(batch, rank, rank + 1)
        step = make_train_step(model, *build_optimizer(cfg, model))
        gen = torch.Generator().manual_seed(rank)
        metrics = step(mine, class_emb, gen)
        total = float(metrics["total_loss"])
        if not np.isfinite(total):
            raise FloatingPointError(f"rank {rank}: non-finite loss: "
                                     f"{metrics}")
        if rank == 0:
            print(f"dryrun_multichip({world}): OK, total_loss={total:.4f}, "
                  f"{len(metrics)} metrics", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel training step over ``n_devices`` gloo ranks on
    the CPU (spawned processes); raises if a rank fails."""
    import torch.multiprocessing as mp
    from .parallel.mesh import local_url
    mp.spawn(_dryrun_rank, args=(n_devices, local_url()), nprocs=n_devices)
