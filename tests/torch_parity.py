"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU, in float32, on
the same numpy inputs and the same weights (Flax parameters flattened
by path and loaded with ``locov_torch.utils.weights.from_flax``).
TF32 is off for both matmuls and convolutions, so float32 means float32
on every backend (it has no effect on the CPU, where these tests run).
"""
import numpy as np
import pytest
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tiny widths: every stage of the C4 trunk, narrow channels
TINY = {
    "MODEL.META_ARCHITECTURE": "OvrRCNN",
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.ROI_HEADS.NUM_CLASSES": 5,
    "MODEL.ROI_BOX_HEAD.EMBEDDING_BASED": True,
    "MODEL.ROI_BOX_HEAD.EMB_DIM": 8,
    "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG": True,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 64,
    "MODEL.RPN.POST_NMS_TOPK_TEST": 16,
    "TEST.DETECTIONS_PER_IMAGE": 10,
    "TPU.COMPUTE_DTYPE": "float32",
}


def tiny_cfg(get_cfg, **extra):
    """A tiny OvrRCNN config from either package's ``get_cfg``."""
    cfg = get_cfg()
    for key, value in {**TINY, **extra}.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def flat_params(variables):
    """Flax variables -> {path: numpy array} of the ``params``
    collection (``locov_tpu.utils.checkpoint.flatten_params``)."""
    import jax
    from locov_tpu.utils.checkpoint import flatten_params
    return {k: np.asarray(v) for k, v in
            flatten_params(jax.device_get(variables["params"])).items()}


def load_flax(module, variables):
    """Load Flax ``variables`` into the port's ``module`` (strict)."""
    from locov_torch.utils.weights import from_flax
    module.load_state_dict(from_flax(flat_params(variables)), strict=True)
    return module


def t(x, dtype=None):
    """numpy -> torch on the CPU."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch or jax -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_uniforms(key, b, n_):
    """The uniform draws of the JAX package's per-image samplers for
    ``key``: ``split(key, b)``, then per image ``k_pos, k_neg = split(k)``
    and ``uniform(k_pos, (n_,))``, ``uniform(k_neg, (n_,))`` -> the
    port's (u_pos, u_neg), each [b, n_]."""
    import jax
    pos, neg = [], []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kp, (n_,))))
        neg.append(np.asarray(jax.random.uniform(kn, (n_,))))
    return t(np.stack(pos)), t(np.stack(neg))


def jax_grounding_draws(gcfg, key, b, w, r):
    """The draws of the JAX package's ``GroundingHead`` for its ``rng``
    ``key`` (B captions of W words, B images of R regions), as the
    port's ``draws``: the random alignments split ``key`` into (k1, k2)
    and draw ``uniform(k, shape, minval=tiny)`` of [B, B, W, R] (words)
    and [B, B, R, W] (regions), ``jax.random.categorical``'s Gumbel
    draws; random negative mining splits ``key`` into (k1, k2) too, each
    into (kc, ki), and draws ``randint(k, (B,), 0, B - 1)``."""
    import jax
    draws = {}
    k1, k2 = jax.random.split(key)
    if gcfg.alignment in ("random_categorical", "random_top3"):
        tiny = np.finfo(np.float32).tiny
        for name, k, shape, on in (
                ("align_words", k1, (b, b, w, r), gcfg.align_words),
                ("align_regions", k2, (b, b, r, w), gcfg.align_regions)):
            if on:
                draws[name] = t(np.asarray(jax.random.uniform(
                    k, shape, minval=tiny, maxval=1.0)))
    if gcfg.loss_type == "triplet" and gcfg.negative_mining == "random" \
            and b > 1:
        for name, k, on in (("neg_words", k1, gcfg.align_words),
                            ("neg_regions", k2, gcfg.align_regions)):
            if on:
                draws[name] = tuple(
                    t(np.asarray(jax.random.randint(kk, (b,), 0, b - 1)))
                    for kk in jax.random.split(k))
    return draws


# the image-caption (LSM) model at tiny widths: coco_lsm.yaml with the
# trunk above, a 2-layer BERT of width 16 over a vocabulary of 50 for
# both the language backbone and the joint encoder, dropout off, at most
# 8 regions an image; a torchvision-like pixel std keeps activations of
# order 1
TINY_LSM = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.PIXEL_STD": [57.375, 57.12, 58.395],
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 12,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 48,
    "MODEL.RPN.POST_NMS_TOPK_TRAIN": 24,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 48,
    "MODEL.RPN.POST_NMS_TOPK_TEST": 16,
    "MODEL.MMSS_HEAD.SPATIAL_DROPOUT": 8,
    "MODEL.ROI_BOX_HEAD.EMB_DIM": 16,
    "TEST.DETECTIONS_PER_IMAGE": 8,
    "TPU.COMPUTE_DTYPE": "float32",
}
TINY_BERT = {"vocab_size": 50, "hidden_size": 16, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 32,
             "max_position_embeddings": 16, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0}
LSM_B, LSM_H, LSM_W, LSM_L = 2, 96, 128, 8


def tiny_lsm_cfg(get_cfg, config_path, **extra):
    """The tiny LSM config from either package's ``get_cfg`` and
    ``config_path``."""
    cfg = get_cfg()
    cfg.merge_from_file(config_path("coco_lsm.yaml"))
    for key, value in {**TINY_LSM, **extra}.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    for node in (cfg.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG,
                 cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG):
        for key, value in TINY_BERT.items():
            setattr(node, key, value)
    return cfg


def tiny_lsm_arrays(rng):
    """One tiny LSM batch as numpy arrays: two images (the second with a
    smaller valid size, so that its grid has fewer valid cells than
    SPATIAL_DROPOUT), binary gt (OLN proposals as class 1, padded), and
    captions with padding, special tokens and one MLM target; plus a
    [81, 16] class-embedding matrix x0.1 with a zero background row."""
    b, h, w, n_tok = LSM_B, LSM_H, LSM_W, LSM_L
    ids = rng.randint(5, 50, size=(b, n_tok)).astype(np.int32)
    attn = np.ones((b, n_tok), np.int32)
    attn[1, 6:] = 0
    special = np.zeros((b, n_tok), np.int32)
    special[:, 0] = 1
    special[0, 7] = 1
    special[1, 5:] = 1
    mlm = np.zeros((b, n_tok), np.int32)
    mlm[0, 3] = 1
    mlm[1, 2] = 1
    ce = (rng.randn(81, 16) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    return dict(
        image=(rng.rand(b, h, w, 3) * 255).astype(np.float32),
        hw=np.array([[96, 128], [64, 80]], np.int32),
        orig_hw=np.array([[192, 256], [128, 160]], np.int32),
        gt_boxes=np.array([[[4, 4, 40, 30], [10, 20, 70, 60],
                            [50, 8, 120, 90]],
                           [[8, 8, 24, 24], [30, 10, 70, 50],
                            [0, 0, 0, 0]]], np.float32),
        gt_classes=np.ones((b, 3), np.int32),
        gt_mask=np.array([[True, True, True], [True, True, False]]),
        input_ids=ids, attention_mask=attn, special_tokens_mask=special,
        target_ids=ids.copy(), mlm_mask=mlm, class_emb=ce)


def lsm_batch(arrays, ImageBatch, GtBatch, TextBatch, DetectionBatch,
              conv):
    """The batch of ``tiny_lsm_arrays`` in either package's containers,
    each array through ``conv``."""
    a = {k: conv(v) for k, v in arrays.items()}
    return DetectionBatch(
        images=ImageBatch(image=a["image"], hw=a["hw"],
                          orig_hw=a["orig_hw"]),
        gt=GtBatch(a["gt_boxes"], a["gt_classes"], a["gt_mask"]),
        text=TextBatch(a["input_ids"], a["attention_mask"],
                       a["special_tokens_mask"], a["target_ids"],
                       a["mlm_mask"]))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for the module's tests, then the process's
    setting again: the trainer tests run many small ops, and with one
    thread per core in each of the suite's workers they spend their time
    waiting on the others. Imported by the test files that use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
