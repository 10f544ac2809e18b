"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU, in float32, on
the same numpy inputs and the same weights (Flax parameters flattened
by path and loaded with ``locov_torch.utils.weights.from_flax``).
TF32 is off for both matmuls and convolutions, so float32 means float32
on every backend (it has no effect on the CPU, where these tests run).
"""
import numpy as np
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
