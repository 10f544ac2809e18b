"""PyTorch port vs JAX: the C4 trunk (stem, a bottleneck stage, the
whole ResNetC4) and the res5 box-head stage, with the same weights.

Tolerance: rtol 1e-4 (atol 1e-4 * max|out|). Float32 convolutions sum
in another order in XLA:CPU and in PyTorch's CPU kernels; the folded
BN and a dozen layers compound that to about 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from locov_tpu.models import resnet as jres
from locov_torch.config import get_cfg as tget
from locov_torch.models import resnet as tres
from torch_parity import load_flax, n, t

TOL = 1e-4


def _randomize_bn(variables, rng):
    """Non-trivial FrozenBN statistics, so the fold is exercised."""
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    leaves = []
    for path, v in flat:
        name = str(path[-1])
        v = np.asarray(v)
        if "running_var" in name:
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif "running_mean" in name or "bias" in name:
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif "weight" in name:
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        leaves.append(jnp.asarray(v))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables), leaves)


def _close(got, want):
    want = n(want)
    np.testing.assert_allclose(n(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def test_stem_matches_flax(rng):
    x = rng.randn(2, 32, 40, 3).astype(np.float32) * 50
    jm = jres.ResNetStem(8, compute_dtype=jnp.float32)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = load_flax(tres.ResNetStem(8), v)
    _close(tm(t(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("stride,stride_in_1x1", [(2, True), (1, True),
                                                  (2, False)])
def test_stage_matches_flax(rng, stride, stride_in_1x1):
    x = rng.randn(2, 12, 10, 16).astype(np.float32)
    jm = jres.ResNetStage(2, 8, 32, first_stride=stride,
                          stride_in_1x1=stride_in_1x1,
                          compute_dtype=jnp.float32)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    tm = load_flax(tres.ResNetStage(2, 16, 8, 32, first_stride=stride,
                                    stride_in_1x1=stride_in_1x1), v)
    _close(tm(t(x)), jm.apply(v, jnp.asarray(x)))


def test_c4_trunk_matches_flax(rng):
    x = rng.randn(2, 64, 48, 3).astype(np.float32) * 50
    kw = dict(out_features=("res2", "res4"), stem_out_channels=8,
              res2_out_channels=32, width_per_group=8)
    jm = jres.ResNetC4(compute_dtype=jnp.float32, **kw)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    tm = load_flax(tres.ResNetC4(**kw), v)
    got, want = tm(t(x)), jm.apply(v, jnp.asarray(x))
    assert set(got) == set(want) == {"res2", "res4"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        _close(got[k], want[k])


def test_res5_stage_from_cfg_matches_flax(rng):
    from locov_tpu.config import get_cfg as jget
    cfgs = []
    for get in (jget, tget):
        cfg = get()
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
        cfgs.append(cfg)
    x = rng.randn(6, 14, 14, 64).astype(np.float32)
    jm = jres.build_res5_stage(cfgs[0], jnp.float32)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), rng)
    tm = load_flax(tres.build_res5_stage(cfgs[1]), v)
    out = tm(t(x))
    assert tuple(out.shape) == (6, 7, 7, 128)
    _close(out, jm.apply(v, jnp.asarray(x)))
