"""PyTorch port vs JAX: the data-parallel training step
(``locov_torch/parallel/mesh.py:make_train_step`` over the ranks of
``torch.distributed``) against JAX's ``make_train_step`` on a 2-device
mesh, in both contrastive scopes, on the tiny image-caption model
(tests/torch_parity.py) at a batch of 4, 2 a rank or device.

Two gloo ranks (spawned processes, ``torch_dp_worker.lsm_rank_worker``)
each take one step from JAX's initial weights, with the draws JAX's
step makes on that device (``fold_in(key, index)`` in the local scope;
the global batch's draws, split by rows, in the global scope), clipping
by global norm low enough to act (on the rank-averaged gradient):

- each scope's updated parameters equal JAX's within 2e-3 of each
  tensor's largest JAX update (tests/test_torch_lsm_step.py's bound)
  plus 2 float32 spacings of its largest parameter (the clipped updates
  are of order 1e-5, and a parameter of order 0.3 rounds at 3e-8), and
  its rank-averaged metrics JAX's within rtol 1e-4 plus 1e-5 (the
  distillation losses are KL divergences of order 1e-2 between nearly
  equal distributions, whose float32 cancellation reaches 4e-6); both
  ranks hold the same parameters, bit for bit;
- local over 2 ranks equals accumulation 2 on one rank over the same 4
  images and draws, and global over 2 ranks equals one rank at batch 4,
  within 1e-5 of each tensor's largest update (float32 sums in another
  order) plus 2 float32 spacings of its largest parameter (the rounding
  of the updated parameter), and the losses within rtol 1e-5;
- the scopes differ: 2 x 2 against 4 x 4 negatives.
"""
import multiprocessing as std_mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import config_path as jpath
from locov_tpu.config import get_cfg as jget
from locov_tpu.engine import solver as jsolver
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.parallel import get_mesh, shard_batch
from locov_tpu.parallel import make_train_step as jmake_train_step
from locov_tpu.structures import batches as jb
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import config_path as tpath
from locov_torch.config import get_cfg as tget
from locov_torch.engine import solver as tsolver
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import local_url, make_train_step
from locov_torch.structures import batches as tb
from locov_torch.structures.batches import take_rows
from locov_torch.utils.weights import from_flax
from test_torch_lsm_step import (N_ANCHORS, N_GRID, N_ROI, N_SAMPLED,
                                 ZERO_BY_SHIFT, _assert_close)
from torch_dp_worker import lsm_rank_worker
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import (flat_params, jax_uniforms, lsm_batch, n, t,
                          tiny_lsm_arrays, tiny_lsm_cfg)

EXTRA = {"SOLVER.BASE_LR": 0.05, "SOLVER.WARMUP_ITERS": 0,
         "SOLVER.CLIP_GRADIENTS.ENABLED": True,
         "SOLVER.CLIP_GRADIENTS.CLIP_TYPE": "norm",
         "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 1.0}
WORLD, B = 2, 4


def _uniforms(key, b):
    """The draws of JAX's ``DistillProposalMMSSRCNN.losses`` from
    ``key`` for a batch of ``b`` (tests/test_torch_lsm_step.py's
    ``loss_uniforms`` at another batch)."""
    r_rpn, r_sample, r_drop, r_box, _, _ = jax.random.split(key, 6)
    return {"rpn": jax_uniforms(r_rpn, b, N_ANCHORS),
            "roi": jax_uniforms(r_sample, b, N_ROI),
            "grid_drop": t(np.asarray(jax.random.uniform(
                r_drop, (b, N_GRID)))),
            "box_drop": t(np.asarray(jax.random.uniform(
                r_box, (b, N_SAMPLED))))}


def _rows(uniforms, start, stop):
    return {k: tuple(x[start:stop] for x in v) if isinstance(v, tuple)
            else v[start:stop] for k, v in uniforms.items()}


def _tmodel(weights, **extra):
    tm = tbuild(tiny_lsm_cfg(tget, tpath, **{**EXTRA, **extra}),
                device="cpu")
    tm.load_state_dict(weights, strict=True)
    return tm


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    parts = [tiny_lsm_arrays(np.random.RandomState(s)) for s in (0, 1)]
    arrays = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    arrays["class_emb"] = parts[0]["class_emb"]
    jbatch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                       jb.DetectionBatch, jnp.asarray)
    tbatch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                       tb.DetectionBatch, t)
    ce = arrays["class_emb"]
    jcfg = tiny_lsm_cfg(jget, jpath, **EXTRA)
    jm = jbuild(jcfg)
    key = jax.random.PRNGKey(3)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jbatch, jnp.asarray(ce), key)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    v = {"params": unflatten_params({k: jnp.asarray(a)
                                     for k, a in flat.items()})}
    weights = from_flax(flat)

    # the draws of JAX's steps: per device in the local scope, of the
    # global batch in the global one
    local = [_uniforms(jax.random.split(jax.random.fold_in(key, r))[0],
                       B // WORLD) for r in range(WORLD)]
    glob = _uniforms(jax.random.split(key)[0], B)
    per = B // WORLD
    data = {"extra": EXTRA, "batch": tbatch, "class_emb": t(ce),
            "weights": weights,
            "uniforms": {"local": local,
                         "global": [_rows(glob, r * per, (r + 1) * per)
                                    for r in range(WORLD)]}}
    tmp = tmp_path_factory.mktemp("dp")
    in_path = str(tmp / "in.pt")
    torch.save(data, in_path)
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    ctx = std_mp.get_context("spawn")
    url = local_url()
    procs = [ctx.Process(target=lsm_rank_worker,
                         args=(r, WORLD, url, in_path, outs[r]))
             for r in range(WORLD)]
    for p in procs:
        p.start()

    # JAX on a 2-device mesh while the ranks run
    mesh = get_mesh(jax.devices()[:WORLD])
    opt = jsolver.build_optimizer(
        jcfg, v, frozen_fn=jsolver.default_frozen_fn(jcfg))[0]
    want = {}
    for scope in ("local", "global"):
        step = jmake_train_step(jm, opt, mesh, contrastive_scope=scope)
        params, _, metrics = step(jax.tree.map(jnp.copy, v), opt.init(v),
                                  shard_batch(jbatch, mesh), jnp.asarray(ce),
                                  key)
        want[scope] = (from_flax(flat_params(params)),
                       {k: float(x) for k, x in metrics.items()})

    # one rank: accumulation 2 over the local draws, and batch 4
    tm = _tmodel(weights, **{"SOLVER.GRADIENT_ACCUMULATION_STEPS": 2})
    cfg = tiny_lsm_cfg(tget, tpath, **EXTRA,
                       **{"SOLVER.GRADIENT_ACCUMULATION_STEPS": 2})
    step = make_train_step(tm, *tsolver.build_optimizer(cfg, tm))
    for r in range(WORLD):
        step(take_rows(tbatch, r * per, (r + 1) * per), t(ce), None,
             local[r])
    accum = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tm = _tmodel(weights)
    step = make_train_step(tm, *tsolver.build_optimizer(
        tiny_lsm_cfg(tget, tpath, **EXTRA), tm))
    m4 = step(tbatch, t(ce), None, glob)
    batch4 = ({k: p.detach().clone() for k, p in tm.named_parameters()},
              {k: float(x) for k, x in m4.items()})

    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0
    ranks = [torch.load(o, weights_only=True) for o in outs]
    return dict(weights=weights, want=want, ranks=ranks, accum=accum,
                batch4=batch4, frozen=tsolver.default_frozen_fn(
                    tiny_lsm_cfg(tget, tpath, **EXTRA)))


def _updates_close(got, want, start, frozen, rtol, ulps):
    """Each tensor's update within ``rtol`` of its largest ``want``
    update, plus ``ulps`` float32 spacings of its largest parameter;
    ``_assert_close``'s shift rule for the gradients that are zero but
    for rounding."""
    moved = 0
    for name, w in want.items():
        if name not in got:
            continue
        d_got = n(got[name]) - n(start[name])
        d_want = n(w) - n(start[name])
        if frozen(name):
            assert (d_got == 0).all() and (d_want == 0).all(), name
            continue
        moved += 1
        if name.endswith(tuple(ZERO_BY_SHIFT)):
            _assert_close(d_got, d_want, name, rtol=rtol)
            continue
        floor = ulps * np.spacing(np.abs(n(start[name])).max())
        err = np.abs(d_got - d_want).max()
        assert err <= rtol * np.abs(d_want).max() + floor, (name, err)
    assert moved > 100


@pytest.mark.parametrize("scope", ["local", "global"])
def test_two_ranks_match_jax_two_device_step(dp, scope):
    r0, r1 = (r[scope] for r in dp["ranks"])
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    want_p, want_m = dp["want"][scope]
    _updates_close(r0["params"], want_p, dp["weights"], dp["frozen"], 2e-3,
                   ulps=2)
    assert set(r0["metrics"]) == set(want_m)
    for k, w in want_m.items():
        np.testing.assert_allclose(r0["metrics"][k], w, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_local_over_two_ranks_is_accumulation_two_on_one(dp):
    _updates_close(dp["ranks"][0]["local"]["params"], dp["accum"],
                   dp["weights"], dp["frozen"], 1e-5, ulps=2)


def test_global_over_two_ranks_is_one_rank_at_the_whole_batch(dp):
    got = dp["ranks"][0]["global"]
    params, metrics = dp["batch4"]
    _updates_close(got["params"], params, dp["weights"], dp["frozen"], 1e-5,
                   ulps=2)
    for k, w in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_the_scopes_differ(dp):
    local = dp["ranks"][0]["local"]["metrics"]
    glob = dp["ranks"][0]["global"]["metrics"]
    for k in ("Image Caption Matching Loss", "Box Image Caption Matching "
              "Loss", "CE_loss (Align Words, Choose Caption)"):
        assert abs(local[k] - glob[k]) > 1e-3 * abs(glob[k]), k
