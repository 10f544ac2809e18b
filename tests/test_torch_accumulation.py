"""PyTorch port vs JAX: gradient accumulation
(``SOLVER.GRADIENT_ACCUMULATION_STEPS``, ``locov_torch/engine/solver.py:
MultiSteps`` against ``locov_tpu/engine/solver.py``'s optax.MultiSteps).

A toy module (a layer, a LayerNorm, a head: weights, biases and norm
parameters, so every weight-decay and lr-factor rule acts) with the
same seeded gradients on both sides, k = 3 micro-steps an update, SGD
with momentum, weight decay, a bias lr factor, warm-up and a step of the
schedule, and clipping by global norm low enough to act on the mean:

- parameters and momentum equal JAX's after k and 2k micro-steps, and
  do not move in between; tolerance 1e-5 of each tensor's largest
  update (float32: the clip's global norm is summed in another order,
  and a parameter of order 0.2 rounds at 1.5e-8, 1.5e-6 of an update
  of 0.01);
- the learning rate of every micro-step is JAX's ``schedule(it)``
  (iteration // k inside), within rtol 1e-6;
- a parameter without a gradient on a micro-step takes part as zeros;
- a resume in the middle of an accumulation (the optimizer's and the
  scheduler's ``state_dict``s through ``torch.save``/``torch.load`` into
  a fresh optimizer) goes on bit for bit: parameters, momentum,
  accumulated gradients and micro-step count.

The JAX side is JAX's one-step optimizer inside ``optax.MultiSteps``,
which is what JAX's ``build_optimizer`` means to build for k > 1: its
own build rebinds the name ``schedule`` to ``step // k`` after defining
the inner update, which reads that name when it runs, so its updates
take the schedule at update // k (iteration // k^2) while its trainer
logs iteration // k. The port applies and logs iteration // k, the
reference's per-update schedule of its 8-GPU run;
``test_jax_build_optimizer_applies_the_schedule_at_update_over_k``
pins the JAX behaviour.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from locov_tpu.config import get_cfg as jget
from locov_tpu.engine import solver as jsolver
from locov_torch.config import get_cfg as tget
from locov_torch.engine import solver as tsolver

K = 3
NO_GRAD_AT = (1, "head.bias")  # (micro-step, parameter) without gradient


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer = nn.Linear(4, 3)
        self.norm = nn.LayerNorm(3)
        self.head = nn.Linear(3, 2)


def _cfg(get):
    cfg = get()
    s = cfg.SOLVER
    s.BASE_LR, s.MOMENTUM, s.WEIGHT_DECAY = 0.1, 0.9, 0.01
    s.WEIGHT_DECAY_NORM, s.BIAS_LR_FACTOR = 0.0, 2.0
    s.WARMUP_ITERS, s.WARMUP_FACTOR, s.STEPS, s.GAMMA = 1, 0.5, (2,), 0.1
    s.CLIP_GRADIENTS.ENABLED = True
    s.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.5
    s.GRADIENT_ACCUMULATION_STEPS = K
    return cfg


def _model():
    torch.manual_seed(0)
    return Toy()


def _grads(n_steps):
    rng = np.random.RandomState(1)
    shapes = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    return [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n_steps)]


def _port_steps(model, opt, sched, grads, start=0):
    """Micro-steps ``start:`` of ``grads``; (params, momentum, lr) after
    each (lr as applied at that micro-step)."""
    out = []
    for i, g in enumerate(grads[start:], start):
        lr = [grp["lr"] for grp in opt.param_groups]
        for name, p in model.named_parameters():
            p.grad = None if (i, name) == NO_GRAD_AT else torch.from_numpy(
                g[name].copy())
        if opt.step():
            sched.step()
        out.append(({k: v.detach().clone() for k, v in
                     model.named_parameters()},
                    {k: opt.state[p]["momentum_buffer"].clone()
                     for k, p in model.named_parameters()
                     if "momentum_buffer" in opt.state[p]}, lr))
    return out


def _jax_tx(params, multisteps=True):
    """(tx, schedule): JAX's one-step optimizer in optax.MultiSteps and
    its schedule at iteration // k (``multisteps``), or JAX's own build
    for k."""
    cfg = _cfg(jget)
    if not multisteps:
        return jsolver.build_optimizer(cfg, params)
    cfg.SOLVER.GRADIENT_ACCUMULATION_STEPS = 1
    inner, schedule = jsolver.build_optimizer(cfg, params)
    ms = optax.MultiSteps(inner, every_k_schedule=K)
    return (optax.GradientTransformation(ms.init, ms.update),
            lambda it: schedule(it // K))


def _jax_steps(params, grads, multisteps=True):
    tx, schedule = _jax_tx(params, multisteps)
    state = tx.init(params)
    out = []
    for i, g in enumerate(grads):
        tree = {"params": {mod: {leaf: jnp.asarray(
            0 * g[f"{mod}.{leaf}"] if (i, f"{mod}.{leaf}") == NO_GRAD_AT
            else g[f"{mod}.{leaf}"]) for leaf in leaves}
            for mod, leaves in params["params"].items()}}
        updates, state = tx.update(tree, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        flat = {f"{m}.{leaf}": np.asarray(v) for m, leaves in
                params["params"].items() for leaf, v in leaves.items()}
        mom = {f"{m}.{leaf}": np.asarray(v) for m, leaves in
               state.inner_opt_state.momentum["params"].items()
               for leaf, v in leaves.items()}
        out.append((flat, mom, float(schedule(i))))
    return out


def _jax_params(flat):
    params = {"params": {}}
    for k, v in flat.items():
        mod, leaf = k.split(".")
        params["params"].setdefault(mod, {})[leaf] = jnp.asarray(v)
    return params


def test_accumulation_matches_optax_multisteps():
    grads = _grads(2 * K)
    model = _model()
    start = {k: v.detach().numpy().copy() for k, v in
             model.named_parameters()}
    opt, sched = tsolver.build_optimizer(_cfg(tget), model)
    assert isinstance(opt, tsolver.MultiSteps)
    got = _port_steps(model, opt, sched, grads)
    want = _jax_steps(_jax_params(start), grads)
    base = _cfg(tget).SOLVER.BASE_LR
    before, jbefore = start, start
    for i, ((gp, gm, glr), (wp, wm, wlr)) in enumerate(zip(got, want)):
        # the lr of the first group (factor 1) at this micro-step
        g0 = opt.param_groups[0]
        np.testing.assert_allclose(glr[0] / g0["initial_lr"] * base, wlr,
                                   rtol=1e-6, err_msg=f"lr at {i}")
        for k in wp:
            if (i + 1) % K:
                assert np.array_equal(gp[k].numpy(), before[k]), (i, k)
                assert np.array_equal(wp[k], jbefore[k]), (i, k)
                continue
            upd = np.abs(wp[k] - jbefore[k]).max()
            assert upd > 0, (i, k)
            assert np.abs(gp[k].numpy() - wp[k]).max() <= 1e-5 * upd, (i, k)
            assert np.abs(gm[k].numpy() - wm[k]).max() <= \
                1e-5 * np.abs(wm[k]).max(), (i, k)
        if (i + 1) % K == 0:
            before = {k: v.numpy() for k, v in gp.items()}
            jbefore = wp
    # the schedule steps once per effective batch: warm-up, then the
    # step at update 2
    lrs = [w[2] for w in want]
    assert lrs[:K] == [lrs[0]] * K and lrs[K:] == [lrs[K]] * K
    assert lrs[0] < lrs[K]


def test_resume_in_the_middle_of_an_accumulation_is_bit_exact():
    grads = _grads(2 * K)
    model = _model()
    opt, sched = tsolver.build_optimizer(_cfg(tget), model)
    straight = _port_steps(model, opt, sched, grads)[-1]

    model = _model()
    opt, sched = tsolver.build_optimizer(_cfg(tget), model)
    _port_steps(model, opt, sched, grads[:K + 1])
    assert opt.mini_step == 1
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "scheduler": sched.state_dict()}, buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)

    model2 = _model()
    model2.load_state_dict(state["model"])
    opt2, sched2 = tsolver.build_optimizer(_cfg(tget), model2)
    tsolver.restore_opt_state(opt2, sched2, state)
    assert opt2.mini_step == 1 and sched2.last_epoch == 1
    for a, b in zip(opt2.acc, opt.acc):
        assert torch.equal(a, b)
    assert any(bool(a.abs().max() > 0) for a in opt2.acc)
    resumed = _port_steps(model2, opt2, sched2, grads, start=K + 1)[-1]
    for k in straight[0]:
        assert torch.equal(resumed[0][k], straight[0][k]), k
        assert torch.equal(resumed[1][k], straight[1][k]), k
    assert opt2.mini_step == 0


def test_one_step_optimizer_is_plain_sgd():
    """k = 1 keeps torch's SGD (no accumulation state in checkpoints)."""
    cfg = _cfg(tget)
    cfg.SOLVER.GRADIENT_ACCUMULATION_STEPS = 1
    opt, _ = tsolver.build_optimizer(cfg, _model())
    assert type(opt) is torch.optim.SGD
    assert "multi_steps" not in opt.state_dict()


def test_jax_build_optimizer_applies_the_schedule_at_update_over_k():
    """JAX's own build for k > 1: the second update of the toy run
    applies the warm-up factor of update 0 (the schedule read at update
    // k), where the intended schedule (and the port) has left the
    warm-up; the first update is the same in both."""
    grads = _grads(2 * K)
    start = {k: v.detach().numpy().copy() for k, v in
             _model().named_parameters()}
    own = _jax_steps(_jax_params(start), grads, multisteps=False)
    meant = _jax_steps(_jax_params(start), grads)
    k = "layer.weight"
    assert np.array_equal(own[K - 1][0][k], meant[K - 1][0][k])
    step_own = np.abs(own[-1][0][k] - own[K - 1][0][k]).max()
    step_meant = np.abs(meant[-1][0][k] - meant[K - 1][0][k]).max()
    # lr 0.05 (warm-up factor 0.5) against 0.1 on the same direction,
    # within the parameters' rounding (3e-8 at 0.4, 1e-6 of the step)
    np.testing.assert_allclose(
        (own[-1][0][k] - own[K - 1][0][k]) * 2,
        meant[-1][0][k] - meant[K - 1][0][k], atol=1e-5 * step_meant)
    assert step_own < step_meant
