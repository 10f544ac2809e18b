"""PyTorch port vs JAX: the grounding head's branches that draw random
numbers (``locov_torch/models/mmss/grounding_head.py``): the
``random_categorical`` and ``random_top3`` alignments and ``random``
negative mining in the triplet loss, at a tiny width, on the same numpy
inputs and Flax weights.

The draws are inputs: JAX's own draws for its key
(``torch_parity.jax_grounding_draws``: the uniforms behind
``jax.random.categorical``'s Gumbel noise, the ``randint`` indices) are
handed to the port, which must then pick the same indices and give the
same losses. Tolerances: ``gumbel_categorical`` against
``jax.random.categorical`` exact (the same indices); losses and outputs
rtol 1e-5 with atol 1e-6 times the largest |value|, gradients within
1e-4 of each tensor's largest JAX value (tests/test_torch_mmss_heads.py's
bounds). The generator path (no draws given): indices in range, never
the positive's own index, the same draws for the same seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.models.mmss import grounding_head as jgh
from locov_tpu.structures import batches as jb
from locov_torch.models.mmss import grounding_head as tgh
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import from_flax
from test_torch_mmss_heads import (B, L_DIM, R, V_DIM, W, _close, _inputs,
                                   _load, _pair)
from torch_parity import flat_params, jax_grounding_draws, n, t

RANDOM = [
    {"alignment": "random_categorical"},
    {"alignment": "random_top3"},
    {"alignment": "random_categorical", "align_regions": False,
     "global_metric": "reconstruction_mse"},
    {"loss_type": "triplet", "negative_mining": "random"},
    {"alignment": "random_top3", "loss_type": "triplet",
     "negative_mining": "random", "return_dist": True},
]
IDS = ["categorical", "top3", "categorical_words_mse", "random_negatives",
       "top3_random_negatives"]


@pytest.mark.parametrize("axis_len", [5, 40])
def test_gumbel_categorical_picks_jaxs_indices(rng, axis_len):
    """``jax.random.categorical(key, logits)`` is argmax(logits + Gumbel)
    with the Gumbel noise from ``uniform(key, minval=tiny)``: handed
    those uniforms, the port picks the same index in every row."""
    logits = (rng.randn(6, 7, axis_len) * 3).astype(np.float32)
    logits[0, 0, :] = -1e4  # a row at the masked fill
    logits[1, :, 2] = 0.0
    key = jax.random.PRNGKey(axis_len)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    u = np.asarray(jax.random.uniform(key, logits.shape,
                                      minval=np.finfo(np.float32).tiny,
                                      maxval=1.0))
    got = tgh.gumbel_categorical(t(logits), t(u))
    np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("over", RANDOM, ids=IDS)
def test_random_branches_match_jax_on_its_draws(rng, over):
    """The head with JAX's draws for its key: the same alignments and
    negatives, so the same losses, outputs and gradients (eagerly: the
    JAX triplet loss drops the diagonal by a boolean index)."""
    external = over.get("loss_type") == "triplet"
    a = _inputs(rng, L_DIM if external else V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    gcfg = jgh.GroundingConfig(**over)
    jm = jgh.GroundingHead(gcfg, V_DIM, L_DIM, external_projection=external)
    key = jax.random.PRNGKey(7)
    v = jm.init(jax.random.PRNGKey(0), ji, jc, rng=key)
    tm = _load(tgh.GroundingHead(tgh.GroundingConfig(**over), V_DIM, L_DIM,
                                 external_projection=external), v)

    def jloss(p, feats):
        out = jm.apply(p, ji._replace(features=feats), jc, rng=key)
        return sum(jax.tree.leaves(out[1])), out

    (_, want), (jgp, jgf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v, jnp.asarray(a["feats"]))
    draws = jax_grounding_draws(gcfg, key, B, W, R)
    assert set(draws) == (
        ({"align_words"} | ({"align_regions"} if gcfg.align_regions
                            else set()))
        if gcfg.alignment.startswith("random") else set()) | (
        {"neg_words", "neg_regions"} if external else set())
    feats = t(a["feats"]).requires_grad_(True)
    got = tm(ti._replace(features=feats), tc, draws=draws)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _close(g[k].detach(), w[k], err_msg=k)
    sum(got[1][k] for k in sorted(got[1])).backward()
    _close(feats.grad, jgf, rtol=0, atol=1e-4 * float(np.abs(jgf).max()))
    if v:
        want_g = from_flax(flat_params(jgp))
        for name, p in tm.named_parameters():
            w = n(want_g[name])
            assert np.abs(n(p.grad) - w).max() <= 1e-4 * np.abs(w).max()


def test_random_top3_samples_among_the_three_most_similar(rng):
    """``random_top3``'s sampler on draws from a generator: every pick is
    one of the row's three largest similarities, and over many draws
    each of the three is picked; the head then runs on the generator
    alone."""
    sim = t(rng.randn(2, 3, 4, 6).astype(np.float32))
    top3 = sim.topk(3, dim=-1).indices
    logits = tgh._three_hot_logits(sim)
    gen = torch.Generator().manual_seed(0)
    seen = torch.zeros(sim.shape, dtype=torch.bool)
    for _ in range(60):
        u = torch.rand(sim.shape, generator=gen).clamp_(
            min=torch.finfo(torch.float32).tiny)
        idx = tgh.gumbel_categorical(logits, u)
        assert bool((idx[..., None] == top3).any(-1).all())
        seen.scatter_(-1, idx[..., None], True)
    assert bool(seen.gather(-1, top3).all())
    assert int(seen.sum()) == 3 * 2 * 3 * 4
    a = _inputs(rng, L_DIM)
    ti, tc = _pair(a, t, tb)
    tm = tgh.GroundingHead(tgh.GroundingConfig(alignment="random_top3"),
                           V_DIM, L_DIM, external_projection=True)
    out = tm(ti, tc, generator=torch.Generator().manual_seed(2))[1]
    assert all(bool(torch.isfinite(v)) for v in out.values())


def test_random_negatives_from_the_generator(rng):
    """Without draws the negatives come from the generator: indices in
    [0, B - 1) of the cost without its diagonal, so never the positive's
    own caption or image; one seed, one draw; with neither draws nor a
    generator, a generator seeded 0 (JAX's default key is PRNGKey(0))."""
    a = _inputs(rng, L_DIM)
    ti, tc = _pair(a, t, tb)
    cfg = tgh.GroundingConfig(loss_type="triplet", negative_mining="random")
    tm = tgh.GroundingHead(cfg, V_DIM, L_DIM, external_projection=True)
    # the draws the head took, read back by wrapping torch.randint
    taken = []
    real = torch.randint

    def spy(*args, **kw):
        out = real(*args, **kw)
        taken.append(out)
        return out
    torch.randint = spy
    try:
        first = tm(ti, tc, generator=torch.Generator().manual_seed(3))[1]
        again = tm(ti, tc, generator=torch.Generator().manual_seed(3))[1]
        default = tm(ti, tc)[1]
        seeded0 = tm(ti, tc, generator=torch.Generator().manual_seed(0))[1]
    finally:
        torch.randint = real
    assert len(taken) == 4 * 4  # (caption, image) for words and regions
    for idx in taken:
        assert idx.dtype == torch.int64 and idx.shape == (B,)
        assert int(idx.min()) >= 0 and int(idx.max()) <= B - 2
        # into the B - 1 off-diagonal entries of a row (column): the
        # original index skips the diagonal
        orig = idx + (idx >= torch.arange(B)).long()
        assert not bool((orig == torch.arange(B)).any())
    for k in first:
        assert torch.equal(first[k], again[k]), k
        assert torch.equal(default[k], seeded0[k]), k
    pw = torch.arange(B * B, dtype=torch.float32).reshape(B, B)
    neg = tgh._remove_diag(pw, 0)[taken[0], torch.arange(B)]
    assert not bool((neg == torch.diagonal(pw)).any())


def test_random_alignment_without_draws_or_generator_raises(rng):
    """JAX asserts a key for the random alignments; the port asks for
    draws or a generator."""
    a = _inputs(rng, L_DIM)
    ti, tc = _pair(a, t, tb)
    tm = tgh.GroundingHead(
        tgh.GroundingConfig(alignment="random_categorical"), V_DIM, L_DIM,
        external_projection=True)
    with pytest.raises(ValueError, match="draws"):
        tm(ti, tc)
    out = tm(ti, tc, generator=torch.Generator().manual_seed(1))[1]
    assert all(torch.isfinite(v) for v in out.values())
