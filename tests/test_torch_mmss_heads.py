"""PyTorch port vs JAX: the MMSS heads of the image-caption stage
(``locov_torch/models/mmss``) and the region builders of
``locov_torch/models/meta_arch/mmss_gcnn.py``, at a tiny width, on the
same numpy inputs and Flax weights (``from_flax``).

Tolerances: float32 outputs rtol 1e-5 with atol 1e-6 times the largest
|value| (at least 1e-6): float32 sums in another order; gradients
within 1e-4 of each tensor's largest JAX value. The transformer head in
bfloat16 (its dense and attention products in bfloat16, LayerNorm and
softmax in float32, as ``TransformerHeadConfig.from_cfg`` sets under
bfloat16): losses within 2e-2 relative and the B x B cost within 2e-2
of its largest value, a few bfloat16 roundings (2^-8 each) that may
fall on either side of a tie. The region builders are exact (the same
float32 operations and the same gather order, ties included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.models import bert as jbert
from locov_tpu.models.meta_arch import mmss_gcnn as jgcnn
from locov_tpu.models.mmss import distill as jdistill
from locov_tpu.models.mmss import grounding_head as jgh
from locov_tpu.models.mmss import transformer_head as jth
from locov_tpu.ops import losses as jlosses
from locov_tpu.structures import batches as jb
from locov_torch.models import bert as tbert
from locov_torch.models.meta_arch import mmss_gcnn as tgcnn
from locov_torch.models.mmss import distill as tdistill
from locov_torch.models.mmss import grounding_head as tgh
from locov_torch.models.mmss import transformer_head as tth
from locov_torch.ops import losses as tlosses
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import from_flax
from torch_parity import TINY_BERT, flat_params, n, t

B, W, R, V_DIM, L_DIM = 3, 8, 5, 12, 16


def _close(got, want, rtol=1e-5, atol=1e-6, err_msg=""):
    want = n(want)
    atol = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _inputs(rng, feat_dim):
    """Regions (the third image has 2 valid of 5) and captions (padding
    and special tokens; MLM targets on two captions) as numpy arrays."""
    feats = rng.randn(B, R, feat_dim).astype(np.float32)
    rmask = np.ones((B, R), bool)
    rmask[2, 2:] = False
    loc = rng.rand(B, R, 2).astype(np.float32)
    ids = rng.randint(1, 50, (B, W)).astype(np.int32)
    attn = np.ones((B, W), np.int32)
    attn[1, 6:] = 0
    attn[2, 3:] = 0
    special = np.zeros((B, W), np.int32)
    special[:, 0] = 1
    special[0, 7] = 1
    special[1, 5:] = 1
    special[2, 2:] = 1
    mlm = np.zeros((B, W), np.int32)
    mlm[0, 3] = mlm[1, 2] = 1
    emb = rng.randn(B, W, L_DIM).astype(np.float32)
    return dict(feats=feats, rmask=rmask, loc=loc, ids=ids, attn=attn,
                special=special, mlm=mlm, enc=emb,
                inp=rng.randn(B, W, L_DIM).astype(np.float32),
                word=rng.randn(50, L_DIM).astype(np.float32) * 0.5)


def _pair(a, conv, mod):
    image = mod.RegionFeatures(conv(a["feats"]), conv(a["rmask"]),
                               conv(a["loc"]))
    caption = mod.CaptionFeatures(
        conv(a["ids"]), conv(a["attn"]), conv(a["special"]),
        conv(a["ids"]), conv(a["mlm"]), conv(a["enc"]), conv(a["inp"]))
    return image, caption


def _load(module, variables):
    if variables:
        module.load_state_dict(from_flax(flat_params(variables)),
                               strict=True)
    return module


GROUNDING = [
    # (config overrides, external projection)
    ({"return_dist": True}, True),                        # the LSM's
    ({"alignment": "hardmax"}, False),
    ({"global_metric": "reconstruction_mse"}, False),
    ({"loss_type": "triplet", "negative_mining": "hardest"}, True),
    ({"loss_type": "triplet", "negative_mining": "easiest",
      "align_regions": False}, True),
]


@pytest.mark.parametrize("over,external", GROUNDING,
                         ids=["lsm", "hardmax", "recon_mse", "hardest",
                              "easiest_words"])
def test_grounding_head_matches_jax(rng, over, external):
    a = _inputs(rng, L_DIM if external else V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    jm = jgh.GroundingHead(jgh.GroundingConfig(**over), V_DIM, L_DIM,
                           external_projection=external)
    v = jm.init(jax.random.PRNGKey(0), ji, jc)
    tm = _load(tgh.GroundingHead(tgh.GroundingConfig(**over), V_DIM, L_DIM,
                                 external_projection=external), v)
    assert set(tm.state_dict()) == set(from_flax(flat_params(v))
                                       if v else {})

    def jloss(p, feats):
        out = jm.apply(p, ji._replace(features=feats), jc)
        return sum(jax.tree.leaves(out[1])), out

    fn = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    if over.get("loss_type") != "triplet":
        # the JAX triplet loss drops the diagonal by a boolean index,
        # which only runs eagerly
        fn = jax.jit(fn)
    (_, want), (jgp, jgf) = fn(v, jnp.asarray(a["feats"]))
    feats = t(a["feats"]).requires_grad_(True)
    got = tm(ti._replace(features=feats), tc)
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


def test_grounding_head_random_branches_raise(rng):
    """The branches that draw random numbers, which raised here before,
    build and, handed JAX's draws for its key, give JAX's losses
    (tests/test_torch_grounding_random.py holds them in full)."""
    from torch_parity import jax_grounding_draws
    a = _inputs(rng, L_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    key = jax.random.PRNGKey(11)
    for over in ({"alignment": "random_categorical"},
                 {"alignment": "random_top3"},
                 {"loss_type": "triplet", "negative_mining": "random"}):
        gcfg = jgh.GroundingConfig(**over)
        jm = jgh.GroundingHead(gcfg, V_DIM, L_DIM, external_projection=True)
        want = jm.apply({}, ji, jc, rng=key)[1]
        tm = tgh.GroundingHead(tgh.GroundingConfig(**over), V_DIM, L_DIM,
                               external_projection=True)
        got = tm(ti, tc, draws=jax_grounding_draws(gcfg, key, B, W, R))[1]
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], err_msg=f"{over} {k}")


def _tcfgs(dtype=None, **over):
    jcfg = jth.TransformerHeadConfig(
        bert=jbert.BertConfig(**TINY_BERT, dtype=dtype and jnp.bfloat16),
        return_dist=True, **over)
    tcfg = tth.TransformerHeadConfig(
        bert=tbert.BertConfig(**TINY_BERT, dtype=dtype and torch.bfloat16),
        return_dist=True, **over)
    return jcfg, tcfg


def _transformer_pair(rng, external, jcfg, tcfg):
    a = _inputs(rng, L_DIM if external else V_DIM)
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    jm = jth.TransformerHead(jcfg, V_DIM, L_DIM,
                             external_projection=external)
    v = jm.init(jax.random.PRNGKey(1), ji, jc, jnp.asarray(a["word"]))
    # nonzero biases (Flax initialises them to 0) so that a bias that
    # went missing would show
    v = jax.tree.map(lambda x: x + 0.05 * jnp.cos(jnp.arange(x.size)
                                                  .reshape(x.shape)), v)
    tm = _load(tth.TransformerHead(tcfg, V_DIM, L_DIM,
                                   external_projection=external), v)
    assert set(tm.state_dict()) == set(from_flax(flat_params(v)))
    want = jm.apply(v, ji, jc, jnp.asarray(a["word"]))
    got = tm(ti, tc, t(a["word"]))
    return got, want, (jm, v, ji, jc, a, tm, ti, tc)


@pytest.mark.parametrize("external,over", [
    (True, {}),
    (True, {"proper_attention_mask": True}),
    (False, {}),
    (True, {"mmm_loss": ""}),
    (True, {"pairwise_chunk": 3})],
    ids=["lsm", "proper_mask", "own_projection", "no_matching", "chunk"])
def test_transformer_head_matches_jax(rng, external, over):
    got, want, (jm, v, ji, jc, a, tm, ti, tc) = _transformer_pair(
        rng, external, *_tcfgs(**over))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if w[k] is None:
                assert g[k] is None
                continue
            _close(g[k].detach(), w[k], err_msg=k)
    if over.get("mmm_loss") == "":
        assert not any("pooler" in k or "bi_seq" in k
                       for k in tm.state_dict())
        return

    def jloss(p):
        out = jm.apply(p, ji, jc, jnp.asarray(a["word"]))
        return sum(jax.tree.leaves(out[1])) + out[2]["trans"].sum()

    want_g = from_flax(flat_params(jax.jit(jax.grad(jloss))(v)))
    tm.zero_grad()
    out = tm(ti, tc, t(a["word"]))
    (sum(out[1][k] for k in sorted(out[1])) + out[2]["trans"].sum()
     ).backward()
    for name, p in tm.named_parameters():
        w = n(want_g[name])
        scale = np.abs(w).max()
        if name.endswith(("key.bias", "bi_seq_relationship.bias")) and \
                scale < 1e-5:  # shift-invariant: zero but for rounding
            assert float(p.grad.abs().max()) < 1e-5, name
            continue
        assert np.abs(n(p.grad) - w).max() <= 1e-4 * scale, name


def test_transformer_head_bf16_matches_jax(rng):
    """The bfloat16 joint encoder (``BertConfig.dtype``): the same
    dtype transitions as Flax's, and the same numbers within the stated
    bfloat16 tolerance."""
    got, want, _ = _transformer_pair(rng, True, *_tcfgs(dtype="bf16"))
    (go, gl, gd), (wo, wl, wd) = got, want
    assert gd["trans"].dtype == torch.bfloat16 and \
        wd["trans"].dtype == jnp.bfloat16
    for k in wl:
        assert gl[k].dtype == {jnp.float32: torch.float32,
                               jnp.bfloat16: torch.bfloat16}[wl[k].dtype.type]
        np.testing.assert_allclose(float(gl[k].detach()), float(wl[k]),
                                   rtol=2e-2, err_msg=k)
    cost_err = np.abs(n(gd["trans"].float()) -
                      np.asarray(wd["trans"], np.float32)).max()
    assert cost_err <= 2e-2 * np.abs(np.asarray(wd["trans"],
                                                np.float32)).max()


def test_transformer_head_refusals(rng):
    """A chunk size whose chunks cannot be equal (JAX's reshape fails
    there too) raises; the fused grid + box pass (``image2``), ported
    now, refuses region groups of unequal shapes, as JAX asserts, and
    on equal shapes gives each group its own pass's results."""
    _, tcfg = _tcfgs(pairwise_chunk=4)  # 9 pairs in 2 chunks
    tm = tth.TransformerHead(tcfg, V_DIM, L_DIM, external_projection=True)
    ti, tc = _pair(_inputs(rng, L_DIM), t, tb)
    with pytest.raises(ValueError, match="PAIRWISE_CHUNK 4"):
        tm(ti, tc, torch.zeros(50, L_DIM))
    jcfg, tcfg = _tcfgs()
    tm = tth.TransformerHead(tcfg, V_DIM, L_DIM, external_projection=True)
    a = _inputs(rng, L_DIM)
    ti, tc = _pair(a, t, tb)
    ji, jc = _pair(a, jnp.asarray, jb)
    short = ti._replace(features=ti.features[:, :3], mask=ti.mask[:, :3],
                        loc=ti.loc[:, :3])
    with pytest.raises(ValueError, match="equal region counts"):
        tm(ti, tc, torch.zeros(50, L_DIM), image2=short)
    jm = jth.TransformerHead(jcfg, V_DIM, L_DIM, external_projection=True)
    word = jnp.asarray(a["word"])
    v = jm.init(jax.random.PRNGKey(1), ji, jc, word)
    with pytest.raises(AssertionError, match="equal region counts"):
        jm.apply(v, ji, jc, word, image2=ji._replace(
            features=ji.features[:, :3], mask=ji.mask[:, :3],
            loc=ji.loc[:, :3]))
    tm = _load(tm, v)
    flipped = ti._replace(features=ti.features.flip(0),
                          mask=ti.mask.flip(0), loc=ti.loc.flip(0))
    fused = tm(ti, tc, t(a["word"]), image2=flipped)
    for one, image in zip(fused, (ti, flipped)):
        alone = tm(image, tc, t(a["word"]))
        for f, u in zip(one, alone):
            assert set(f) == set(u)
            for k in u:
                _close(f[k].detach(), u[k].detach(), err_msg=k)


@pytest.mark.parametrize("kind", ["KD", "JS", "MSE"])
@pytest.mark.parametrize("teacher", [True, False], ids=["trans", "ground"])
@pytest.mark.parametrize("detach", [False, True], ids=["live", "detach"])
def test_distill_losses_match_jax(rng, kind, teacher, detach):
    costs = [rng.randn(4, 4).astype(np.float32) * 3 for _ in range(3)]

    def jfn(*c):
        return jdistill.DISTILL_LOSSES[kind](*c, 10.0, 0.7, detach, teacher)
    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        *map(jnp.asarray, costs))
    xs = [t(c).requires_grad_(True) for c in costs]
    got = tdistill.DISTILL_LOSSES[kind](*xs, 10.0, 0.7, detach, teacher)
    _close(got.detach(), want)
    got.backward()
    for x, w in zip(xs, want_g):
        if not np.abs(n(w)).max() > 0:  # a detached teacher
            assert x.grad is None or not x.grad.abs().max() > 0
            continue
        _close(x.grad, w, rtol=0, atol=1e-4 * float(np.abs(w).max()))


def test_kl_div_batchmean_with_zero_targets_matches_jax(rng):
    logq = np.log(rng.dirichlet(np.ones(5), 4)).astype(np.float32)
    p = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    p[0, 1] = p[2, 3] = 0.0  # 0 * log 0 = 0
    want, want_g = jax.value_and_grad(jlosses.kl_div_batchmean)(
        jnp.asarray(logq), jnp.asarray(p))
    x = t(logq).requires_grad_(True)
    got = tlosses.kl_div_batchmean(x, t(p))
    _close(got.detach(), want)
    got.backward()
    _close(x.grad, want_g)


def test_make_grid_regions_matches_jax(rng):
    grid = rng.randn(2, 3, 4, 6).astype(np.float32)
    hw = np.array([[96, 128], [64, 80]], np.int32)
    want = jgcnn.make_grid_regions(jnp.asarray(grid), jnp.asarray(hw),
                                   (96, 128))
    got = tgcnn.make_grid_regions(t(grid), t(hw), (96, 128))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    assert n(got.mask).sum(1).tolist() == [12, 6]
    # the full-width grid: 25 x 42 res5 cells over an 800 x 1344 canvas
    # with 800 x 1312 valid
    full = np.zeros((1, 25, 42, 1), np.float32)
    hw = np.array([[800, 1312]], np.int32)
    want = jgcnn.make_grid_regions(jnp.asarray(full), jnp.asarray(hw),
                                   (800, 1344))
    got = tgcnn.make_grid_regions(t(full), t(hw), (800, 1344))
    assert int(n(got.mask).sum()) == int(n(want.mask).sum()) == 25 * 41
    np.testing.assert_array_equal(n(got.loc), n(want.loc))


@pytest.mark.parametrize("k", [3, 5, 9])
def test_spatial_dropout_matches_jax(rng, k):
    """k below, between and above the images' valid counts (5, 2 and 0
    of 6): where fewer regions are valid than k, the rest are the
    zeroed invalid slots, in index order (top_k's ties)."""
    feats = rng.randn(3, 6, 4).astype(np.float32)
    loc = rng.rand(3, 6, 2).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 1, 1], [0, 1, 0, 0, 1, 0],
                     [0] * 6], bool)
    key = jax.random.PRNGKey(k)
    keys = np.asarray(jax.random.uniform(key, (3, 6)))
    want = jgcnn.spatial_dropout(
        jb.RegionFeatures(*map(jnp.asarray, (feats, mask, loc))), k, key)
    got = tgcnn.spatial_dropout(
        tb.RegionFeatures(*map(t, (feats, mask, loc))), k, t(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    assert n(got.mask).sum(1).tolist() == [min(k, 5), min(k, 2), 0]


def test_box_regions_matches_jax(rng):
    lo = rng.rand(2, 7, 2) * 60
    boxes = np.concatenate([lo, lo + rng.rand(2, 7, 2) * 40 + 1],
                           -1).astype(np.float32)
    feats = rng.randn(2, 7, 5).astype(np.float32)
    valid = rng.rand(2, 7) > 0.3
    hw = np.array([[96, 128], [64, 80]], np.float32)
    key = jax.random.PRNGKey(3)
    keys = np.asarray(jax.random.uniform(key, (2, 7)))
    want = jgcnn.box_regions(*map(jnp.asarray, (boxes, feats, valid, hw)),
                             4, key)
    got = tgcnn.box_regions(*map(t, (boxes, feats, valid, hw)), 4, t(keys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
