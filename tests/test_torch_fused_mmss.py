"""PyTorch port vs JAX: the fused grid + box MMSS pass
(``TPU.FUSED_MMSS_PASSES``): ``TransformerHead`` with ``image2``, and
``DistillProposalMMSSRCNN`` with ``fused_mmss``, at tiny widths, on the
same numpy inputs and Flax weights.

Against JAX's fused head (the two groups' pairs in one encoder call,
with and without ``PAIRWISE_CHUNK``): outputs and losses rtol 1e-5 with
atol 1e-6 times the largest |value|, gradients within 1e-4 of each
tensor's largest JAX value (tests/test_torch_mmss_heads.py's bounds).
Against the port's own unfused head: the same bounds, per group. The
tiny LSM model fused against JAX's fused model: losses and outputs rtol
1e-4, gradients within 2e-3 of each tensor's largest JAX value
(tests/test_torch_lsm_step.py's bounds), and fused against the port's
unfused model within the same bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.models.mmss import transformer_head as jth
from locov_tpu.structures import batches as jb
from locov_tpu.utils.checkpoint import flatten_params
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.models.meta_arch import mmss_gcnn as tgcnn
from locov_torch.models.mmss import transformer_head as tth
from locov_torch.structures import batches as tb
from locov_torch.utils.weights import from_flax
from test_torch_lsm_step import _assert_close, _jcfg, _tcfg, loss_uniforms
from test_torch_mmss_heads import (L_DIM, V_DIM, _close, _inputs, _load,
                                   _pair, _tcfgs)
from torch_parity import flat_params, lsm_batch, n, t, tiny_lsm_arrays


def _two_groups(rng, external):
    """Two region groups of one shape over the same captions."""
    a = _inputs(rng, L_DIM if external else V_DIM)
    b = _inputs(rng, L_DIM if external else V_DIM)
    b["rmask"][0, 3:] = False
    ji, jc = _pair(a, jnp.asarray, jb)
    ti, tc = _pair(a, t, tb)
    ji2 = _pair(b, jnp.asarray, jb)[0]
    ti2 = _pair(b, t, tb)[0]
    return a, (ji, ji2, jc), (ti, ti2, tc)


@pytest.mark.parametrize("external,over", [
    (True, {}), (False, {}), (True, {"pairwise_chunk": 6}),
    (True, {"mmm_loss": ""})],
    ids=["lsm", "own_projection", "chunk", "no_matching"])
def test_fused_head_matches_jax(rng, external, over):
    """18 fused pairs (3 x 3 a group), in 3 chunks of 6 under
    ``pairwise_chunk`` 6: a chunk spans both groups."""
    jcfg, tcfg = _tcfgs(**over)
    a, (ji, ji2, jc), (ti, ti2, tc) = _two_groups(rng, external)
    word = jnp.asarray(a["word"])
    jm = jth.TransformerHead(jcfg, V_DIM, L_DIM,
                             external_projection=external)
    v = jm.init(jax.random.PRNGKey(1), ji, jc, word, image2=ji2)
    v = jax.tree.map(lambda x: x + 0.05 * jnp.cos(jnp.arange(x.size)
                                                  .reshape(x.shape)), v)
    tm = _load(tth.TransformerHead(tcfg, V_DIM, L_DIM,
                                   external_projection=external), v)

    def jloss(p):
        res = jm.apply(p, ji, jc, word, image2=ji2)
        total = sum(sum(jax.tree.leaves(r[1])) for r in res)
        if over.get("mmm_loss") != "":
            total = total + sum(r[2]["trans"].sum() for r in res)
        return total, res

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v)
    got = tm(ti, tc, t(a["word"]), image2=ti2)
    assert len(got) == len(want) == 2
    for gg, wg in zip(got, want):
        for g, w in zip(gg, wg):
            assert set(g) == set(w)
            for k in w:
                if w[k] is None:
                    assert g[k] is None
                    continue
                _close(g[k].detach(), w[k], err_msg=k)
    total = sum(sum(r[1][k] for k in sorted(r[1])) for r in got)
    if over.get("mmm_loss") != "":
        total = total + sum(r[2]["trans"].sum() for r in got)
    total.backward()
    want_g = from_flax(flat_params(jgrads))
    for name, p in tm.named_parameters():
        w = n(want_g[name])
        scale = np.abs(w).max()
        if name.endswith(("key.bias", "bi_seq_relationship.bias")) and \
                scale < 1e-5:  # shift-invariant: zero but for rounding
            assert float(p.grad.abs().max()) < 1e-5, name
            continue
        assert np.abs(n(p.grad) - w).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("chunk", [0, 9])
def test_fused_head_is_the_two_unfused_passes(rng, chunk):
    """The port's fused call gives each group what its own unfused call
    gives, with the chunked pair encoder too (9 of 18 pairs a chunk)."""
    _, tcfg = _tcfgs(pairwise_chunk=chunk)
    a, _, (ti, ti2, tc) = _two_groups(rng, True)
    torch.manual_seed(0)
    tm = tth.TransformerHead(tcfg, V_DIM, L_DIM, external_projection=True)
    word = t(a["word"])
    fused = tm(ti, tc, word, image2=ti2)
    for res, image in zip(fused, (ti, ti2)):
        alone = tm(image, tc, word)
        for f, u in zip(res, alone):
            assert set(f) == set(u)
            for k in u:
                _close(f[k].detach(), u[k].detach(), err_msg=k)


def test_mmss_heads_two_groups_match_one_at_a_time(rng):
    """``MMSSHeads`` with ``image2``: grounding per group (with its own
    draws), the transformer head once; the same triples as two calls."""
    from locov_torch.models.mmss import grounding_head as tgh
    jcfg, tcfg = _tcfgs()
    a, _, (ti, ti2, tc) = _two_groups(rng, False)
    gcfg = tgh.GroundingConfig(return_dist=True)
    torch.manual_seed(1)
    heads = tgcnn.MMSSHeads(("GroundingHead", "TransformerHead"), True,
                            gcfg, tcfg, V_DIM, L_DIM)
    word = t(a["word"])
    pair = heads(ti, tc, word, image2=ti2)
    for res, image in zip(pair, (ti, ti2)):
        alone = heads(image, tc, word)
        assert [set(d) for d in res] == [set(d) for d in alone]
        assert {"w2r", "r2w", "trans"} == set(res[2])
        for f, u in zip(res, alone):
            for k in u:
                _close(f[k].detach(), u[k].detach(), err_msg=k)


@pytest.fixture(scope="module")
def fused_lsm():
    """The tiny LSM model (tests/test_torch_lsm_step.py's) with
    ``TPU.FUSED_MMSS_PASSES``: JAX's weights, losses and gradients."""
    arrays = tiny_lsm_arrays(np.random.RandomState(0))
    jbatch = lsm_batch(arrays, jb.ImageBatch, jb.GtBatch, jb.TextBatch,
                       jb.DetectionBatch, jnp.asarray)
    tbatch = lsm_batch(arrays, tb.ImageBatch, tb.GtBatch, tb.TextBatch,
                       tb.DetectionBatch, t)
    ce = arrays["class_emb"]
    jm = jbuild(_jcfg(**{"TPU.FUSED_MMSS_PASSES": True}))
    assert jm.fused_mmss
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda b, c, k: jm.init(k, b, c, k, method=jm.losses))(
        jbatch, jnp.asarray(ce), key)
    flat = flat_params(v)
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    from locov_tpu.utils.checkpoint import unflatten_params
    v = {"params": unflatten_params({k: jnp.asarray(x)
                                     for k, x in flat.items()})}

    def loss_fn(p):
        outputs, losses = jm.apply(p, jbatch, jnp.asarray(ce), key,
                                   method=jm.losses)
        return sum(jax.tree.leaves(losses)), (outputs, losses)

    (_, (outputs, losses)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v)
    return dict(flat=flat, tbatch=tbatch, ce=ce, key=key, outputs=outputs,
                losses=losses, grads=grads)


def _model(p, fused):
    tm = tbuild(_tcfg(**{"TPU.FUSED_MMSS_PASSES": fused}), device="cpu")
    tm.load_state_dict(from_flax(p["flat"]), strict=True)
    return tm


def test_fused_model_matches_jax(fused_lsm):
    """Losses, outputs and gradients of the fused model against JAX's
    fused model, and the fused call of the heads really ran (the
    grid_mmss and box_mmss ranges did not)."""
    p = fused_lsm
    tm = _model(p, True)
    assert tm.fused_mmss
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        outputs, losses = tm.losses(p["tbatch"], t(p["ce"]),
                                    uniforms=loss_uniforms(p["key"]))
    ranges = {e.name for e in prof.events()}
    assert "DistillProposalMMSSRCNN.fused_mmss" in ranges
    assert "DistillProposalMMSSRCNN.grid_mmss" not in ranges
    assert "DistillProposalMMSSRCNN.box_mmss" not in ranges
    assert set(losses) == set(p["losses"]) and len(losses) == 19
    assert set(outputs) == set(p["outputs"])
    for k, w in p["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), float(w),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for k, w in p["outputs"].items():
        np.testing.assert_allclose(float(outputs[k]), float(w), rtol=1e-4,
                                   err_msg=k)
    sum(losses[k] for k in sorted(losses)).backward()
    want = from_flax({k: np.asarray(a) for k, a in flatten_params(
        jax.device_get(p["grads"]["params"])).items()})
    checked = 0
    for name, prm in tm.named_parameters():
        w = n(want[name])
        if not np.abs(w).max() > 0:
            assert prm.grad is None or not prm.grad.abs().max() > 0, name
            continue
        _assert_close(n(prm.grad), w, name, rtol=2e-3)
        checked += 1
    assert checked > 100


def test_fused_model_is_the_unfused_model(fused_lsm):
    """The same weights and draws, dropout off: the fused model's losses
    and gradients are the unfused model's."""
    p = fused_lsm
    res = {}
    for fused in (True, False):
        tm = _model(p, fused)
        _, losses = tm.losses(p["tbatch"], t(p["ce"]),
                              uniforms=loss_uniforms(p["key"]))
        sum(losses[k] for k in sorted(losses)).backward()
        res[fused] = ({k: float(v.detach()) for k, v in losses.items()},
                      {k: prm.grad for k, prm in tm.named_parameters()
                       if prm.grad is not None})
    (lf, gf), (lu, gu) = res[True], res[False]
    assert lf.keys() == lu.keys()
    for k in lu:
        assert lf[k] == pytest.approx(lu[k], rel=1e-5, abs=1e-7), k
    assert gf.keys() == gu.keys()
    for k in gu:
        _assert_close(n(gf[k]), n(gu[k]), k, rtol=1e-4)


def test_fused_model_falls_back_where_shapes_differ(fused_lsm):
    """JAX fuses only where the grid and box regions have one shape: at
    SPATIAL_DROPOUT 16 the grid keeps its 12 cells and the box pass its
    8 sampled boxes, so the two unfused passes run."""
    p = fused_lsm
    extra = {"TPU.FUSED_MMSS_PASSES": True,
             "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 8,
             "MODEL.MMSS_HEAD.SPATIAL_DROPOUT": 16}
    tm = tbuild(_tcfg(**extra), device="cpu")
    tm.load_state_dict(from_flax(p["flat"]), strict=True)
    u = loss_uniforms(p["key"])
    u["box_drop"] = u["box_drop"][:, :8]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        _, losses = tm.losses(p["tbatch"], t(p["ce"]), uniforms=u)
    ranges = {e.name for e in prof.events()}
    assert "DistillProposalMMSSRCNN.fused_mmss" not in ranges
    assert {"DistillProposalMMSSRCNN.grid_mmss",
            "DistillProposalMMSSRCNN.box_mmss"} <= ranges
    assert all(np.isfinite(float(v)) for v in losses.values())
