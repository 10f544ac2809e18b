"""PyTorch port vs JAX: the tiny ``OvrRCNN`` under the static int8
scheme. JAX's model is calibrated on the batch once (its ``quant``
collection), the port likewise; the calibrated max-abs values are held
within rtol 1e-5, and the port loaded with JAX's values (``from_flax``
of ``quant/``) is held to JAX's static detections, with the full-int8
ROIAlign and with the float one quantized after it, at
``test_torch_int8_model.py``'s tolerances and for its reasons.

Calibration on two gloo ranks (spawned processes,
``torch_dp_worker.calibrate_rank_worker``), one image each: every rank
holds the same values, those of one process calibrating the whole batch
(rtol 1e-6: a max-abs taken over both ranks where it is recorded, as
JAX's is over the global batch). JAX's ``make_calibrate_step`` on a
2-device mesh is jitted: there XLA fuses the float stem otherwise than
JAX's eager run and an int8 step flips, and its values differ from JAX's
own eager calibration (which the port's equal within rtol 1e-5) by up
to 2.3% (measured). The port's two ranks are held to the jitted values
within rtol 1e-5 for the first conv of res2 (its input, the float stem,
differs by ulps), and within 5% for the rest."""
import multiprocessing as std_mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.parallel import get_mesh, make_calibrate_step
from locov_tpu.parallel import make_eval_step as jax_eval_step
from locov_tpu.utils.checkpoint import unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.parallel.mesh import local_url
from locov_torch.structures.batches import Detections, take_rows
from locov_torch.utils.weights import from_flax
from test_torch_int8_model import (EXTRA, _assert_close, _cfg, _port,
                                   jax_int8_setup, quant_flat)
from torch_dp_worker import (calibrate_rank_worker, calibrate_shards_worker,
                             dynamic_rank_worker)
from torch_parity import n, t


@pytest.fixture(scope="module")
def int8_pair():
    return jax_int8_setup(static=True)


def test_calibrated_amaxes_match_jax(int8_pair):
    """One calibration pass on the batch: every max-abs positive, the
    same set as JAX's ``quant`` collection, within rtol 1e-5."""
    tm = _port(int8_pair, "static", quant=False)
    assert all(float(v) == 0 for v in tm.amax_buffers().values())
    tm.calibrate_int8(int8_pair["tb"], t(int8_pair["ce"]))
    got = tm.amax_buffers()
    want = from_flax(int8_pair["quant"])
    assert set(got) == set(want) and len(got) == 54
    for k, v in got.items():
        assert not v.is_inference() and float(v) > 0, k
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("roialign", [True, False])
def test_static_matches_jax(int8_pair, roialign):
    """JAX's calibrated values loaded: full-int8 ROIAlign, and the float
    ROIAlign with a static quantize of its output."""
    tm = _port(int8_pair, "static", roialign)
    got = tm.inference(int8_pair["tb"], t(int8_pair["ce"]))
    _assert_close(got, int8_pair["static" if roialign else "static_noroi"])


def test_state_dict_keys(int8_pair):
    """int8 off and the dynamic scheme have the float model's keys; the
    static scheme adds exactly the max-abs buffers, zero at init."""
    base = set(tbuild(_cfg(tget), device="cpu").state_dict())
    assert set(tbuild(_cfg(tget, "dynamic"), device="cpu").state_dict()) \
        == base
    sta = tbuild(_cfg(tget, "static"), device="cpu")
    extra = set(sta.state_dict()) - base
    assert extra == set(sta.amax_buffers()) == \
        set(from_flax(int8_pair["quant"]))
    assert base <= set(sta.state_dict())
    assert not any(p.requires_grad for k, p in sta.named_buffers()
                   if k in extra)
    with pytest.raises(ValueError, match="static int8 scheme"):
        tbuild(_cfg(tget, "dynamic"), device="cpu").calibrate_int8(
            int8_pair["tb"], t(int8_pair["ce"]))


def _spawn_ranks(worker, int8_pair, tmp_path, scheme="static"):
    """Two gloo ranks of ``worker`` on the tiny model of the int8
    ``scheme`` with the pair's weights and batch; returns (the port's
    model, the started processes, their output paths)."""
    tm = _port(int8_pair, scheme, quant=False)
    data = {"extra": {**EXTRA, "TPU.INT8_EVAL": True,
                      "TPU.INT8_SCHEME": scheme},
            "batch": int8_pair["tb"], "class_emb": t(int8_pair["ce"]),
            "weights": tm.state_dict()}
    in_path = str(tmp_path / f"{worker.__name__}.pt")
    torch.save(data, in_path)
    outs = [str(tmp_path / f"{worker.__name__}{r}.pt") for r in range(2)]
    ctx = std_mp.get_context("spawn")
    url = local_url()
    procs = [ctx.Process(target=worker, args=(r, 2, url, in_path, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    return tm, procs, outs


def _joined(procs, outs):
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0
    return [torch.load(o, weights_only=True) for o in outs]


def test_two_ranks_calibrate_to_the_global_max(int8_pair, tmp_path):
    tm, procs, outs = _spawn_ranks(calibrate_rank_worker, int8_pair,
                                   tmp_path)
    # JAX's calibration step on a 2-device mesh while the ranks run
    params = unflatten_params({k: jnp.asarray(a)
                               for k, a in int8_pair["flat"].items()})
    jm = jbuild(_cfg(jget, "static"))
    quant = make_calibrate_step(jm, get_mesh(jax.devices()[:2]))(
        {"params": params}, int8_pair["jb"], jnp.asarray(int8_pair["ce"]))
    want = from_flax(quant_flat(quant))
    # one process over the whole batch
    tm.calibrate_int8(int8_pair["tb"], t(int8_pair["ce"]))
    whole = tm.amax_buffers()
    ranks = _joined(procs, outs)
    assert set(ranks[0]) == set(want) == set(whole)
    for k in want:
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        np.testing.assert_allclose(float(ranks[0][k]), float(whole[k]),
                                   rtol=1e-6, err_msg=k)
        rtol = 1e-5 if k == "backbone.res2.0.conv1_amax.amax" else 5e-2
        np.testing.assert_allclose(float(ranks[0][k]), float(want[k]),
                                   rtol=rtol, err_msg=k)


def test_ranks_with_unequal_shards_calibrate_alike(int8_pair, tmp_path):
    """``test``'s calibration on two ranks whose test loaders hold 1 and
    2 batches (INT8_CALIB_BATCHES 4): both run one pass, as many as the
    shorter shard, and hold the same values (a rank running a pass
    alone would wait forever on the other's all-reduce)."""
    _, procs, outs = _spawn_ranks(calibrate_shards_worker, int8_pair,
                                  tmp_path)
    ranks = _joined(procs, outs)
    assert [r["done"] for r in ranks] == [True, True]
    assert [r["passes"] for r in ranks] == [1, 1]
    for k, v in ranks[0]["amax"].items():
        assert float(v) > 0 and torch.equal(v, ranks[1]["amax"][k]), k


@pytest.fixture(scope="module")
def dynamic_ranks(int8_pair, tmp_path_factory):
    """The dynamic scheme on two gloo ranks (``dynamic_rank_worker``),
    one image each, beside one process over the whole batch and over
    each image alone, and JAX's eval step on a 2-device mesh (the
    batch split the same way, one image a device)."""
    tm, procs, outs = _spawn_ranks(dynamic_rank_worker, int8_pair,
                                   tmp_path_factory.mktemp("dynamic"),
                                   "dynamic")
    params = unflatten_params({k: jnp.asarray(a)
                               for k, a in int8_pair["flat"].items()})
    jm = jbuild(_cfg(jget, "dynamic"))
    jdets = jax_eval_step(jm, get_mesh(jax.devices()[:2]))(
        {"params": params}, int8_pair["jb"], jnp.asarray(int8_pair["ce"]))
    batch, ce = int8_pair["tb"], t(int8_pair["ce"])
    whole = tm.inference(batch, ce)
    alone = [tm.inference(take_rows(batch, r, r + 1), ce)
             for r in range(2)]
    return {"ranks": _joined(procs, outs), "whole": whole,
            "alone": alone, "jax": jdets}


def _rows(dets, r):
    return Detections(*(x[r:r + 1] for x in dets))


def _same_dets(got, want):
    got, want = Detections(*got), Detections(*want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_two_ranks_dynamic_take_the_global_scale(dynamic_ranks):
    """F1: each rank's dynamic max-abs is all-reduced, so two ranks given
    half the batch each give the detections of one process over the
    whole batch, bit for bit; an image alone takes other scales (the
    split would show without the reduce). Held to JAX's 2-device eval
    step (jitted: XLA fuses the float stem otherwise than the eager
    runs, and an int8 step flips, test_torch_int8_model.py): the same
    number of detections an image, each of JAX's matched by one of the
    ranks' with its class, boxes within 0.1 px and scores within 5e-3
    (near-equal scores may swap places in the top 100). JAX's 1-device
    jitted step gives the same bits as its 2-device one here, and both
    sit 0.079 px and 2.7e-3 from the port's (and JAX's eager) run
    (measured)."""
    d = dynamic_ranks
    for r in range(2):
        _same_dets(d["ranks"][r]["half"], _rows(d["whole"], r))
    assert any(not torch.equal(d["alone"][r].scores,
                               d["whole"].scores[r:r + 1])
               for r in range(2))
    got = Detections(*(torch.cat([d["ranks"][0]["half"][i],
                                  d["ranks"][1]["half"][i]])
                       for i in range(4)))
    want = Detections(*(n(x) for x in d["jax"]))
    got = Detections(*(n(x) for x in got))
    assert want.mask.sum() >= 10
    np.testing.assert_array_equal(got.mask.sum(1), want.mask.sum(1))
    for i, j in zip(*np.nonzero(want.mask)):
        near = got.mask[i] & (got.classes[i] == want.classes[i, j]) & \
            (np.abs(got.boxes[i] - want.boxes[i, j]).max(-1) <= 0.1) & \
            (np.abs(got.scores[i] - want.scores[i, j]) <= 5e-3)
        assert near.any(), (i, j)


def test_ranks_with_unequal_shards_step_in_lockstep(dynamic_ranks):
    """The evaluation loop over shards of 1 and 2 batches: rank 0 runs
    one idle pass while rank 1 runs its second batch, and contributes 0
    to its scales: rank 1's second batch gives the detections of its
    image alone, its first those of the whole batch."""
    d = dynamic_ranks
    r0, r1 = d["ranks"][0]["lockstep"], d["ranks"][1]["lockstep"]
    assert len(r0) == 1 and len(r1) == 2
    _same_dets(r0[0], _rows(d["whole"], 0))
    _same_dets(r1[0], _rows(d["whole"], 1))
    _same_dets(r1[1], d["alone"][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized_input", [False, True])
def test_static_fusion_is_the_unfused_scheme(dtype, quantized_input,
                                             monkeypatch):
    """A 3-block stage under the static scheme, each activation quantize
    fused into the epilogue of the conv that produces it (conv1 and
    conv2 write only int8, conv3 adds the shortcut and writes the next
    identity block's conv1 input too), gives the bits of the unfused
    chain (``unfuse_static_``): every conv quantizing its own input by
    its calibrated max-abs, conv3 adding the shortcut (the epilogue's
    residual is the float add, test_torch_int8_ops.py). Some max-abs
    values are set
    below the calibrated ones so that values saturate. The stage runs 2
    activation quantize passes (the first block's conv1 and shortcut
    reading the stage boundary; none where the input is already int8,
    as res5's is), against 10 unfused."""
    from locov_torch.models import resnet
    from locov_torch.ops import int8_conv as tq
    torch.manual_seed(0)
    stage = resnet.ResNetStage(3, 32, 16, 64, first_stride=2,
                               compute_dtype=dtype, int8_amax=True)
    with torch.no_grad():
        for name, buf in stage.named_buffers():
            if name.endswith(("weight", "bias", "running_mean")):
                buf.copy_(torch.randn_like(buf) * 0.3 +
                          (1.0 if name.endswith("weight") else 0.0))
    x = torch.randn(2, 12, 14, 32).to(dtype)
    stage(x, int8="calibrate")
    with torch.no_grad():
        for i, (name, buf) in enumerate(stage.named_buffers()):
            if name.endswith("amax") and i % 3 == 0:
                buf.mul_(0.6)
    if quantized_input:
        x = tq.QuantizedTensor(*tq.quantize_per_tensor_static(
            x, stage[0].conv1_amax.amax))
    calls = []
    conv = resnet.conv_int8

    def counted(x, *a, **k):  # a conv that quantizes its float input
        if not isinstance(x, tq.QuantizedTensor):
            calls.append(1)
        return conv(x, *a, **k)
    monkeypatch.setattr(resnet, "conv_int8", counted)
    got = stage(x, int8="static")
    assert len(calls) == (0 if quantized_input else 2)
    want = resnet.unfuse_static_(stage)(x, int8="static")
    assert len(calls) == (0 if quantized_input else 2) + \
        (8 if quantized_input else 10)
    assert got.dtype == dtype and bool((got > 0).any())
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    assert torch.equal(got.view(ints[dtype]), want.view(ints[dtype]))
