"""The int8 serving mode around the model: calibration steps,
checkpoints, the exported program and the bench twin's switches, on the
tiny ``OvrRCNN`` of tests/torch_parity.py with seeded weights (the RPN
tamed, as the parity tests tame it), on the CPU. JAX's behaviour they
follow: a calibration pass only raises the running maxima
(test_int8_calibrate_step_on_mesh); a checkpoint carries the calibrated
values, and one written before they existed loads with their zero init,
so it reads as uncalibrated (``locov_tpu/utils/checkpoint.py:
merge_over_template``); the exported dynamic int8 program gives the
eager model's bits (tests/test_torch_int8_serving.py: the static
scheme's)."""
import numpy as np
import pytest
import torch

from locov_torch.config import config_path, get_cfg
from locov_torch.engine import trainer
from locov_torch.models import build_meta_arch
from locov_torch.parallel.mesh import make_calibrate_step
from locov_torch.serving import export_inference, load_exported
from locov_torch.structures.batches import DetectionBatch, ImageBatch
from locov_torch.tools import bench, export_serving
from locov_torch.utils.checkpoint import (Checkpointer,
                                          load_weights_standalone)
from locov_torch.utils.weights import seeded_init_
from torch_parity import t, tiny_cfg

EXTRA = {"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]}


def _cfg(scheme=None, roialign=True):
    extra = dict(EXTRA)
    if scheme:
        extra.update({"TPU.INT8_EVAL": True, "TPU.INT8_SCHEME": scheme,
                      "TPU.INT8_ROIALIGN": roialign})
    return tiny_cfg(get_cfg, **extra)


def _model(scheme=None, roialign=True):
    model = seeded_init_(build_meta_arch(_cfg(scheme, roialign),
                                         device="cpu"), 0)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if "anchor_deltas" in k:
                p.zero_()
    return model


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    hw = np.array([[64, 64], [48, 56]], np.int32)
    ohw = np.array([[128, 128], [96, 112]], np.int32)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    return DetectionBatch(images=ImageBatch(image=t(img), hw=t(hw),
                                            orig_hw=t(ohw))), t(ce)


def test_calibration_only_raises_the_maxima(batch):
    data, ce = batch
    model = _model("static")
    step = make_calibrate_step(model)
    first = {k: v.clone() for k, v in step(data, ce).items()}
    assert len(first) == 54 and all(float(v) > 0 for v in first.values())
    bright = data._replace(images=data.images._replace(
        image=data.images.image * 2.0))
    second = step(bright, ce)
    assert all(float(second[k]) >= float(first[k]) for k in first)
    assert any(float(second[k]) > float(first[k]) for k in first)
    # the buffers are updated in place, never replaced by inference
    # tensors
    assert all(v is b for v, b in zip(second.values(),
                                      model.amax_buffers().values()))
    assert not any(v.is_inference() for v in second.values())


def test_checkpoints_carry_the_maxima(batch, tmp_path, monkeypatch):
    """A checkpoint of a calibrated model restores its values; one of a
    float model (written before the buffers existed) loads into the
    static model with zeros there, and ``maybe_calibrate_int8``
    calibrates it; a calibrated one it leaves alone."""
    data, ce = batch
    model = _model("static")
    model.calibrate_int8(data, ce)
    ckpt = Checkpointer(str(tmp_path), use_async=False)
    ckpt.save_named("calibrated", {"model": model.state_dict()})
    ckpt.save_named("float", {"model": _model().state_dict()})
    fresh = _model("static")
    load_weights_standalone(fresh, str(tmp_path / "calibrated"))
    for k, v in model.amax_buffers().items():
        assert torch.equal(fresh.amax_buffers()[k], v), k
    old = _model("static")
    report = load_weights_standalone(old, str(tmp_path / "float"))
    assert sorted(report.missing) == sorted(old.amax_buffers())
    assert all(float(v) == 0 for v in old.amax_buffers().values())

    cfg = _cfg("static")
    calls = []
    monkeypatch.setattr(trainer, "build_test_loader",
                        lambda *a, **k: _Loader([data]))
    for m, want in ((fresh, False), (old, True)):
        m.calibrate_int8 = lambda *a: calls.append(1)
        assert trainer.maybe_calibrate_int8(cfg, m, "any", ce) is want
    assert len(calls) == 1
    assert trainer.maybe_calibrate_int8(cfg, _model(), "any", ce) is False


class _Loader(list):
    """A test loader of the given batches."""

    def close(self):
        pass


def exported_equals_eager(batch, tmp_path, scheme, roialign=True):
    """The exported program of the tiny model under ``scheme`` (int8 ops
    through their fakes, the max-abs buffers among the variables),
    loaded, gives the eager model's bits on the CPU."""
    data, ce = batch
    model = _model(scheme, roialign)
    if scheme == "static":
        model.calibrate_int8(data, ce)
    want = model.inference(data, ce)
    out = str(tmp_path / "art")
    export_inference(model, ce, out, 2, 64, 64)
    call, variables, class_emb = load_exported(out)
    assert (len([k for k in variables if k.endswith("amax")]) ==
            (54 if scheme == "static" else 0))
    im = data.images
    got = call(variables, im.image, im.hw, im.orig_hw, class_emb)
    for k in ("boxes", "scores", "classes", "mask"):
        assert torch.equal(got[k], getattr(want, k).to(got[k].dtype)), k
    assert want.mask.sum() >= 10


def test_exported_dynamic_int8_program_equals_eager(batch, tmp_path):
    exported_equals_eager(batch, tmp_path, "dynamic")


def test_dynamic_int8_refuses_a_multi_device_export(batch, tmp_path,
                                                    capsys):
    """N separate device programs share no reduce, so the dynamic scheme
    (scales over the whole batch) is refused for N > 1 by
    ``export_inference`` and the export twin, which name the static
    scheme; N = 1 exports (the test above)."""
    _, ce = batch
    with pytest.raises(ValueError, match="TPU.INT8_SCHEME static"):
        export_inference(_model("dynamic"), ce, str(tmp_path / "a"), 2,
                         64, 64, n_devices=2)
    with pytest.raises(SystemExit):
        export_serving.main(["--config-file", config_path("coco_stt.yaml"),
                             "--out", str(tmp_path / "b"), "--device", "cpu",
                             "--n-devices", "2", "TPU.INT8_EVAL", "True",
                             "TPU.INT8_SCHEME", "dynamic"])
    assert "TPU.INT8_SCHEME static" in capsys.readouterr().err
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_bench_twin_int8_switches(monkeypatch):
    """``LOCOV_INT8_EVAL``, ``LOCOV_INT8_SCHEME`` and
    ``LOCOV_INT8_ROIALIGN`` as ``bench.py`` reads them, and the line's
    ``variant``."""
    for k in ("LOCOV_INT8_EVAL", "LOCOV_INT8_SCHEME", "LOCOV_INT8_ROIALIGN"):
        monkeypatch.delenv(k, raising=False)
    cfg = get_cfg()
    assert bench.variant(cfg) == "bf16"
    monkeypatch.setenv("LOCOV_INT8_EVAL", "1")
    monkeypatch.setenv("LOCOV_INT8_SCHEME", "static")
    monkeypatch.setenv("LOCOV_INT8_ROIALIGN", "0")
    built = {}
    # the full-width model is not built: its config is what is checked
    monkeypatch.setattr(bench, "build_meta_arch",
                        lambda cfg, device=None: built.setdefault(
                            "cfg", cfg) and torch.nn.Linear(1, 1))
    monkeypatch.setattr(bench, "seeded_init_", lambda m, seed: m)
    cfg, _, data, _ = bench.build_stt_eval(batch=1, height=32, width=32,
                                           device="cpu")
    assert cfg.TPU.INT8_EVAL and cfg.TPU.INT8_SCHEME == "static"
    assert not cfg.TPU.INT8_ROIALIGN and built["cfg"] is cfg
    assert bench.variant(cfg) == "int8-static"
    assert tuple(data.images.image.shape) == (1, 32, 32, 3)
    monkeypatch.setenv("LOCOV_INT8_SCHEME", "dynamic")
    monkeypatch.delenv("LOCOV_INT8_ROIALIGN")
    cfg = bench.build_stt_eval(batch=1, height=32, width=32,
                               device="cpu")[0]
    assert bench.variant(cfg) == "int8-dynamic" and cfg.TPU.INT8_ROIALIGN
