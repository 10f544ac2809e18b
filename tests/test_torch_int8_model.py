"""PyTorch port vs JAX: the tiny ``OvrRCNN`` in the int8 serving mode,
the dynamic scheme and the model's own contracts
(``test_torch_int8_static.py`` holds the static scheme against JAX's).

The JAX model's float32 weights (one jitted init) and, for the static
scheme, its calibrated ``quant`` collection are carried into the port by
``from_flax``. The RPN is tamed as ``tests/test_int8.py:_tame_rpn`` tames
it (zero anchor deltas: the proposals are the clipped anchors), with
test_torch_ovr_rcnn.py's pixel std and class-embedding scale.

Tolerances: detection masks and classes equal; scores within 1e-3 and
boxes within 0.05 px of JAX's. Every int8 value and int32 sum is exact
in both packages, so what can differ is a float32 activation an ulp
apart (the stem's and the float ROIAlign's summation order) that moves
an int8 rounding by one step. The trunk's int8 output came out
bit-equal to JAX's here and the scores within 1e-7. The JAX model runs
eagerly, as JAX's own int8 tests run it: jitted, XLA fuses the float
stem otherwise, and the steps that flip then carry through the 16 int8
blocks to the scores, by up to 2.7e-3 on this tiny model (measured), as
they would between any two float implementations. The calibrated
max-abs values are held within rtol 1e-5. The port's own static run
after one calibration pass on the batch is held to its dynamic run at
JAX's tolerances (test_int8_static_calibrate_flow: scores rtol = atol =
1e-6, boxes rtol 1e-5, atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from locov_tpu.config import get_cfg as jget
from locov_tpu.models import build_meta_arch as jbuild
from locov_tpu.structures.batches import DetectionBatch as JBatch
from locov_tpu.structures.batches import ImageBatch as JImages
from locov_tpu.utils.checkpoint import flatten_params, unflatten_params
from locov_torch.config import get_cfg as tget
from locov_torch.models import build_meta_arch as tbuild
from locov_torch.structures.batches import DetectionBatch as TBatch
from locov_torch.structures.batches import ImageBatch as TImages
from locov_torch.utils.checkpoint import merge_over_template
from locov_torch.utils.weights import from_flax
from torch_parity import n, t, tiny_cfg

EXTRA = {"MODEL.PIXEL_STD": [57.375, 57.12, 58.395]}


def _cfg(get_cfg, scheme=None, roialign=True):
    extra = dict(EXTRA)
    if scheme:
        extra.update({"TPU.INT8_EVAL": True, "TPU.INT8_SCHEME": scheme,
                      "TPU.INT8_ROIALIGN": roialign})
    return tiny_cfg(get_cfg, **extra)


def quant_flat(quant) -> dict:
    """A Flax ``quant`` collection -> {"quant/<path>": numpy}."""
    return {"quant/" + k: np.asarray(v) for k, v in
            flatten_params(jax.device_get(quant)).items()}


def jax_int8_setup(static: bool) -> dict:
    """The tiny model's tamed float weights, the batch, and JAX's
    detections: the dynamic scheme, or (``static``) the ``quant``
    collection of one calibration pass on the batch and the static
    scheme's detections with the full-int8 ROIAlign and without."""
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    hw = np.array([[64, 64], [48, 56]], np.int32)
    ohw = np.array([[128, 128], [96, 112]], np.int32)
    ce = (rng.randn(6, 8) * 0.1).astype(np.float32)
    ce[-1] = 0.0
    jb = JBatch(images=JImages(image=jnp.asarray(img), hw=jnp.asarray(hw),
                               orig_hw=jnp.asarray(ohw)))
    jce = jnp.asarray(ce)
    jm = jbuild(_cfg(jget))
    v = jax.jit(lambda b, c: jm.init(jax.random.PRNGKey(0), b, c,
                                     method=jm.inference))(jb, jce)
    flat = {k: np.asarray(a) for k, a in
            flatten_params(jax.device_get(v["params"])).items()}
    for k in flat:
        if "anchor_deltas" in k:
            flat[k] = np.zeros_like(flat[k])
    params = unflatten_params({k: jnp.asarray(a) for k, a in flat.items()})

    def infer(m, variables):
        return m.apply(variables, jb, jce, method=m.inference)

    out = dict(flat=flat, jb=jb, ce=ce,
               tb=TBatch(images=TImages(image=t(img), hw=t(hw),
                                        orig_hw=t(ohw))))
    if not static:
        out["dyn"] = infer(jbuild(_cfg(jget, "dynamic")), {"params": params})
        return out
    jsta = jbuild(_cfg(jget, "static"))
    _, upd = jsta.apply({"params": params}, jb, jce,
                        method=jsta.calibrate_int8, mutable=["quant"])
    out["quant"] = quant_flat(upd["quant"])
    variables = {"params": params, "quant": upd["quant"]}
    out["static"] = infer(jsta, variables)
    out["static_noroi"] = infer(jbuild(_cfg(jget, "static", False)),
                                variables)
    return out


@pytest.fixture(scope="module")
def int8_pair():
    return jax_int8_setup(static=False)


def _port(p, scheme=None, roialign=True, quant=True):
    """The port's tiny model with JAX's weights and, with ``quant``,
    JAX's calibrated values; else the max-abs buffers keep their zero
    init (``merge_over_template``'s rule)."""
    tm = tbuild(_cfg(tget, scheme, roialign), device="cpu")
    state = from_flax({**p["flat"], **(p["quant"] if quant else {})})
    tm.load_state_dict(merge_over_template(tm.state_dict(), state),
                       strict=True)
    return tm


def _assert_close(got, want):
    m = n(want.mask)
    assert m.sum() >= 10
    np.testing.assert_array_equal(n(got.mask), m)
    np.testing.assert_array_equal(n(got.classes)[m], n(want.classes)[m])
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(n(got.boxes)[m], n(want.boxes)[m], rtol=0,
                               atol=0.05)


def test_dynamic_matches_jax(int8_pair):
    tm = _port(int8_pair, "dynamic", quant=False)
    got = tm.inference(int8_pair["tb"], t(int8_pair["ce"]))
    _assert_close(got, int8_pair["dyn"])


@pytest.mark.parametrize("roialign", [True, False])
def test_static_after_calibration_equals_dynamic(int8_pair, roialign):
    """The running max-abs values start at zero, so after one pass each
    static scale is the dynamic one of that batch. With the float
    ROIAlign the two runs are the same arithmetic, held at JAX's
    tolerances. The full-int8 one interpolates in int8 (JAX's budget:
    within 3.5 steps of the pooled tensor's scale an element,
    tests/test_roi_align.py), another rounding noise than the dynamic
    run's: it moved the scores by 1.2e-3 here (measured), held within
    5e-3 with the same detections kept."""
    tdyn = _port(int8_pair, "dynamic", quant=False)
    tsta = _port(int8_pair, "static", roialign, quant=False)
    batch, ce = int8_pair["tb"], t(int8_pair["ce"])
    want = tdyn.inference(batch, ce)
    tsta.calibrate_int8(batch, ce)
    got = tsta.inference(batch, ce)
    np.testing.assert_array_equal(n(got.mask), n(want.mask))
    if roialign:
        np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=0,
                                   atol=5e-3)
        return
    np.testing.assert_allclose(n(got.scores), n(want.scores), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n(got.boxes), n(want.boxes), rtol=1e-5,
                               atol=1e-4)
