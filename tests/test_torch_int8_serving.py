"""The static int8 scheme exported (``locov_torch/serving.py``): the
tiny ``OvrRCNN`` of tests/test_torch_int8_engine.py, calibrated, with
the full-int8 ROIAlign and with the float one quantized after it,
exported on the CPU and loaded; the program computes what the eager
model does, to the bit (``exported_equals_eager``; the dynamic scheme's
export is in test_torch_int8_engine.py, to spread the exports over the
suite's workers)."""
import pytest

from test_torch_int8_engine import batch, exported_equals_eager  # noqa: F401


@pytest.mark.parametrize("roialign", [True, False])
def test_exported_static_int8_program_equals_eager(batch, tmp_path,
                                                   roialign):
    exported_equals_eager(batch, tmp_path, "static", roialign)
