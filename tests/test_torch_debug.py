"""PyTorch port vs JAX: NaN forensics (``locov_torch/utils/debug.py``
against ``locov_tpu/utils/debug.py``).

``tensor_stats`` equals JAX's within rtol 1e-6 (float32 reductions in
another order), in float32 and from bfloat16; ``nan_guard`` prints the
stats only for a tensor that is not finite and returns its input;
``enable_nan_debugging`` turns on autograd's anomaly mode, under which a
backward that makes a NaN raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locov_tpu.utils import debug as jdebug
from locov_torch.utils import debug as tdebug


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_stats_match_jax(rng, dtype):
    x = (rng.randn(4, 5, 6) * 3 + 1).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got, want = tdebug.tensor_stats("feat", tx), jdebug.tensor_stats("feat",
                                                                     jx)
    assert set(got) == set(want) == {"feat/min", "feat/max", "feat/mean",
                                     "feat/std"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_nan_guard_prints_only_when_not_finite(capsys):
    x = torch.tensor([1.0, 2.0, 3.0])
    assert tdebug.nan_guard("ok", x) is x
    assert capsys.readouterr().out == ""
    y = torch.tensor([1.0, float("nan"), 3.0])
    assert tdebug.nan_guard("bad", y) is y
    out = capsys.readouterr().out
    assert out.startswith("NaN-guard [bad]: finite=False")
    assert tdebug.nan_guard("off", y, enabled=False) is y
    assert capsys.readouterr().out == ""


def test_enable_nan_debugging_raises_in_the_backward():
    try:
        tdebug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.warns(UserWarning), pytest.raises(RuntimeError,
                                                      match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
