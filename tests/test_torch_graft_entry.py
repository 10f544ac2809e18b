"""The port's twin of ``__graft_entry__.py``
(``locov_torch/graft_entry.py``): ``entry()``'s loss step is finite and
differentiable on the CPU, and ``dryrun_multichip(2)`` runs one
data-parallel training step over two spawned gloo ranks, printing a
finite loss."""
import math

from locov_torch import graft_entry
from torch_parity import two_threads  # noqa: F401 (autouse)


def test_entry_loss_is_finite_and_differentiable():
    fn, args = graft_entry.entry(device="cpu")
    loss = fn(*args)
    assert loss.dim() == 0 and math.isfinite(float(loss))
    assert loss.requires_grad


def test_dryrun_multichip_two_ranks(capfd):
    graft_entry.dryrun_multichip(2)
    out = capfd.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("dryrun_multichip(2): OK"))
    assert math.isfinite(float(line.split("total_loss=")[1].split(",")[0]))
