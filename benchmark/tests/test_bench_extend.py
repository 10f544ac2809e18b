"""A detector that is not C4 enters the benchmark through added files
alone, on the CPU.

A copy of ``benchmark/`` gets the files of ``tests/toy/added/`` laid
over it, each new there: a stages file with the ``ToyPyramidRCNN.``
prefix and a new ``pyramid`` stage, a reference config extension with a
new key, a reference meta-architecture with two feature levels and
``detect_from_proposals``, whose level embedding takes its law from
``seed_laws``, the cell's configuration, traffic, workload, limits and
work module, and a metric reader (``metrics/pyramid_ms.py``). The copy's
``BENCHMARK.json`` gets the entries of ``tests/toy/entries.json``. The
matching program model (``tests/toy/toy_program.py``) is registered
through the port's ``register_meta_arch``, with a ``get_cfg`` that knows
the new key; a real configuration adds both to the port itself. A
process of its own imports the copy as ``benchmark`` and runs the tiny
cell through ``run_cell``, with ``--trace 0`` and ``--trace 1``, and its
inference control.
"""
import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import build

TOY = os.path.join(build.BENCH, "tests", "toy")
ADDED = os.path.join(TOY, "added")
SEED = 2 ** 31 + 11

DRIVE = f"""
import json, time
import torch
import toy_program
toy_program.install()
from benchmark import build, check, control, spans, trace
from benchmark.reference.locov_ref.config import get_cfg
from benchmark.reference.locov_ref.models import build_meta_arch as ref_arch
from benchmark.run import Run, reader, run_cell
from locov_torch.models import build_meta_arch
cell = build.load_cell("toy_infer")
conf = cell["config"]
cpu = torch.device("cpu")
a = build.make_weights(build_meta_arch(build.program_cfg(conf), device=cpu),
                       {SEED}, cpu, False)
b = build.make_weights(ref_arch(build.reference_cfg(conf), device=cpu),
                       {SEED}, cpu, False)
out = {{
    "default": get_cfg().MODEL.TOY_PYRAMID.CHANNELS,
    "channels": build.reference_cfg(conf).MODEL.TOY_PYRAMID.CHANNELS,
    "same_weights": list(a) == list(b) and all(torch.equal(a[k], b[k])
                                               for k in a),
    "level_embed_std": float(a["pyramid.level_embed"].std()),
    "prefixes": trace.STAGE_PREFIXES,
    "forward": trace.BUCKET_OF_STAGE, "backward": spans.BUCKET_OF_STAGE,
    "readers": {{m: reader(m).__module__
                 for m in ("pyramid_ms.toy", "idle_share.toy")}}}}
for t in (0, 1):
    res = run_cell(Run(cell, {SEED}, 0.5, bool(t), cpu),
                   t_start=time.perf_counter())
    out[str(t)] = {{k: res[k] for k in ("correct", "metrics", "checked")}}
ctrl = control.readings(Run(cell, {SEED}, 0.5, False, cpu, control=True),
                        "control")
out["control"] = {{"numbers": {{k: ctrl[k] for k in cell["limits"]}},
                  "correct": check.verdict(ctrl, cell["limits"])}}
print(json.dumps(out))
"""


def files(root) -> set:
    """Every file under ``root``, relative, ``__pycache__`` left out."""
    out = set()
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {os.path.relpath(os.path.join(d, f), root) for f in names}
    return out


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout: the benchmark's files, the toy's laid over them (each
    new), ``BENCHMARK.json`` with the toy's entries, the program's toy
    model beside them."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(build.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in sorted(files(ADDED)):
        dst = root / "benchmark" / rel
        assert not dst.exists(), rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(ADDED, rel), dst)
    bench = build.read_json(os.path.join(build.ROOT, "BENCHMARK.json"))
    for key, entries in build.read_json(
            os.path.join(TOY, "entries.json")).items():
        bench[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    shutil.copy(os.path.join(TOY, "toy_program.py"), root)
    return root


@pytest.fixture(scope="module")
def toy(checkout):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(checkout), build.ROOT]))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=checkout,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_copy_only_adds_files(checkout):
    orig, copy = files(build.BENCH), files(checkout / "benchmark")
    assert copy - orig == files(ADDED)
    assert orig <= copy
    for rel in sorted(orig):
        assert filecmp.cmp(os.path.join(build.BENCH, rel),
                           checkout / "benchmark" / rel, shallow=False), rel


def test_the_new_key_the_new_law_and_the_new_model(toy):
    assert toy["default"] == 16 and toy["channels"] == 8
    assert toy["same_weights"]
    assert 0.005 < toy["level_embed_std"] < 0.05


def test_the_new_stages_have_their_buckets(toy):
    assert "ToyPyramidRCNN." in toy["prefixes"]
    for side in ("forward", "backward"):
        assert toy[side]["pyramid"] == "pyramid"
        assert toy[side]["box_head"] == "box_head"
    assert toy["forward"]["select_proposals"] == "rpn+nms"  # c4.json's


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_toy_cell_is_correct(toy, trace):
    res = toy[trace]
    assert res["correct"] is True
    checked = res["checked"]
    assert list(checked) == ["rpn_mse_ratio", "proposals_differ",
                             "det_mse_ratio"]
    assert checked["proposals_differ"]["value"] == 0
    # the float32 program against the plain bfloat16 computation
    assert checked["rpn_mse_ratio"]["value"] < 1e-3
    assert checked["det_mse_ratio"]["value"] < 1e-3


def test_a_new_reader_and_an_old_one_under_a_new_suffix(toy):
    metrics = toy["1"]["metrics"]
    assert metrics["pyramid_ms.toy"]["value"] > 0
    assert metrics["rpn_nms_host_ms.toy"]["value"] > 0
    assert toy["readers"] == {"pyramid_ms.toy": "benchmark.metrics.pyramid_ms",
                              "idle_share.toy": "benchmark.metrics.idle_share"}
    assert "idle_share.toy" not in metrics  # no device rows on the CPU
    e2e = toy["0"]["metrics"]
    assert e2e["infer_img_per_s.toy"]["value"] > 0
    assert set(e2e) == {"infer_img_per_s.toy", "peak_mem_gib", "setup_s"}


def test_the_control_without_int8_fails(toy):
    """No ``control_settings``: the reference's detector with its
    products in fp8 in the program's place reads above the limits."""
    assert toy["control"]["correct"] is False
    assert toy["control"]["numbers"]["det_mse_ratio"] > 10.0
