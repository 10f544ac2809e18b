"""The twins of ``tools/bench_loader.py`` and ``tools/bench_pairwise.py``
(locov_torch/tools/) against the repository's tools, which run the JAX
package.

- ``bench_loader.make_dataset`` writes JAX's tool's files byte for byte,
  with the same records, captions and proposals; the twin's
  ``build_loader`` (no workers) gives JAX's tool's first batch on those
  files, every array equal: images, the proposals as binary gt (gt),
  the original gt (gt_obj), token ids, MLM targets and mask.
- ``bench_loader.main`` prints JAX's tool's keys; without
  ``--device-rate`` (JAX's default is a TPU rate) ``vs_baseline`` is
  null.
- ``bench_pairwise.main --device cpu`` at one pair prints JAX's keys
  (``compile_s`` as ``first_call_s``) and a finite time.
"""
import importlib.util
import json
import math
import os
import sys

import numpy as np

from locov_torch.tools import bench_loader, bench_pairwise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LOADER_KEYS = {"metric", "value", "unit", "vs_baseline", "per_workers"}
JAX_PAIRWISE_KEYS = {"metric", "pairs", "chunk", "fwd_only", "value",
                     "unit", "compile_s", "peak_hbm_gb", "ms_per_pair"}


def _jax_tool(name):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    out = {}
    for f in sorted(os.listdir(root)):
        with open(os.path.join(root, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _arrays(batch, prefix=""):
    """{field path: numpy array} of a (nested) batch NamedTuple."""
    out = {}
    for k, v in batch._asdict().items():
        if v is None:
            out[prefix + k] = None
        elif hasattr(v, "_asdict"):
            out.update(_arrays(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_make_dataset_byte_equal_jax(tmp_path):
    jax_tool = _jax_tool("bench_loader")
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    ja = jax_tool.make_dataset(str(a), 6, seed=0)
    pa = bench_loader.make_dataset(str(b), 6, seed=0)
    files = _files(a)
    assert len(files) == 6 and files == _files(b)
    for rec_j, rec_p in zip(ja[0], pa[0]):
        assert os.path.basename(rec_j.pop("file_name")) == \
            os.path.basename(rec_p.pop("file_name"))
        assert rec_j == rec_p
    assert ja[1] == pa[1]
    assert ja[2].keys() == pa[2].keys()
    for i in ja[2]:
        np.testing.assert_array_equal(ja[2][i], pa[2][i])


def test_first_batch_equals_jax(tmp_path):
    """Both loaders read the same files, JAX's tool's records."""
    jax_tool = _jax_tool("bench_loader")
    ja = jax_tool.make_dataset(str(tmp_path), 6, seed=0)
    want = _arrays(next(iter(jax_tool.build_loader(*ja, 2, 0))))
    got = _arrays(next(iter(bench_loader.build_loader(*ja, 2, 0))))
    assert want.keys() == got.keys()
    for k in ("images.image", "gt.boxes", "text.input_ids",
              "text.target_ids", "text.mlm_mask"):
        assert got[k] is not None and got[k].size > 0, k
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_bench_loader_main_prints_jax_keys(monkeypatch, capsys):
    argv = ["--images", "4", "--seconds", "0.1", "--workers", "0"]
    monkeypatch.setattr(sys, "argv", ["bench_loader.py"] + argv)
    _jax_tool("bench_loader").main()
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(jax_line) == JAX_LOADER_KEYS
    line = bench_loader.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert JAX_LOADER_KEYS <= set(printed)
    assert printed["vs_baseline"] is None and printed["device"] == "cpu"
    assert set(printed["per_workers"]) == set(jax_line["per_workers"])
    assert printed["value"] > 0
    line = bench_loader.main(argv + ["--device", "cpu", "--device-rate",
                                     "2.0"])
    assert line["vs_baseline"] == line["value"] / 2.0


def test_bench_pairwise_main_on_the_cpu(capsys):
    line = bench_pairwise.main(["--device", "cpu", "--batch", "1",
                                "--regions", "4", "--tokens", "6",
                                "--fwd-only"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) >= JAX_PAIRWISE_KEYS - {"compile_s"} | {"first_call_s"}
    assert "compile_s" not in line
    assert line["metric"] == "pairwise_encoder_ms"
    assert (line["pairs"], line["chunk"], line["fwd_only"]) == (1, 128, True)
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["ms_per_pair"] == line["value"]
    # 10 tokens x 6 layers x 2 x (4 d^2 + 2 d ffn + 2 x 10 d), d = ffn = 768
    assert line["matmul_tflop"] == 60 * 2 * (6 * 768 ** 2 + 20 * 768) / 1e12
    assert line["peak_hbm_gb"] is None and line["device"] == "cpu"
