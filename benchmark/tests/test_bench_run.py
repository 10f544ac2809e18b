"""The command's contract: no result without a card (it never falls
back to the CPU), none in a checkout holding only the benchmark's files;
on the card (marked ``gpu``), one result line with the contract's
keys."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import build

COMMAND = json.load(open(os.path.join(build.ROOT, "BENCHMARK.json")))[
    "command"]


def run(cwd, *extra, env=None):
    args = [sys.executable] + COMMAND[1:] + [
        "--workload", "stt_infer_b8", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=600)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(build.ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(os.path.join(build.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(build.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        build.load_cell("no_such_cell")


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run(build.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checked"
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"infer_img_per_s", "peak_mem_gib",
                                    "setup_s"}
