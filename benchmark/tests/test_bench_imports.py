"""The import boundary: nothing under ``benchmark/`` imports JAX, its
libraries or the JAX package (top-level names compared whole: the
program's name begins with the JAX package's), and nothing under
``benchmark/reference/`` imports the program."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark import build

BENCH = build.BENCH


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in sources(BENCH):
        bad = set(imports(path)) & set(build.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert "locov_torch" not in set(imports(path)), path


def test_names_are_compared_whole():
    from benchmark.run import forbidden_modules
    assert "locov_torch" not in forbidden_modules()
    sys.modules["locov_tpu_x"] = sys  # a longer name is another package
    try:
        assert forbidden_modules() == []
    finally:
        del sys.modules["locov_tpu_x"]


@pytest.mark.parametrize("cell", ["lsm_global_b32", "stt_infer_b8"])
def test_a_run_loads_no_jax(cell):
    """The harness, the program and the reference in one process, as a
    run loads them: no forbidden top-level module."""
    code = ("import sys, benchmark.run, benchmark.check, benchmark.control,"
            " benchmark.loops, locov_torch.models.meta_arch.mmss_gcnn, "
            "locov_torch.parallel.mesh, locov_torch.engine.solver;"
            "from benchmark.reference.locov_ref.models.meta_arch import "
            "mmss_gcnn, ovr_rcnn;"
            "from benchmark.run import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=build.ROOT, check=True)
    assert out.stdout.strip() == "[]"
