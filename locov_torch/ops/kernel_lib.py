"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions. It is compiled on
first use by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root (a directory git ignores),
named by a hash of the source, every header under ``csrc/`` and the
flags, so that an edited source or header is rebuilt, and loaded with
``ctypes``. ``build`` starts one ``nvcc``
per source, all at once, and waits for them. Nothing here runs at
import time: the module imports on a machine without CUDA.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a
wrapper adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("relu_maxpool", "roi_align", "bottleneck_block", "stem_conv_bn",
           "conv_int8", "roi_align_int8", "pair_attention", "rel_attention")

LAUNCHES: Dict[str, int] = {"relu_maxpool": 0, "relu_maxpool_bwd": 0,
                            "roi_align_fused": 0, "roi_align_bwd": 0,
                            "bottleneck_block": 0, "stem_conv_bn": 0,
                            "conv_int8": 0, "roi_align_int8": 0,
                            "pair_attention": 0, "pair_attention_bwd": 0,
                            "rel_attention": 0, "roi_align_levels": 0}
# nvcc's output (ptxas register and spill report) of the last build
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile the named kernels that are not built yet, one ``nvcc``
    per source, in parallel. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = lib_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(lib_path(name))
    return _LIBS[name]


def load_source(src: str, name: str) -> ctypes.CDLL:
    """Another kernel source ``src`` (for example an earlier version of a
    file in ``csrc/``, timed against it) built by ``nvcc`` with the same
    flags into ``build/kernels/<name>.so`` and loaded."""
    so = os.path.join(BUILD_DIR, name + ".so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(os.path.abspath(so))


def check_cuda_tensor(t: torch.Tensor, what: str, dtypes) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of
    ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_launch(err: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error (it returns
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points
    take it (launch inside ``torch.cuda.device(device)``)."""
    return torch.cuda.current_stream(device).cuda_stream
