"""Build, load and launch the port's hand-written CUDA kernels.

``TABLE`` is the one list of them: a launch key for each kernel a
wrapper in ``ops/`` launches, with its source ``csrc/<source>.cu``, the
plain C functions it exports for that kernel (each with the ctypes
types of its arguments, the CUDA stream last in every one) and the
names of the ``__global__`` functions a profiler sees. ``KERNELS``,
``LAUNCHES`` and ``DEVICE_FUNCTIONS`` are read from it, and
``tests/test_torch_library.py`` holds it to the sources.

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into
its own shared library under ``build/kernels/`` at the repository root
(a directory git ignores), named by a hash of the source, every header
under ``csrc/`` and the flags, so that an edited source or header is
rebuilt, and loaded with ``ctypes``. ``build`` starts one ``nvcc`` per
source, all at once, and waits for them. ``launch`` calls a C entry on
a tensor's device and current stream. Nothing here runs at import
time: the module imports on a machine without CUDA.

``LAUNCHES`` counts, per key, the launches its wrapper made; a wrapper
adds one for each call that launches its kernel, and the launchers
that take an explicit plan (``_launch*``) add none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class Kernel(NamedTuple):
    """One launch key. ``entries``: C symbol -> its arguments before the
    stream, as counts of P (pointer), I (int) and F (float) in order."""
    source: str
    entries: Dict[str, str]
    device: Tuple[str, ...]


TABLE: Dict[str, Kernel] = {
    "relu_maxpool": Kernel(
        "relu_maxpool", {"relu_maxpool_fwd": "2P 8I"},
        ("relu_maxpool_kernel",)),
    "relu_maxpool_bwd": Kernel(
        "relu_maxpool", {"relu_maxpool_bwd": "3P 8I",
                         "relu_maxpool_bwd_rows": "3P 9I"},
        ("relu_maxpool_bwd_kernel",)),
    "roi_align_fused": Kernel(
        "roi_align", {"roi_align_fwd": "3P 7I F 6I"},
        ("roi_align_fwd_kernel",)),
    "roi_align_bwd": Kernel(
        "roi_align", {"roi_align_bwd": "3P 7I F 5I"},
        ("roi_align_bwd_kernel",)),
    "roi_align_levels": Kernel(
        "roi_align", {"roi_align_levels_fwd": "4P I 3P 11I"},
        ("roi_align_levels_fwd_kernel",)),
    "bottleneck_block": Kernel(
        "bottleneck_block", {"bottleneck_block_fwd": "8P 6I"},
        ("block_bf16", "block_f32")),
    "stem_conv_bn": Kernel(
        "stem_conv_bn", {"stem_conv_bn_fwd": "4P 5I"},
        ("stem_conv_kernel",)),
    "conv_int8": Kernel(
        "conv_int8", {"conv_int8_fwd": "8P 13I"}, ("conv_int8_wgmma",)),
    "roi_align_int8": Kernel(
        "roi_align_int8", {"roi_align_int8_fwd": "4P 7I F 3I"},
        ("roi_align_int8_kernel",)),
    "pair_attention": Kernel(
        "pair_attention", {"pair_attention_fwd": "7P 4I 3F"},
        ("pair_attention_fwd_kernel",)),
    "pair_attention_bwd": Kernel(
        "pair_attention", {"pair_attention_bwd": "7P 4I 2F"},
        ("pair_attention_bwd_kernel",)),
    "rel_attention": Kernel(
        "rel_attention", {"rel_attention_fwd": "4P 6I F"},
        ("rel_attention_kernel",)),
}
KERNELS = tuple(dict.fromkeys(k.source for k in TABLE.values()))
DEVICE_FUNCTIONS = tuple(f for k in TABLE.values() for f in k.device)
LAUNCHES: Dict[str, int] = dict.fromkeys(TABLE, 0)
# nvcc's output (ptxas register and spill report) of the last build
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_KEY = {sym: key for key, k in TABLE.items() for sym in k.entries}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def argtypes(symbol: str) -> list:
    """The ctypes argument types of the C entry ``symbol``, the stream
    last."""
    spec = TABLE[_KEY[symbol]].entries[symbol]
    types = []
    for tok in spec.split():
        types += [_CTYPES[tok[-1]]] * int(tok[:-1] or 1)
    return types + [ctypes.c_void_p]


def launch(symbol: str, device: torch.device, *args,
           lib: ctypes.CDLL = None) -> None:
    """Call the C entry ``symbol`` with ``args`` and ``device``'s current
    stream, with ``device`` current; raise if it reports a CUDA error.
    ``lib``: another build of its source (an earlier version timed
    against it); by default the table's. The entry's argument types and
    int result are set once: an entry left without them passes a Python
    int as a C int, which truncates a 64-bit pointer."""
    key = _KEY[symbol]
    fn = getattr(load(TABLE[key].source) if lib is None else lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes(symbol)
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, stream_ptr(device))
    check_launch(err, key)


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
