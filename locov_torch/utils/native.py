"""Build and load the port's native host libraries (C++, no CUDA).

``locov_torch/native/<name>.cpp`` exports plain C functions. It is
compiled by ``g++`` on first use into ``build/native/lib<name>-<hash>.so``
at the repository root (a directory git ignores), named by a hash of the
source and the flags so that an edited source is rebuilt, and loaded
with ``ctypes``. Nothing is written beside the sources, and nothing
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
FLAGS = ("-O3", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(os.path.join(SRC_DIR, name + ".cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built if needed.
    Raises ``OSError`` (``g++`` missing, or the library does not load)
    or ``subprocess.CalledProcessError`` (the build failed): callers
    fall back to their numpy or Python versions."""
    with _LOCK:
        if name not in _LIBS:
            path = lib_path(name)
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                subprocess.run(
                    ["g++", *FLAGS, "-o", tmp,
                     os.path.join(SRC_DIR, name + ".cpp")],
                    check=True, capture_output=True)
                os.replace(tmp, path)
            _LIBS[name] = ctypes.CDLL(path)
        return _LIBS[name]
