"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source `theia_tpu_torch/csrc/<name>.cu` with a plain
C entry point. At first use it is compiled by nvcc for Hopper
(`sm_90a`) into a shared library under `theia_tpu_torch/_build/`
(listed in .gitignore) and loaded with ctypes. The library's file
name carries a hash of the source and the flags, so an edited source
is never served by a stale build.

Nothing here runs at import: a machine without nvcc (the CPU tests)
can import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: no --use_fast_math: the kernels hold bit-exactness with their plain
#: versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                           "to build the port's kernels")
    return path


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(name: str, src: Path, path: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit "
                               f"{done.returncode}):\n{done.stdout}"
                               f"{done.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = _target(name)
            if not path.exists():
                _compile(name, src, path)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
