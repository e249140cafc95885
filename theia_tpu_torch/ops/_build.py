"""Build, load, bind and launch the port's hand-written CUDA kernels.

Each kernel is one source `theia_tpu_torch/csrc/<name>.cu` with a plain
C entry point. At first use it is compiled by nvcc for Hopper
(`sm_90a`) into a shared library under `theia_tpu_torch/_build/`
(listed in .gitignore) and loaded with ctypes. The library's file
name carries a hash of the source and the flags, so an edited source
is never served by a stale build.

The launch protocol every entry point keeps: it takes the wrapper's
arguments and then the CUDA stream, enqueues its work there and
returns a CUDA error code (0 on success). `bind` checks the library's
exported constants against the wrapper's before the first call;
`launch` calls an entry point on a device's current stream, raises on
an error and counts the launch under the library's name; `launches`
is the one reader of the counts.

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
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: no --use_fast_math: the kernels hold bit-exactness with their plain
#: versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Any] = {}
_count_lock = threading.Lock()
_launches: Dict[str, int] = {}


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
    """The loaded kernel library `name`, built at first use. Libraries
    of different names build in parallel when asked from threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = _target(name)
            if not path.exists():
                _compile(name, src, path)
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, entry: str, argtypes: Sequence,
         constants: Mapping[Tuple, int]):
    """The entry point `entry` of library `name`, as a ctypes function
    that takes `argtypes` and then the stream, and returns an error
    code. `constants` maps (exported function, *its arguments) to the
    value the wrapper assumes; the first bind of an entry point raises
    RuntimeError if the library returns another."""
    fn = _bound.get((name, entry))
    if fn is None:
        lib = library(name)
        want = dict(constants)
        got = {c: getattr(lib, c[0])(*c[1:]) for c in want}
        if got != want:
            raise RuntimeError(f"{name}: the library's constants {got} "
                               f"differ from the wrapper's {want}")
        fn = getattr(lib, entry)
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[(name, entry)] = fn
    return fn


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call `fn` (bound from library `name`) with `args` and the
    current stream of `device`, that device current. A non-zero return
    raises RuntimeError and is not counted; a zero return counts one
    launch of `name`."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1


def launches() -> Dict[str, int]:
    """Launches since import by library name, as a copy: a caller
    takes one before and one after the work it counts. A call on CPU
    tensors runs a plain version and launches nothing."""
    with _count_lock:
        return dict(_launches)
