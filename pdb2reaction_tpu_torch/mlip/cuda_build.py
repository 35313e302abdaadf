"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library in the
package's ``_build/`` directory (listed in ``.gitignore``), keyed by a hash
of the source so an edited file is rebuilt, and bound with ``ctypes``.
Nothing is built when a module is imported: the CPU paths never need
``nvcc``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}     # name -> {"seconds", "ptxas"}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, float]:
    """Compile every named source that has no current library, all nvcc
    processes started together. Returns seconds per compiled source.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": times[name], "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def call(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Call a C entry: ``int`` arguments go as C ints, ``ptr(...)``
    arguments as pointers. Raises if the entry returns a CUDA error."""
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p if isinstance(a, _Ptr) else ctypes.c_int
                  for a in args]
    rc = f(*[a.value if isinstance(a, _Ptr) else int(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed with cudaError {rc}")


class _Ptr:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def ptr(t) -> _Ptr:
    """Device pointer of a tensor (or None -> NULL)."""
    return _Ptr(None if t is None else t.data_ptr())


def stream_ptr() -> _Ptr:
    import torch
    return _Ptr(torch.cuda.current_stream().cuda_stream)
