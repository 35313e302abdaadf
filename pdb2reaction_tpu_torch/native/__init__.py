"""ctypes bindings for the two host C++ libraries of ``csrc/``.

- ``csrc/cell_list.cpp``: O(N) cell-list radius queries on the host
  (``cell_list_pairs``, ``radius_query``);
- ``csrc/nlp_solver.cpp``: the projected L-BFGS-B core that drives DMF's
  constrained solve (``engines/dmf.py``, ``solver="native"``) through an
  objective callback evaluated on the calculator's device.

Same signatures as the JAX package's ``native`` module. At first use each
source is compiled with ``g++ -O3 -fPIC -shared -std=c++17`` into the
package's ``_build/`` directory (listed in ``.gitignore``), keyed by a
hash of the source and the flags, and bound with ``ctypes``. Nothing is
built when the module is imported. A failed build raises with the
compiler's log: there is no numpy or scipy route behind it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
SOURCES = ("cell_list", "nlp_solver")

_LIBS: Dict[str, ctypes.CDLL] = {}

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)
_OBJ_GRAD = ctypes.CFUNCTYPE(ctypes.c_double, _DP, _DP, ctypes.c_int64,
                             ctypes.c_void_p)
_SIGNATURES = {
    "cell_list_pairs": (ctypes.c_int64, [_DP, ctypes.c_int32,
                                         ctypes.c_double, _IP,
                                         ctypes.c_int64]),
    "radius_query": (ctypes.c_int64, [_DP, ctypes.c_int32, _DP,
                                      ctypes.c_int32, ctypes.c_double, _IP,
                                      ctypes.c_int64]),
    "lbfgsb_minimize": (ctypes.c_int, [_OBJ_GRAD, ctypes.c_void_p, _DP,
                                       ctypes.c_int64, _DP, _DP,
                                       ctypes.c_int32, ctypes.c_double,
                                       ctypes.c_int32, _DP, _IP]),
}


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found: the native solver and cell list "
                           "need a C++17 compiler (PATH or $CXX)")
    return path


def target(name: str) -> Path:
    """The library of ``csrc/<name>.cpp``, keyed by its source and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> Dict[str, str]:
    """Compile every source of ``SOURCES`` that has no current library,
    both compilers started together. Returns the compiler's log per
    compiled source; raises with it when a compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cpp:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("g++ failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cpp``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(target(name)))
        for fn, (res, args) in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
        _LIBS[name] = lib
    return lib


def _f64(a, shape=(-1, 3)) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).reshape(shape)


def _grow(call, cap: int) -> np.ndarray:
    """Run ``call(buf, cap)`` with a doubling-by-4 buffer until the pairs
    fit; [K, 2] int32."""
    while True:
        buf = np.empty((cap, 2), dtype=np.int32)
        k = call(buf.ctypes.data_as(_IP), cap)
        if k >= 0:
            return buf[:k].copy()
        cap *= 4


def cell_list_pairs(coords: np.ndarray, cutoff: float) -> np.ndarray:
    """All (i < j) pairs within ``cutoff``: [K, 2] int32."""
    x = _f64(coords)
    n = x.shape[0]
    lib = load("cell_list")
    return _grow(lambda buf, cap: lib.cell_list_pairs(
        x.ctypes.data_as(_DP), n, float(cutoff), buf, cap), max(64, n * 64))


def radius_query(coords: np.ndarray, centers: np.ndarray,
                 cutoff: float) -> np.ndarray:
    """All (atom, center) hits within ``cutoff``: [K, 2] int32."""
    x, c = _f64(coords), _f64(centers)
    n, m = x.shape[0], c.shape[0]
    lib = load("cell_list")
    return _grow(lambda buf, cap: lib.radius_query(
        x.ctypes.data_as(_DP), n, c.ctypes.data_as(_DP), m, float(cutoff),
        buf, cap), max(64, n * 8))


def lbfgsb_minimize(
    fun_grad: Callable[[np.ndarray], Tuple[float, np.ndarray]],
    x0: np.ndarray,
    *,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    max_iter: int = 500,
    gtol: float = 1e-5,
    history: int = 10,
) -> Tuple[np.ndarray, float, int, bool]:
    """Box-constrained L-BFGS over a Python objective callback
    ``fun_grad(x) -> (f, grad)``. Returns (x, f, iters, converged).

    ctypes cannot carry an exception out of a callback (it prints it and
    hands the C caller 0), so the first exception is kept, every later
    callback returns NaN at once (the line search then gives up within
    its 80 trials) and the exception is raised here once the solver
    returns."""
    x = _f64(x0, -1).copy()
    dim = x.size
    lib = load("nlp_solver")
    err = []

    def cb(x_ptr, g_ptr, d, _user):
        if err:
            return float("nan")
        try:
            f, g = fun_grad(np.ctypeslib.as_array(x_ptr, shape=(d,)).copy())
            np.ctypeslib.as_array(g_ptr, shape=(d,))[:] = \
                np.asarray(g, dtype=np.float64).reshape(-1)
            return float(f)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            err.append(e)
            return float("nan")

    c_cb = _OBJ_GRAD(cb)
    lo = None if lower is None else _f64(lower, -1)
    hi = None if upper is None else _f64(upper, -1)
    f_out, it_out = ctypes.c_double(), ctypes.c_int32()
    status = lib.lbfgsb_minimize(
        c_cb, None, x.ctypes.data_as(_DP), dim,
        None if lo is None else lo.ctypes.data_as(_DP),
        None if hi is None else hi.ctypes.data_as(_DP),
        int(max_iter), float(gtol), int(history), ctypes.byref(f_out),
        ctypes.byref(it_out))
    if err:
        raise err[0]
    return x, float(f_out.value), int(it_out.value), status == 0
