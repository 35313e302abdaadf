"""The port's native libraries (``native/__init__.py`` over
``pdb2reaction_tpu_torch/csrc/*.cpp``) against the JAX package's
``native`` module on the same inputs:

- twins of ``tests/test_native.py``: the cell list's pairs and the radius
  query's hits the same sets as JAX's (and as numpy's), the L-BFGS-B
  core on a quadratic and on a bounded Rosenbrock equal to JAX's to
  1e-12 (the same C++), with the same iteration counts;
- an exception raised inside the objective callback comes out of
  ``lbfgsb_minimize`` (ctypes alone prints it and hands the solver 0),
  and the callback is not called again after it;
- the build: a library named by the hash of its source, a compile error
  raised with the compiler's log, and neither source in the CUDA build's
  list."""

import shutil
import time

import numpy as np
import pytest

from pdb2reaction_tpu_torch import native
from pdb2reaction_tpu_torch.mlip import cuda_build


def jax_native():
    """The JAX package's native module with its C++ libraries loaded. It
    builds them on first use and falls back to numpy and scipy quietly
    when a load fails, as it may while another test process is still
    writing them: retry until both are loaded."""
    from pdb2reaction_tpu import native as jn
    for _ in range(10):
        if jn.available():
            return jn
        time.sleep(2.0)
        jn._tried = False
    raise AssertionError("the JAX package's native libraries did not load")


def test_cell_list_matches_jax():
    x = np.random.default_rng(42).uniform(0, 15, size=(800, 3))
    pairs = native.cell_list_pairs(x, 2.0)
    assert pairs.dtype == np.int32 and pairs.shape[1] == 2
    got = set(map(tuple, pairs))
    assert got == set(map(tuple, jax_native().cell_list_pairs(x, 2.0)))
    d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    ii, jj = np.nonzero(np.triu(d <= 2.0, 1))
    assert got == set(zip(ii, jj))


def test_radius_query_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 10, size=(500, 3))
    c = rng.uniform(0, 10, size=(7, 3))
    hits = set(map(tuple, native.radius_query(x, c, 1.8)))
    assert hits == set(map(tuple, jax_native().radius_query(x, c, 1.8)))
    d = np.linalg.norm(x[:, None] - c[None, :], axis=-1)
    assert hits == set(map(tuple, np.column_stack(np.nonzero(d <= 1.8))))


def _quadratic():
    A = np.diag([1.0, 10.0, 100.0])
    b = np.array([1.0, -2.0, 3.0])
    return (lambda x: (0.5 * x @ A @ x - b @ x, A @ x - b)), np.zeros(3), \
        {"gtol": 1e-8}, np.linalg.solve(A, b), 1e-7


def _rosenbrock():
    def rosen(x):
        f = 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
        g = np.array([-400 * x[0] * (x[1] - x[0] ** 2) - 2 * (1 - x[0]),
                      200 * (x[1] - x[0] ** 2)])
        return f, g
    kw = dict(lower=np.array([-2.0, -2.0]), upper=np.array([0.5, 2.0]),
              max_iter=5000, gtol=1e-6)
    return rosen, np.array([-1.2, 1.0]), kw, np.array([0.5, 0.25]), 1e-4


@pytest.mark.parametrize("problem", [_quadratic, _rosenbrock])
def test_lbfgsb_matches_jax(problem):
    fg, x0, kw, want, tol = problem()
    x, f, it, conv = native.lbfgsb_minimize(fg, x0, **kw)
    xj, fj, itj, convj = jax_native().lbfgsb_minimize(fg, x0, **kw)
    assert conv and convj and it == itj
    assert np.abs(x - xj).max() <= 1e-12 and abs(f - fj) <= 1e-12
    np.testing.assert_allclose(x, want, atol=tol)


def test_lbfgsb_callback_exception_propagates():
    calls = []

    def fg(x):
        calls.append(x.copy())
        if len(calls) == 3:
            raise ValueError("objective failed")
        return float(x @ x), 2 * x

    with pytest.raises(ValueError, match="objective failed"):
        native.lbfgsb_minimize(fg, np.ones(4), max_iter=50)
    assert len(calls) == 3


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ and an empty build directory that the module uses
    instead of the package's."""
    src, build = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(native.CSRC, src)
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD", build)
    monkeypatch.setattr(native, "_LIBS", {})
    return src


def test_build_keyed_by_source_and_raises_with_log(csrc):
    before = {n: native.target(n).name for n in native.SOURCES}
    assert all(n.startswith(f"lib{k}-") for k, n in before.items())
    src = csrc / "nlp_solver.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: native.target(n).name for n in native.SOURCES}
    assert after["nlp_solver"] != before["nlp_solver"]
    assert after["cell_list"] == before["cell_list"]
    src.write_text(src.read_text() + "\nint broken(\n")
    with pytest.raises(RuntimeError, match="nlp_solver.cpp") as e:
        native.build()
    assert "error" in str(e.value)
    assert not native.target("nlp_solver").exists()
    assert native.target("cell_list").exists()
    # nvcc builds csrc/<name>.cu only: the C++ sources are not its
    for name in native.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cpp").exists()
        assert not (cuda_build.CSRC / f"{name}.cu").exists()
