"""The port's grid scans (``workflows/scan_nd.py``, the ``scan2d`` and
``scan3d`` CLIs) against the JAX package's:

- ``run_scan_nd`` on Morse H3 (both axes move the middle atom) through
  both packages, ``relax_mode`` lbfgs (light) and rfo (heavy, seeded
  with the biased exact Hessian): ``surface.csv`` with the same header
  and grid (its start, the preoptimized distances, within 1e-10
  Angstrom), energies within 1e-8 Hartree;
- the twins of ``tests/test_all_pipeline.py:117`` (``scan2d``) and
  ``:205`` (``scan3d``, its nesting on four atoms and the re-plot from
  the CSV, here through ``--csv``), and of ``tests/test_cli.py:325``
  (``--scan-list`` quadruples: two intervals an axis), each through both
  CLIs with the same output files;
- ``plot_only``; with matplotlib hidden from ``sys.modules``,
  ``surface.csv`` is still written and the figure skipped with a
  warning.
"""

import sys

import numpy as np
import pytest
from click.testing import CliRunner

from pdb2reaction_tpu.cli import cli as jcli
from pdb2reaction_tpu.workflows.scan_nd import run_scan_nd as j_run
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.workflows.scan_nd import run_scan_nd

E_TOL = 1e-8
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H4 = "4\n\nH 0.0 0.0 0.0\nH 0.9 0.0 0.0\nH 1.8 0.0 0.0\nH 2.7 0.0 0.0\n"
AXES = [{"pair": (0, 1), "end": 0.9, "step": 0.15},
        {"pair": (1, 2), "end": 1.6, "step": 0.2}]


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], np.loadtxt(path, delimiter=",", skiprows=1)


def _files(root):
    return sorted(p.name for p in root.iterdir())


@pytest.mark.parametrize("mode", ["lbfgs", "rfo"])
def test_run_scan_nd_matches_jax(tmp_path, mode):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    kw = dict(charge=0, freeze_atoms=[0, 2], calc_mode="morse",
              relax_mode=mode, relax_thresh="baker", preopt=True,
              verbose=False)
    rj = j_run(a, AXES, out_dir=tmp_path / "j", **kw)
    rt = run_scan_nd(a, AXES, out_dir=tmp_path / "t", device="cpu", **kw)
    ht, tt = _csv(tmp_path / "t" / "surface.csv")
    hj, tj = _csv(tmp_path / "j" / "surface.csv")
    assert ht == hj == "d1_ang,d2_ang,energy_au"
    assert tt.shape == tj.shape and tt.shape[0] >= 4
    # the grid starts at the preoptimized distances: equal to 1e-10 A
    assert np.abs(tt[:, :2] - tj[:, :2]).max() <= 1e-10
    assert np.abs(tt[:, 2] - tj[:, 2]).max() <= E_TOL
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert rt["energy_calls"] == tt.shape[0]        # one a grid point
    assert np.isnan(rt["energies"]).sum() == 0


def _both(tmp_path, flags, name):
    r = CliRunner().invoke(jcli, flags + ["--out-dir",
                                          str(tmp_path / f"{name}_j")])
    assert r.exit_code == 0, r.output
    with pytest.raises(SystemExit) as e:
        cli.main(flags + ["--device", "cpu", "--out-dir",
                          str(tmp_path / f"{name}_t")])
    assert e.value.code == 0
    t, j = tmp_path / f"{name}_t", tmp_path / f"{name}_j"
    assert _files(t) == _files(j)
    ht, tt = _csv(t / "surface.csv")
    hj, tj = _csv(j / "surface.csv")
    assert ht == hj and tt.shape == tj.shape
    assert np.abs(tt - tj).max() <= E_TOL
    return t, tt


def test_scan2d_small(tmp_path):
    """The twin of tests/test_all_pipeline.py:117."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    out, table = _both(tmp_path, [
        "scan2d", "-i", str(a), "-q", "0", "--calc-mode", "morse",
        "--freeze-atoms", "0,2", "--scan", "1,2,0.9,0.15",
        "--scan", "2,3,1.6,0.2"], "s2")
    assert (out / "surface_2d.png").exists()
    assert table.shape[1] == 3 and len(table) >= 4


def test_scan3d_small_and_csv_replot(tmp_path):
    """The twin of tests/test_all_pipeline.py:205."""
    a = tmp_path / "A.xyz"
    a.write_text(H4)
    axes = ["--scan", "1,2,0.8,0.1", "--scan", "2,3,0.85,0.1",
            "--scan", "3,4,0.85,0.1"]
    out, table = _both(tmp_path, [
        "scan3d", "-i", str(a), "-q", "0", "--calc-mode", "morse",
        "--freeze-atoms", "0,3", "--preopt", "False"] + axes, "s3")
    assert (out / "surface_3d.png").exists()
    assert table.shape == (8, 4)                    # 2 x 2 x 2
    out2 = tmp_path / "s3b"
    with pytest.raises(SystemExit) as e:
        cli.main(["scan3d", "-i", str(a), "-q", "0", "--calc-mode", "morse",
                  "--device", "cpu", "--csv", str(out / "surface.csv"),
                  "--out-dir", str(out2)] + axes)
    assert e.value.code == 0
    assert _files(out2) == ["surface_3d.png"]


def test_scan2d_scan_list_quadruples(tmp_path):
    """The twin of tests/test_cli.py:325's scan2d: 0.25 Angstrom spans at
    a 0.125 maximum step give two intervals an axis."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    _, table = _both(tmp_path, [
        "scan2d", "-i", str(a), "-q", "0", "--calc-mode", "morse",
        "--freeze-atoms", "0,2", "--one-based", "False",
        "--scan-list", "[(0,1,0.75,1.0),(1,2,1.5,1.75)]",
        "--max-step-size", "0.125", "--preopt", "False",
        "--thresh", "gau_loose", "--opt-mode", "heavy"], "q")
    assert table.shape == (9, 3)


def test_plot_only_and_no_matplotlib(tmp_path, monkeypatch, capsys):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    kw = dict(charge=0, freeze_atoms=[0, 2], calc_mode="morse",
              device="cpu", relax_thresh="gau_loose", verbose=False)
    res = run_scan_nd(a, AXES, out_dir=tmp_path / "s", **kw)
    csv = tmp_path / "s" / "surface.csv"
    again = run_scan_nd(a, AXES, out_dir=tmp_path / "p", plot_only=csv,
                        baseline="first", zmin=0.0, zmax=5.0)
    assert [p.name for p in again["outputs"]] == ["surface_2d.png"]
    np.testing.assert_array_equal(again["surface"], res["surface"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = run_scan_nd(a, AXES, out_dir=tmp_path / "n", **kw)
    assert _files(tmp_path / "n") == ["surface.csv"]
    assert [p.name for p in bare["outputs"]] == ["surface.csv"]
    assert "surface_2d.png skipped" in capsys.readouterr().out
    np.testing.assert_array_equal(_csv(tmp_path / "n" / "surface.csv")[1],
                                  res["surface"])


@pytest.mark.parametrize("flags,said", [
    (["--scan", "1,2,0.9"], "exactly 2 axes"),
    (["--args-yaml", "x.yaml"], "--args-yaml"),
    (["--dump", "True", "--scan", "1,2,0.9", "--scan", "2,3,1.6"],
     "--dump"),
])
def test_scan2d_refusals(tmp_path, flags, said):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli.main(["scan2d", "-i", str(a), "-q", "0", "--calc-mode", "morse",
                  "--device", "cpu", "--out-dir", str(out)] + flags)
    assert said in str(e.value.code)
    assert not out.exists()
