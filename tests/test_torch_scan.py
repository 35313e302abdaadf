"""The port's staged scan (``workflows/scan.py``, the ``scan`` CLI)
against the JAX package's:

- ``linear_schedule`` and ``grid_values`` equal to JAX's, bit for bit, on
  hypothesis-drawn (d0, target, step), and the ceil case of
  ``tests/test_cli.py:367``;
- ``run_scan`` against JAX's ``run_scan`` on the Morse H3 of
  ``tests/test_cli.py:119`` (pair (1, 2) driven to 0.75 Angstrom, preopt
  and endopt on) and on a two-stage, two-pair scan of a seven-atom
  escn-test molecule in float64 with the weights of
  ``test_torch_calculator._pair``: stage energies within 1e-8 Hartree
  and frames within 1e-6 Bohr (the L-BFGS bar of
  ``tests/test_torch_opt.py``), the same bond-change reports and output
  files. Force calls are not compared: the JAX Cartesian L-BFGS counts
  ``cycles + 1`` a relaxation, the port every evaluation;
- a rerun in the same ``out_dir`` resumes every stage from its
  checkpoint with no force call and the same coordinates;
- ``--one-based False``, ``--dump`` writing a ``scan.trj`` that
  ``trj2fig`` reads (the twin of ``tests/test_cli.py:139``), and the
  ``scan`` CLI through both packages (the twin of
  ``tests/test_cli.py:119``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from hypothesis import given, settings
from hypothesis import strategies as hs

from pdb2reaction_tpu.cli import cli as jcli
from pdb2reaction_tpu.workflows import common as j_common
from pdb2reaction_tpu.workflows.scan import linear_schedule as j_sched
from pdb2reaction_tpu.workflows.scan import run_scan as j_run_scan
from pdb2reaction_tpu.workflows.scan_nd import grid_values as j_grid
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.workflows import common as t_common
from pdb2reaction_tpu_torch.workflows.scan import linear_schedule, run_scan
from pdb2reaction_tpu_torch.workflows.scan_nd import grid_values

E_TOL, X_TOL = 1e-8, 1e-6
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
MORSE = dict(charge=0, freeze_atoms=[0, 2], calc_mode="morse",
             verbose=False)

_d = hs.floats(0.5, 4.0, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(d0=_d, target=_d, step=hs.one_of(hs.just(0.0),
                                       hs.floats(0.02, 0.5)))
def test_schedules_equal_jax(d0, target, step):
    assert linear_schedule(d0, target, step) == j_sched(d0, target, step)
    spec = {"end": target, "step": step}
    np.testing.assert_array_equal(grid_values(d0, spec), j_grid(d0, spec))
    spec = {"start": target, "end": d0, "step": step}
    np.testing.assert_array_equal(grid_values(0.0, spec), j_grid(0.0, spec))


def test_grid_values_step_is_a_maximum():
    """The twin of tests/test_cli.py:367."""
    v = grid_values(1.0, {"end": 1.149, "step": 0.1})
    assert len(v) == 3
    assert np.max(np.abs(np.diff(v))) <= 0.1 + 1e-12
    assert len(grid_values(1.0, {"end": 1.5, "step": 0.125})) == 5
    assert len(grid_values(1.0, {"end": 1.0, "step": 0.1})) == 1
    np.testing.assert_array_equal(grid_values(0.0, {"values": [1, 2.5]}),
                                  [1.0, 2.5])


def _names(paths, root):
    return sorted(str(Path(p).relative_to(root)) for p in paths)


def _same_scan(rt, rj, tdir, jdir):
    assert _names(rt["outputs"], tdir) == _names(rj["outputs"], jdir)
    assert rt["stage_reports"] == rj["stage_reports"]
    assert len(rt["stages"]) == len(rj["stages"])
    for st, sj in zip(rt["stages"], rj["stages"]):
        assert len(st["frames_bohr"]) == len(sj["frames_bohr"])
        assert np.abs(np.subtract(st["energies"], sj["energies"])).max() \
            <= E_TOL
        for a, b in zip(st["frames_bohr"], sj["frames_bohr"]):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= X_TOL
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= X_TOL


def test_run_scan_morse_matches_jax(tmp_path):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    kw = dict(preopt=True, endopt=True, dump=True, **MORSE)
    rj = j_run_scan(a, [[(1, 2, 0.75)]], out_dir=tmp_path / "j", **kw)
    rt = run_scan(a, [[(1, 2, 0.75)]], out_dir=tmp_path / "t", device="cpu",
                  **kw)
    _same_scan(rt, rj, tmp_path / "t", tmp_path / "j")
    assert "bonds formed" in rt["stage_reports"][0]
    assert "bonds broken" in rt["stage_reports"][0]
    assert len(rt["stages"][0]["frames_bohr"]) == 11      # 10 steps + endopt


@pytest.fixture(scope="module")
def escn_scan(tmp_path_factory):
    """Both packages' factories returning escn-test over the same weights
    (float64), and the seven-atom molecule of ``_pair`` as an .xyz."""
    from test_torch_calculator import _pair
    jcalc, tcalc, cb = _pair(seed=4, n=7)
    jp, jfn, tp = jcalc.params, jcalc.energy_fn, tcalc.params
    from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
    from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

    def jmake(struct, freeze_atoms=(), **kw):
        return JCalculator(struct, jfn, params=jp,
                           freeze_atoms=list(freeze_atoms))

    def tmake(struct, freeze_atoms=(), device="cuda", **kw):
        return make_uma_calculator(struct, model="escn-test",
                                   freeze_atoms=list(freeze_atoms),
                                   device="cpu", dtype=torch.float64,
                                   params=tp, weights_source="from_jax")

    path = tmp_path_factory.mktemp("escn_scan") / "m.xyz"
    io_xyz.write_xyz(path, tcalc.structure)
    return path, jmake, tmake, io_xyz.read_xyz(path).coords_bohr


def test_run_scan_escn_two_stages_matches_jax(monkeypatch, escn_scan,
                                              tmp_path):
    path, jmake, tmake, xb = escn_scan
    monkeypatch.setattr(j_common, "make_calculator", jmake)
    monkeypatch.setattr(t_common, "make_calculator", tmake)
    ang = io_xyz.read_xyz(path).coords

    def d(i, j):
        return float(np.linalg.norm(ang[i] - ang[j]))

    stages = [[(0, 1, d(0, 1) + 0.15)],
              [(0, 1, d(0, 1) + 0.25), (2, 3, d(2, 3) - 0.2)]]
    kw = dict(charge=0, freeze_atoms=[5, 6], relax_max_cycles=8,
              verbose=False)
    rj = j_run_scan(path, stages, out_dir=tmp_path / "j", **kw)
    rt = run_scan(path, stages, out_dir=tmp_path / "t", **kw)
    assert rt["calculator"].weights_source == "from_jax"
    _same_scan(rt, rj, tmp_path / "t", tmp_path / "j")
    assert [len(s["frames_bohr"]) for s in rt["stages"]] == [2, 2]
    np.testing.assert_array_equal(rt["coords_bohr"][5:], xb[5:])  # frozen
    assert rt["force_calls"] > 0 and rt["energy_calls"] == 0

    # a rerun resumes both stages: no force call, the same result
    again = run_scan(path, stages, out_dir=tmp_path / "t", **kw)
    assert again["force_calls"] == 0
    np.testing.assert_array_equal(again["coords_bohr"], rt["coords_bohr"])
    assert again["stage_reports"] == rt["stage_reports"]


def _cli(args):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    return e.value.code


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if "checkpoint" not in p.parts)


def test_cli_scan_bond_change_both_packages(tmp_path, capsys):
    """The twin of tests/test_cli.py:119, through both CLIs: the same
    tree, final geometry within 1e-6 Bohr."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    flags = ["scan", "-i", str(a), "--scan-list", "2,3,0.75", "-q", "0",
             "--calc-mode", "morse", "--freeze-atoms", "0,2"]
    r = CliRunner().invoke(jcli, flags + ["--out-dir", str(tmp_path / "j")])
    assert r.exit_code == 0, r.output
    assert _cli(flags + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert "bonds formed" in out and "bonds broken" in out
    assert (tmp_path / "t" / "stage_01.trj").exists()
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    xt = io_xyz.read_xyz(tmp_path / "t" / "final_geometry.xyz").coords
    xj = io_xyz.read_xyz(tmp_path / "j" / "final_geometry.xyz").coords
    assert np.abs(xt - xj).max() <= X_TOL


def test_cli_zero_based_and_dump_then_trj2fig(tmp_path):
    """The twin of tests/test_cli.py:139: --one-based False, --dump
    writing scan.trj, trj2fig reading it (-o png/html/csv)."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    base = ["scan", "-i", str(a), "-q", "0", "--multiplicity", "1",
            "--calc-mode", "morse", "--device", "cpu"]
    assert _cli(base + ["--scan-list", "1,2,0.75", "--one-based", "False",
                        "--dump", "True", "--out-dir",
                        str(tmp_path / "s0")]) == 0
    assert _cli(base + ["--scan-list", "2,3,0.75", "--dump", "True",
                        "--out-dir", str(tmp_path / "s1")]) == 0
    t0 = io_xyz.read_xyz_frames(tmp_path / "s0" / "scan.trj")
    t1 = io_xyz.read_xyz_frames(tmp_path / "s1" / "scan.trj")
    assert len(t0) == len(t1) >= 2
    for x, y in zip(t0, t1):
        np.testing.assert_array_equal(x.coords, y.coords)
    outs = [tmp_path / f"prof.{s}" for s in ("svg", "html", "csv")]
    assert _cli(["trj2fig", "-i", str(tmp_path / "s0" / "scan.trj")]
                + sum((["-o", str(o)] for o in outs), [])
                + ["--reverse-x", "True", "-q", "0", "--calc-mode", "morse",
                   "--recompute", "True", "--device", "cpu"]) == 0
    assert outs[0].exists()
    assert outs[1].exists() and outs[1].stat().st_size > 100
    assert "energy_au" in outs[2].read_text().splitlines()[0]


@pytest.mark.parametrize("flags,said", [
    (["--spatial", "2"], "torchrun --nproc-per-node 2"),
    (["--workers", "2"], "torchrun --nproc-per-node 2"),
])
def test_scan_refusals(tmp_path, flags, said):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli.main(["scan", "-i", str(a), "--scan-list", "2,3,0.75", "-q", "0",
                  "--calc-mode", "morse", "--device", "cpu", "--out-dir",
                  str(out)] + flags)
    assert said in str(e.value.code)
    assert not out.exists()
