"""Port L-BFGS (host loop) against the JAX device-loop L-BFGS, cycle by
cycle, on escn-test in f64 with the same weights; and the ``opt`` CLI."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from pdb2reaction_tpu.engines.lbfgs import lbfgs_minimize as j_lbfgs
from pdb2reaction_tpu_torch.engines.lbfgs import lbfgs_minimize

from test_torch_calculator import _pair

REPO = Path(__file__).resolve().parents[1]


def test_lbfgs_ten_cycles_match_jax():
    jcalc, tcalc, cb = _pair(freeze=[2], seed=11, n=6)
    e_j, e_t = [], []
    rj = j_lbfgs(jcalc.au_energy_force_fn(), jcalc.pad_bohr(cb),
                 jcalc.system.free_mask, thresh="gau", max_cycles=10,
                 chunk=1, callback=lambda c, e, f: e_j.append(e))
    rt = lbfgs_minimize(tcalc.au_energy_force_fn(), tcalc.pad_bohr(cb),
                        tcalc.system.free_mask, thresh="gau", max_cycles=10,
                        callback=lambda c, e, f: e_t.append(e))
    assert int(rj.cycles) == rt.cycles == len(e_t) == len(e_j)
    assert rt.cycles == 10 and not rt.converged
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tcalc.unpad(rt.x), jcalc.unpad(rj.x),
                               rtol=0, atol=1e-6)
    assert e_t[-1] < e_t[0]
    # every evaluation is counted: one at the start, >= one per cycle
    assert tcalc.force_calls >= 11
    x = tcalc.unpad(rt.x)
    np.testing.assert_array_equal(x[2], cb.reshape(-1, 3)[2])   # frozen


def test_opt_cli_writes_final_geometry(tmp_path):
    xyz = tmp_path / "x.xyz"
    xyz.write_text("4\n\nO 0.0 0.0 0.0\nH 0.97 0.05 0.0\nH -0.2 0.95 0.0\n"
                   "C 0.3 -0.4 1.4\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "opt", "-i",
         str(xyz), "--model", "escn-test", "--device", "cpu",
         "--max-cycles", "3", "-q", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode in (0, 3), r.stderr
    out = tmp_path / "result_opt" / "final_geometry.xyz"
    assert out.exists()
    lines = out.read_text().splitlines()
    assert lines[0] == "4" and len(lines) == 6
    assert np.isfinite(float(lines[1]))            # energy in Hartree
    assert "[opt]" in r.stdout


def test_opt_cli_morse_potential(tmp_path):
    """``--calc-mode morse`` runs ``opt`` on the analytic potential (no
    weights), to convergence, and takes ``--hessian-calc-mode``."""
    xyz = tmp_path / "h3.xyz"
    xyz.write_text("3\n\nH 0.0 0.0 0.0\nH 0.9 0.1 0.0\nH 2.4 0.0 0.0\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "opt", "-i",
         str(xyz), "--calc-mode", "morse", "--device", "cpu", "-q", "0",
         "--freeze-atoms", "0,2", "--hessian-calc-mode",
         "FiniteDifference"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[opt] converged" in r.stdout
    out = (tmp_path / "result_opt" / "final_geometry.xyz").read_text()
    lines = out.splitlines()
    assert lines[0] == "3" and float(lines[1]) < 0.0
    # the frozen atoms stay where they were
    assert lines[2].split()[1:] == ["0.000000000000000"] * 3
