"""The port's L-BFGS restart (``engines/lbfgs.py`` ``restart=``) and
``opt --dump`` / ``--dump-restart`` against the JAX package's:

- the twin of ``tests/test_restart.py:50``: a run killed after its first
  dump (the store's ``save`` raising, as a kill between dumps leaves the
  disk) resumes from that dump, not from cycle 0, and lands on the
  uninterrupted result (1e-8 Bohr) with the same cycle count, JAX's
  uninterrupted result within 1e-8 Bohr too; a different x0 ignores the
  dump (the stale-dump guard);
- the dump's content key equals the JAX package's on the same x0 and
  settings (``runtime/checkpoint.content_key``);
- ``opt --dump True --dump-restart N`` through both CLIs: the same files
  (``final_geometry.xyz``, ``opt.trj`` with the start and end frames,
  ``restart/opt.{json,npz}``), geometries within 1e-8 Bohr; a second run
  in the same directory resumes the finished dump with no force call.
"""

import json

import numpy as np
import pytest
from click.testing import CliRunner

from pdb2reaction_tpu.cli import cli as jcli
from pdb2reaction_tpu.engines.lbfgs import lbfgs_minimize as j_lbfgs
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines.lbfgs import lbfgs_minimize
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.runtime.checkpoint import CheckpointStore
from pdb2reaction_tpu_torch.workflows.opt import run_opt

X_TOL = 1e-8            # Bohr
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"


class _KillAfter:
    """CheckpointStore.save raising after n dumps."""

    def __init__(self, store, n):
        self.store, self.left = store, n

    def __getattr__(self, k):
        return getattr(self.store, k)

    def save(self, *a, **kw):
        self.store.save(*a, **kw)
        self.left -= 1
        if self.left <= 0:
            raise KeyboardInterrupt("simulated kill after dump")


def _h3(x1):
    return Structure.from_symbols(["H"] * 3, [[0, 0, 0], [x1, 0, 0],
                                              [2.4, 0, 0]], freeze=[0, 2])


def test_lbfgs_restart_resumes_from_dump(tmp_path):
    st = _h3(1.3)
    calc = Calculator(st, potentials.make_morse(), device="cpu")
    fn = calc.au_energy_force_fn()
    x0 = calc.pad_bohr(st.coords_bohr)
    fm = calc.system.free_mask
    kw = dict(thresh="gau_vtight", max_cycles=400)

    ref = lbfgs_minimize(fn, x0, fm, **kw)
    assert ref.converged
    total = ref.cycles
    assert total > 6, "the test needs a run of several dumps"
    jcalc = JCalculator(st, jpot.make_morse())
    jref = j_lbfgs(jcalc.au_energy_force_fn(), jcalc.pad_bohr(st.coords_bohr),
                   jcalc.system.free_mask, **kw)
    assert int(jref.cycles) == total
    assert np.abs(calc.unpad(ref.x) - jcalc.unpad(jref.x)).max() <= X_TOL

    every = 3
    store = CheckpointStore(tmp_path / "rst")
    with pytest.raises(KeyboardInterrupt):
        lbfgs_minimize(fn, x0, fm, restart={
            "store": _KillAfter(store, 1), "name": "opt", "every": every},
            **kw)
    rec = store.load("opt")
    assert rec is not None and not rec[0]["done"]
    assert int(rec[1]["cycle"]) == every

    calls0 = calc.force_calls
    cycles = []
    res = lbfgs_minimize(fn, x0, fm, restart={
        "store": store, "name": "opt", "every": every},
        callback=lambda c, e, f: cycles.append(c), **kw)
    assert cycles[0] == every + 1, cycles         # resumed, not cycle 1
    assert res.converged and res.cycles == total
    assert np.abs(res.x.numpy() - ref.x.numpy()).max() <= X_TOL
    assert store.load("opt")[0]["done"]
    assert calc.force_calls - calls0 < ref.cycles + 1

    # stale-dump guard: x0 left of the barrier must land in the left well
    st2 = _h3(1.1)
    res2 = lbfgs_minimize(fn, calc.pad_bohr(st2.coords_bohr), fm, restart={
        "store": store, "name": "opt", "every": every}, **kw)
    assert res2.converged
    assert float(res2.x[1, 0]) * BOHR2ANG == pytest.approx(0.7046, abs=1e-2)


def test_dump_key_matches_jax(tmp_path):
    """The dump of the same run is keyed as the JAX package's."""
    st = _h3(1.3)
    calc = Calculator(st, potentials.make_morse(), device="cpu")
    jcalc = JCalculator(st, jpot.make_morse())
    from pdb2reaction_tpu.runtime.checkpoint import \
        CheckpointStore as JStore
    kw = dict(thresh="gau", max_cycles=4)
    lbfgs_minimize(calc.au_energy_force_fn(), calc.pad_bohr(st.coords_bohr),
                   calc.system.free_mask, restart={
                       "store": CheckpointStore(tmp_path / "t"),
                       "name": "opt", "every": 2}, **kw)
    j_lbfgs(jcalc.au_energy_force_fn(), jcalc.pad_bohr(st.coords_bohr),
            jcalc.system.free_mask, restart={
                "store": JStore(tmp_path / "j"), "name": "opt",
                "every": 2}, **kw)
    mt = json.loads((tmp_path / "t" / "opt.json").read_text())
    mj = json.loads((tmp_path / "j" / "opt.json").read_text())
    assert mt["key"] == mj["key"] and mt["done"] == mj["done"]


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_opt_dump_and_restart_match_jax_cli(tmp_path):
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    flags = ["opt", "-i", str(a), "-q", "0", "--calc-mode", "morse",
             "--freeze-atoms", "0,2", "--dump", "True", "--dump-restart", "2",
             "--thresh", "gau_tight"]
    r = CliRunner().invoke(jcli, flags + ["--out-dir", str(tmp_path / "j")])
    assert r.exit_code == 0, r.output
    with pytest.raises(SystemExit) as e:
        cli.main(flags + ["--device", "cpu", "--out-dir",
                          str(tmp_path / "t")])
    assert e.value.code == 0
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j") == [
        "final_geometry.xyz", "opt.trj", "restart", "restart/opt.json",
        "restart/opt.npz"]
    ft = io_xyz.read_xyz_frames(tmp_path / "t" / "opt.trj")
    fj = io_xyz.read_xyz_frames(tmp_path / "j" / "opt.trj")
    assert len(ft) == len(fj) == 2
    for x, y in zip(ft, fj):
        assert np.abs(x.coords_bohr - y.coords_bohr).max() <= X_TOL
    # the rerun resumes the finished dump: no force call
    res = run_opt(a, charge=0, calc_mode="morse", freeze_atoms=[0, 2],
                  device="cpu", thresh="gau_tight", dump_restart=2,
                  out_dir=tmp_path / "t", verbose=False)
    assert res["force_calls"] == 0 and res["converged"]
    assert np.abs(res["coords_bohr"] - ft[-1].coords_bohr).max() <= 1e-9
