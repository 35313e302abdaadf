"""Port RFO / RS-I-RFO (``engines/rfo.py``) against the JAX package's:

- twins of ``tests/test_rfo.py:21, 36, 89`` (water minimization, the
  double-well TS, GDIIS against plain RFO) on the port. The twin of
  ``test_biased_calculator_shifts_minimum`` (the harmonic bias,
  ``engines/bias.py``) is in ``tests/test_torch_config_bias.py``;
- ``_secular_rfo_step``, ``_bfgs_update`` and ``_bofill_update`` against
  JAX's on seeded inputs, to 1e-12;
- ``rfo_optimize`` against JAX's in min mode (plain, and with the GDIIS
  endgame on a five-atom Morse cluster, free and with two atoms frozen)
  and in TS mode on the double well (with and without exact-Hessian
  refreshes): the same ``converged`` and ``cycles``, coordinates to 1e-7
  Bohr, energies to 1e-9 Hartree. Force calls are the port's own count
  (the JAX device loop counts none): one at the start and one a cycle;
- the GDIIS gate the port adds: on water and on the one-atom double
  well every DIIS system is singular by construction (more gradients
  than the directions they can span), so GDIIS leaves the plain RFO
  run as it is. The JAX package accepts extrapolations there whose
  coefficients are set by rounding;
- the refusals this slice lifts: ``opt --opt-mode heavy``, RFO endpoint
  preoptimization in ``path-opt`` and ``path-search`` with
  ``opt_mode="heavy"``, each on Morse against the JAX workflow (the
  library calls name the mode ``"rfo"``: the JAX workflows take
  ``"heavy"`` there for L-BFGS, as only its CLI maps the alias; the
  port maps it everywhere)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines import rfo as jrfo
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines import rfo
from pdb2reaction_tpu_torch.engines.rfo import rfo_optimize
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator

L = 2.4
X_TOL = 1e-7        # Bohr
E_TOL = 1e-9        # Hartree
CLUSTER = [[0, 0, 0], [1.0, 0.1, 0], [-0.3, 1.0, 0.1], [0.2, -0.4, 1.0],
           [1.1, 0.9, 0.8]]
WATER = [[0.0, 0.0, 0.0], [1.15, 0.12, 0.0], [-0.35, 1.02, 0.05]]


def setup(st, **kw):
    calc = Calculator(st, potentials.make_morse(), device="cpu", **kw)
    return calc, calc.au_energy_force_fn(), calc.pad_bohr(st.coords_bohr)


def _pair(syms, xyz, freeze=()):
    jc = JCalculator(JStructure.from_symbols(syms, xyz, freeze=list(freeze)),
                     jpot.make_morse())
    tc = Calculator(Structure.from_symbols(syms, xyz, freeze=list(freeze)),
                    potentials.make_morse(), device="cpu")
    return jc, tc


def _both(jc, tc, **kw):
    cb = tc.structure.coords_bohr.reshape(-1)
    H0 = tc.get_hessian(cb)["hessian"]
    extra = {}
    if kw.pop("refresh", False):
        extra = {"hessian_recalc": 2}
        jfn = lambda xp: jc.get_hessian(  # noqa: E731
            np.asarray(xp)[: jc.n_atoms].reshape(-1))["hessian"]
        tfn = lambda xp: tc.get_hessian(  # noqa: E731
            tc.unpad(xp).reshape(-1))["hessian"]
    else:
        jfn = tfn = None
    rj = jrfo.rfo_optimize(jc.au_energy_force_fn(), jc.pad_bohr(cb),
                           jc.system.free_mask, jc.n_atoms, hessian0=H0,
                           hessian_fn=jfn, **extra, **kw)
    n0 = tc.force_calls
    rt = rfo_optimize(tc.au_energy_force_fn(), tc.pad_bohr(cb),
                      tc.system.free_mask, tc.n_atoms, hessian0=H0,
                      hessian_fn=tfn, **extra, **kw)
    return rj, rt, tc.force_calls - n0


def _assert_same(rj, rt):
    assert rt.converged == bool(rj.converged)
    assert rt.cycles == int(rj.cycles)
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= X_TOL
    assert abs(rt.e - float(rj.e)) <= E_TOL


# ---- twins of tests/test_rfo.py -----------------------------------------

def test_rfo_minimize_water():
    st = Structure.from_symbols(
        ["O", "H", "H"],
        [[0.0, 0.0, 0.0], [1.1, 0.1, 0.0], [-0.3, 1.05, 0.0]])
    calc, fn, x0 = setup(st)
    H0 = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    res = rfo_optimize(fn, x0, calc.system.free_mask, calc.n_atoms,
                       hessian0=H0, thresh="gau", max_cycles=200)
    assert res.converged
    assert np.abs(res.f.numpy()).max() < 4.5e-4
    assert res.cycles < 60


def test_rfo_ts_mode_double_well():
    st = Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [1.05, 0.0, 0.0], [L, 0, 0]],
        freeze=[0, 2])
    calc, fn, x0 = setup(st)
    H0 = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    res = rfo_optimize(fn, x0, calc.system.free_mask, calc.n_atoms,
                       hessian0=H0, mode="ts", roots=[0], thresh="baker",
                       hessian_update="bofill", max_cycles=300)
    assert res.converged
    x = res.x.numpy()[:3] * BOHR2ANG
    assert x[1, 0] == pytest.approx(L / 2, abs=1e-3)
    calc2 = Calculator(st, potentials.make_morse(), device="cpu",
                       return_partial_hessian=True)
    Hblk = calc2.get_hessian(res.x.numpy()[:3].reshape(-1))["hessian"]
    assert (np.linalg.eigvalsh(Hblk) < -1e-6).sum() == 1


def test_rfo_gdiis_accelerates():
    st = Structure.from_symbols(["O", "H", "H"], WATER)
    calc, fn, x0 = setup(st)
    H0 = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    res_g = rfo_optimize(fn, x0, calc.system.free_mask, calc.n_atoms,
                         hessian0=H0, thresh="gau_tight", max_cycles=400,
                         gdiis=True)
    res_p = rfo_optimize(fn, x0, calc.system.free_mask, calc.n_atoms,
                         hessian0=H0, thresh="gau_tight", max_cycles=400,
                         gdiis=False)
    assert res_g.converged and res_p.converged
    assert res_g.e == pytest.approx(res_p.e, abs=1e-8)
    assert res_g.cycles <= res_p.cycles + 2


# ---- helpers against JAX ----------------------------------------------------

def test_secular_step_and_updates_match_jax():
    rng = np.random.default_rng(0)
    for D, trust in ((6, 0.1), (9, 0.01), (9, 10.0)):
        lam = np.sort(rng.normal(size=D))
        gt = rng.normal(size=D) * 0.3
        sj = np.asarray(jrfo._secular_rfo_step(jnp.asarray(lam),
                                               jnp.asarray(gt), trust))
        st = rfo._secular_rfo_step(torch.as_tensor(lam), torch.as_tensor(gt),
                                   trust).numpy()
        assert np.abs(st - sj).max() <= 1e-12 * max(np.abs(sj).max(), 1)
        A = rng.normal(size=(D, D))
        H = A + A.T
        s, y = rng.normal(size=D), rng.normal(size=D)
        for name in ("_bfgs_update", "_bofill_update"):
            for yy in (y, -y):          # the BFGS update skips sy <= 0
                Hj = np.asarray(getattr(jrfo, name)(
                    jnp.asarray(H), jnp.asarray(s), jnp.asarray(yy)))
                Ht = getattr(rfo, name)(torch.as_tensor(H),
                                        torch.as_tensor(s),
                                        torch.as_tensor(yy)).numpy()
                assert np.abs(Ht - Hj).max() <= 1e-12 * np.abs(Hj).max()


@pytest.mark.parametrize("mode", ["min", "ts"])
def test_rfo_cycle_matches_jax(mode):
    rng = np.random.default_rng(1)
    D = 9
    A = rng.normal(size=(D, D))
    H = A + A.T
    g = rng.normal(size=D) * 0.05
    roots = [0] if mode == "ts" else None
    cj, _ = jrfo.make_rfo_cycle(roots, "bofill", 1e-8)
    ct, _ = rfo.make_rfo_cycle(roots, "bofill", 1e-8)
    sj, pj, _ = cj(jnp.asarray(H), jnp.asarray(g), 0.1)
    st, pt, _ = ct(torch.as_tensor(H), torch.as_tensor(g), 0.1)
    assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-12
    assert abs(float(pt) - float(pj)) <= 1e-12


# ---- rfo_optimize against JAX ---------------------------------------------

def test_rfo_min_water_matches_jax():
    jc, tc = _pair(["O", "H", "H"], WATER)
    rj, rt, calls = _both(jc, tc, thresh="gau_tight", max_cycles=400,
                          gdiis=False)
    _assert_same(rj, rt)
    assert rt.converged and calls == 1 + rt.cycles


@pytest.mark.parametrize("freeze", [(), (0, 4)])
def test_rfo_min_gdiis_matches_jax(freeze, monkeypatch):
    """The GDIIS endgame on a five-atom cluster, whose DIIS systems are
    not singular by construction: the port accepts the extrapolations
    JAX accepts."""
    accepted = []
    orig = rfo._gdiis

    def spy(*a, **kw):
        out = orig(*a, **kw)
        accepted.append(not torch.equal(out, a[5]))
        return out

    monkeypatch.setattr(rfo, "_gdiis", spy)
    jc, tc = _pair(["C", "H", "H", "H", "H"], CLUSTER, freeze)
    rj, rt, calls = _both(jc, tc, thresh="gau_tight", max_cycles=400,
                          gdiis=True)
    _assert_same(rj, rt)
    assert rt.converged and calls == 1 + rt.cycles
    assert sum(accepted) >= 3          # the endgame really ran


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("x1", [[1.05, 0, 0], [0.95, 0.1, -0.05]])
def test_rfo_ts_matches_jax(x1, refresh):
    jc, tc = _pair(["H"] * 3, [[0, 0, 0], x1, [L, 0, 0]], (0, 2))
    n0 = tc.force_calls
    rj, rt, calls = _both(jc, tc, mode="ts", roots=[0], thresh="baker",
                          hessian_update="bofill", max_cycles=300,
                          refresh=refresh)
    _assert_same(rj, rt)
    assert rt.converged
    # one force call a cycle and one at the start; each exact refresh
    # (after cycles 2, 4, ...) adds its get_hessian's one
    refreshes = (rt.cycles - 1) // 2 if refresh else 0
    assert calls == 1 + rt.cycles + refreshes
    assert tc.force_calls - n0 == calls + 1      # + the first Hessian's


@pytest.mark.parametrize("syms,xyz,freeze", [
    (["O", "H", "H"], WATER, ()),
    (["H"] * 3, [[0, 0, 0], [0.9, 0.1, 0.0], [L, 0, 0]], (0, 2)),
])
def test_gdiis_singular_systems_leave_rfo_as_is(syms, xyz, freeze):
    _, tc = _pair(syms, xyz, freeze)
    cb = tc.structure.coords_bohr.reshape(-1)
    H0 = tc.get_hessian(cb)["hessian"]
    runs = [rfo_optimize(tc.au_energy_force_fn(), tc.pad_bohr(cb),
                         tc.system.free_mask, tc.n_atoms, hessian0=H0,
                         thresh="gau_tight", max_cycles=400, gdiis=g)
            for g in (True, False)]
    assert runs[0].cycles == runs[1].cycles
    assert torch.equal(runs[0].x, runs[1].x)


# ---- the lifted refusals against the JAX workflows ------------------------

def _xyz(tmp_path, name, syms, xyz):
    p = tmp_path / f"{name}.xyz"
    io_xyz.write_xyz(p, Structure.from_symbols(syms, xyz))
    return p


def test_opt_heavy_matches_jax(tmp_path):
    from pdb2reaction_tpu.workflows.opt import run_opt as j_run_opt
    from pdb2reaction_tpu_torch.workflows.opt import run_opt
    p = _xyz(tmp_path, "c5", ["C", "H", "H", "H", "H"], CLUSTER)
    kw = dict(charge=0, opt_mode="heavy", calc_mode="morse",
              thresh="gau_tight", verbose=False)
    rj = j_run_opt(p, out_dir=tmp_path / "j", **kw)
    rt = run_opt(p, out_dir=tmp_path / "t", device="cpu", **kw)
    assert rt["converged"] and rt["converged"] == rj["converged"]
    assert rt["cycles"] == rj["cycles"]
    assert abs(rt["energy"] - rj["energy"]) <= E_TOL
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= X_TOL
    # the start, one a cycle and the exact Hessian's one
    assert rt["force_calls"] == rt["cycles"] + 2
    assert (tmp_path / "t" / "final_geometry.xyz").exists()


def test_path_opt_rfo_preopt_matches_jax(tmp_path):
    from pdb2reaction_tpu.workflows.path_opt import run_path_opt as j_run
    from pdb2reaction_tpu_torch.workflows.path_opt import run_path_opt
    a = _xyz(tmp_path, "A", ["H"] * 3, [[0, 0, 0], [0.9, 0.1, 0], [L, 0, 0]])
    b = _xyz(tmp_path, "B", ["H"] * 3,
             [[0, 0, 0], [L - 0.9, -0.1, 0], [L, 0, 0]])
    kw = dict(charge=0, freeze_atoms=[0, 2], preopt=True,
              preopt_mode="rfo", calc_mode="morse",
              gs_kw={"max_nodes": 5}, stopt_kw={"max_cycles": 30},
              verbose=False)
    rj = j_run([a, b], out_dir=tmp_path / "j", **kw)
    rt = run_path_opt([a, b], out_dir=tmp_path / "t", device="cpu", **kw)
    assert rt["converged"] == rj["converged"]
    assert rt["hei_idx"] == rj["hei_idx"]
    assert np.abs(rt["energies"] - rj["energies"]).max() <= E_TOL
    for s_t, s_j in zip(rt["structures"], rj["structures"]):
        assert np.abs(s_t.coords - s_j.coords).max() <= X_TOL * BOHR2ANG
    assert rt["calculator"].force_calls > rt["mep_force_calls"]


def test_path_search_heavy_matches_jax(tmp_path, monkeypatch):
    """The refinements start on the barrier's slopes and reach the DIIS
    endgame, where the one free atom's DIIS systems are singular (JAX
    takes 11 cycles there, plain RFO and the port 8): both packages run
    RFO without GDIIS here, which the tests above hold apart."""
    import functools
    from pdb2reaction_tpu.workflows import opt as j_opt
    from pdb2reaction_tpu.workflows.path_search import \
        run_path_search as j_run
    from pdb2reaction_tpu_torch.workflows import opt as t_opt
    from pdb2reaction_tpu_torch.workflows.path_search import \
        run_path_search
    for mod in (j_opt, t_opt):
        monkeypatch.setattr(mod, "rfo_optimize", functools.partial(
            mod.rfo_optimize, gdiis=False))
    a = _xyz(tmp_path, "A", ["H"] * 3,
             [[0, 0, 0], [0.686, 0, 0], [L, 0, 0]])
    b = _xyz(tmp_path, "B", ["H"] * 3,
             [[0, 0, 0], [1.714, 0, 0], [L, 0, 0]])
    kw = dict(charge=0, freeze_atoms=[0, 2], calc_mode="morse",
              gs_kw={"max_nodes": 7}, search_kw={"opt_mode": "rfo"},
              verbose=False)
    rj = j_run([a, b], out_dir=tmp_path / "j", **kw)
    rt = run_path_search([a, b], out_dir=tmp_path / "t", device="cpu", **kw)
    sj, st = rj["segments"], rt["segments"]
    assert [s.kind for s in st] == [s.kind for s in sj]
    assert [s.is_reactive for s in st] == [s.is_reactive for s in sj]
    assert [s.hei_idx for s in st] == [s.hei_idx for s in sj]
    assert np.abs(np.subtract(rt["mep_energies"],
                              rj["mep_energies"])).max() <= 1e-8
    assert (tmp_path / "t" / "summary.yaml").exists()


def test_dofmap_matches_jax():
    from pdb2reaction_tpu.engines.dof import DofMap as JDofMap
    from pdb2reaction_tpu_torch.engines.dof import DofMap
    rng = np.random.default_rng(5)
    fm = np.array([1, 0, 1, 1, 0, 1, 0, 0], float)      # 6 atoms, P = 8
    jd, td = JDofMap(fm, 6), DofMap(torch.as_tensor(fm), 6)
    assert td.n_free == jd.n_free == 12
    x = rng.normal(size=(8, 3))
    v = td.gather(torch.as_tensor(x))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jd.gather(x)))
    base = rng.normal(size=(8, 3))
    np.testing.assert_array_equal(
        td.scatter(v * 2, torch.as_tensor(base)).numpy(),
        np.asarray(jd.scatter(jnp.asarray(v.numpy() * 2), jnp.asarray(base))))
    H = rng.normal(size=(18, 18))
    np.testing.assert_array_equal(td.compact_hessian(H),
                                  jd.compact_hessian(H))
    np.testing.assert_array_equal(td.expand_vector(v), jd.expand_vector(v))
