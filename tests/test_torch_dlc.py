"""Port DLC engine (``engines/dlc.py``) and its workflows against the JAX
package's, in float64 on numpy-seeded inputs:

- ``build_primitives``: the index arrays equal to JAX's on the zigzag
  chain, the two-fragment join and a 64-atom cluster (chip_smoke.py's
  generator); the primitive values and B (``torch.func.jacrev``) to
  1e-12, ``wrap_dq`` to 1e-15;
- the step functions on JAX's own U (eigenvector signs and rotations
  inside degenerate eigenspaces are LAPACK's choice, so each package's
  U is its own): the gradient transform, the back-transformation and
  the q-space Hessian projection to 1e-10, unconstrained and with frozen
  atoms;
- twins of ``tests/test_dlc.py`` (a torch twin of its valence force
  field); the frozen-atom, Morse and workflow minimizations also run
  through the JAX engine and held to its converged energy and geometry;
- the escn-test calculator with the JAX weights carried across
  (``params_from_jax``) through ``dlc_lbfgs_minimize`` in both packages:
  energies within 1e-8 Hartree;
- ``opt --coord-type dlc`` and ``tsopt --opt-mode heavy --coord-type
  dlc`` through ``run_opt`` / ``run_tsopt`` against the JAX workflows.

Force calls are not compared with JAX's: the JAX engines count
``cycles + 1`` whatever they evaluated, the port every evaluation."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines import dlc as jd
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.workflows.opt import run_opt as j_run_opt
from pdb2reaction_tpu.workflows.tsopt import run_tsopt as j_run_tsopt
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines import dlc as td
from pdb2reaction_tpu_torch.engines.lbfgs import lbfgs_minimize
from pdb2reaction_tpu_torch.engines.rfo import rfo_optimize
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.workflows.opt import run_opt
from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt

from test_torch_calculator import _pair

REPO = Path(__file__).resolve().parents[1]
L = 2.4


def _zigzag(n=21, bond=1.5):
    coords = np.zeros((n, 3))
    for i in range(1, n):
        ang = 0.6 if i % 2 else -0.6
        coords[i] = coords[i - 1] + bond * np.array(
            [np.cos(ang), np.sin(ang), 0.0])
    return coords


def _cluster64():
    spec = importlib.util.spec_from_file_location("chip_smoke_dlc",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cluster(64, seed=1)


def _systems():
    zz = _zigzag(8)
    frag = np.vstack([_zigzag(4), _zigzag(4) + np.array([0, 6.0, 0])])
    zs, xyz = _cluster64()
    return {"zigzag": (np.full(8, 6), zz), "fragments": (np.full(8, 6), frag),
            "cluster64": (zs, xyz)}


@pytest.mark.parametrize("name", ["zigzag", "fragments", "cluster64"])
def test_primitives_values_and_B_match_jax(name):
    zs, xyz = _systems()[name]
    pt, pj = td.build_primitives(zs, xyz), jd.build_primitives(zs, xyz)
    for a, b in zip(pt, pj):
        assert a.dtype.kind == "i" and np.array_equal(a, b)
    if name == "zigzag":
        assert [len(p) for p in pt] == [7, 6, 5]
    if name == "fragments":
        assert sum((i < 4) != (j < 4) for i, j in pt[0]) == 1
    n = len(zs)
    ft, _ = td.make_prim_fn(*pt, n)
    fj, _ = jd.make_prim_fn(*pj, n)
    rng = np.random.default_rng(3)
    x = (xyz / BOHR2ANG + 0.05 * rng.normal(size=xyz.shape)).reshape(-1)
    qt = ft(torch.as_tensor(x))
    assert np.abs(qt.numpy() - np.asarray(fj(jnp.asarray(x)))).max() <= 1e-12
    Bt = torch.func.jacrev(ft)(torch.as_tensor(x)).numpy()
    Bj = np.asarray(jax.jacrev(fj)(jnp.asarray(x)))
    assert Bt.shape == Bj.shape == (sum(map(len, pt)), 3 * n)
    assert np.abs(Bt - Bj).max() <= 1e-12


def test_wrap_dq_matches_jax():
    rng = np.random.default_rng(4)
    dq = np.concatenate([rng.normal(size=5), [np.pi, -np.pi, 3 * np.pi,
                                              -2.5 * np.pi, 0.0, 7.0, -7.0],
                         rng.normal(scale=6.0, size=20)])
    wt = td.wrap_dq(torch.as_tensor(dq), 2, 3).numpy()
    wj = np.asarray(jd.wrap_dq(jnp.asarray(dq), 2, 3))
    assert np.abs(wt - wj).max() <= 1e-15
    assert np.array_equal(wt[:5], dq[:5])
    assert np.all(wt[5:] >= -np.pi) and np.all(wt[5:] < np.pi)


def _jax_steps(numbers, x0, n, freeze):
    """The JAX engine's step functions (``dlc.py`` ``grad_s``,
    ``backtransform``, ``to_q``) on its own U, written out from its
    pieces: the JAX engine keeps them inside its compiled loop."""
    bonds, angles, dihedrals = jd.build_primitives(
        numbers, x0.reshape(n, 3) * BOHR2ANG)
    prim_fn, (nb, na, _) = jd.make_prim_fn(bonds, angles, dihedrals, n)
    free = np.ones(3 * n, bool)
    for a in freeze:
        free[3 * a:3 * a + 3] = False
    fi = jnp.asarray(np.nonzero(free)[0])
    B0 = jax.jacrev(prim_fn)(jnp.asarray(x0))[:, fi]
    w, V = jnp.linalg.eigh(B0 @ B0.T)
    U = V[:, np.nonzero(np.asarray(w) > 1e-6)[0]]

    def bs(x):
        Bs = U.T @ jax.jacrev(prim_fn)(x)[:, fi]
        return Bs, Bs @ Bs.T

    def grad_s(x, f):
        Bs, Gs = bs(x)
        return jnp.linalg.solve(Gs, Bs @ (-f[fi]))

    def backtransform(x, rem):
        for _ in range(10):
            Bs, Gs = bs(x)
            x_new = x.at[fi].add(Bs.T @ jnp.linalg.solve(Gs, rem))
            rem = rem - U.T @ jd.wrap_dq(prim_fn(x_new) - prim_fn(x), nb, na)
            x = x_new
        return x

    def to_q(x, H):
        Bs, Gs = bs(x)
        Bi = jnp.linalg.solve(Gs, Bs)
        return Bi @ H @ Bi.T

    return np.asarray(U), grad_s, backtransform, to_q


@pytest.mark.parametrize("freeze", [(), (0, 11)])
def test_step_functions_on_jax_U(freeze):
    st, _ = _vff_setup(n=12, seed=9)
    n = st.n_atoms
    x0 = st.coords_bohr.reshape(-1)
    U, grad_s, backtransform, to_q = _jax_steps(st.numbers, x0, n, freeze)
    sp = td.DlcSpace(st.numbers, torch.as_tensor(x0), n, freeze)
    assert sp.n_dlc == U.shape[1] and sp.n_free == 3 * (n - len(freeze))
    sp.U = torch.as_tensor(U.copy())
    rng = np.random.default_rng(5)
    x = x0 + 0.03 * rng.normal(size=x0.shape)
    f = rng.normal(scale=0.02, size=x0.shape)
    ds = rng.normal(scale=0.05, size=U.shape[1])
    A = rng.normal(size=(sp.n_free, sp.n_free))
    H = A + A.T
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    assert np.abs(sp.grad_q(xt, torch.as_tensor(f)).numpy()
                  - np.asarray(grad_s(xj, jnp.asarray(f)))).max() <= 1e-10
    xb = sp.backtransform(xt, torch.as_tensor(ds)).numpy()
    assert np.abs(xb - np.asarray(backtransform(xj, jnp.asarray(ds)))
                  ).max() <= 1e-10
    if freeze:
        assert np.array_equal(xb.reshape(n, 3)[list(freeze)],
                              x.reshape(n, 3)[list(freeze)])
    assert np.abs(sp.to_q(xt, torch.as_tensor(H)).numpy()
                  - np.asarray(to_q(xj, jnp.asarray(H)))).max() <= 1e-10


# ---------------------------------------------------------------------------
# twins of tests/test_dlc.py
# ---------------------------------------------------------------------------

def _vff_setup(n=21, seed=5):
    """Valence force field (stiff bonds, soft dihedrals) around the zigzag
    equilibrium, on the port's primitives; the perturbed start."""
    rng = np.random.default_rng(seed)
    coords = _zigzag(n)
    st0 = Structure.from_symbols(["C"] * n, coords)
    prims = td.build_primitives(st0.numbers, coords)
    prim_fn, (nb, na, _) = td.make_prim_fn(*prims, n)
    q_eq = prim_fn(torch.as_tensor(st0.coords_bohr.reshape(-1)))

    def vff_energy(coords_ang, system, params):
        q = prim_fn((coords_ang[:n] / BOHR2ANG).reshape(-1))
        d = q - q_eq.to(q.device)
        dd = torch.remainder(d[nb + na:] + torch.pi, 2 * torch.pi) \
            - torch.pi
        return (20.0 * (d[:nb] ** 2).sum() + (d[nb:nb + na] ** 2).sum()
                + 0.02 * (1 - torch.cos(dd)).sum())

    pert = coords + rng.normal(scale=0.25, size=coords.shape)
    return Structure.from_symbols(["C"] * n, pert), vff_energy


def _jax_vff(n, seed, freeze=()):
    """The JAX test's valence force field and start (tests/test_dlc.py
    ``_vff_setup``)."""
    from test_dlc import _vff_setup as j_vff_setup
    st, vff = j_vff_setup(n=n, seed=seed)
    st.freeze = list(freeze)
    return JCalculator(st, vff), st


def test_port_dlc_beats_cartesian_on_21_atoms():
    st, vff = _vff_setup()
    calc = Calculator(st, vff, device="cpu")
    x0 = calc.pad_bohr(st.coords_bohr)
    res_c = lbfgs_minimize(calc.au_energy_force_fn(), x0,
                           calc.system.free_mask, thresh="gau",
                           max_cycles=5000)
    n0 = calc.force_calls
    res_d = td.dlc_lbfgs_minimize(calc.au_energy_force_fn(), x0, st.numbers,
                                  calc.n_atoms, thresh="gau",
                                  max_cycles=5000)
    assert res_c.converged and res_d.converged
    assert res_d.e < res_c.e + 1e-3
    assert res_d.cycles < res_c.cycles * 0.6, (res_d.cycles, res_c.cycles)
    # the port counts every evaluation: the start and one a cycle
    assert calc.force_calls - n0 == res_d.cycles + 1


def test_port_dlc_frozen_atoms_constrained():
    st, vff = _vff_setup(n=12, seed=9)
    st.freeze = [0, 11]
    calc = Calculator(st, vff, device="cpu")
    x0 = calc.pad_bohr(st.coords_bohr)
    fn = calc.au_energy_force_fn()
    res = td.dlc_lbfgs_minimize(fn, x0, st.numbers, calc.n_atoms,
                                freeze=st.freeze, thresh="gau",
                                max_cycles=3000)
    assert res.converged
    x_fin = res.x.numpy()[: calc.n_atoms]
    assert np.array_equal(x_fin[[0, 11]], st.coords_bohr[[0, 11]])
    assert np.abs(res.f.numpy()[1:11]).max() < 4.5e-4
    res_c = lbfgs_minimize(fn, x0, calc.system.free_mask, thresh="gau",
                           max_cycles=5000)
    assert res.e < res_c.e + 1e-5
    jc, jst = _jax_vff(n=12, seed=9, freeze=[0, 11])
    rj = jd.dlc_lbfgs_minimize(jc.au_energy_force_fn(),
                               jc.pad_bohr(jst.coords_bohr), jst.numbers,
                               jc.n_atoms, freeze=[0, 11], thresh="gau",
                               max_cycles=3000)
    assert abs(res.e - rj.e) <= 1e-6
    assert np.abs(x_fin - np.asarray(rj.x)[: calc.n_atoms]).max() <= 1e-2


def test_port_dlc_through_opt_workflow(tmp_path):
    xyz = tmp_path / "m.xyz"
    xyz.write_text(
        "4\n\nC 0 0 0\nC 1.45 0 0\nC 2.2 1.25 0\nC 3.65 1.3 0.1\n")
    kw = dict(charge=0, spin=1, calc_mode="morse", coord_type="dlc",
              verbose=False)
    rt = run_opt(xyz, out_dir=tmp_path / "t", device="cpu", **kw)
    rj = j_run_opt(xyz, out_dir=tmp_path / "j", **kw)
    assert rt["converged"] and rt["cycles"] < 200
    assert rt["cycles"] == rj["cycles"]
    assert rt["force_calls"] == rt["cycles"] + 1
    assert abs(rt["energy"] - rj["energy"]) <= 1e-10
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= 1e-8
    assert (tmp_path / "t" / "final_geometry.xyz").exists()


def _h3_ts():
    xs = [[0, 0, 0], [1.05, 0.0, 0.0], [L, 0, 0]]
    jc = JCalculator(JStructure.from_symbols(["H"] * 3, xs, freeze=[0, 2]),
                     jpot.make_morse())
    st = Structure.from_symbols(["H"] * 3, xs, freeze=[0, 2])
    return jc, Calculator(st, potentials.make_morse(), device="cpu"), st


def test_dlc_rfo_ts_double_well():
    """Both ends frozen on a collinear H3: the constrained DLC set is one
    combination, the reaction coordinate, and the TS search walks up it
    to the symmetric saddle, as JAX's does."""
    jc, calc, st = _h3_ts()
    H0 = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    kw = dict(hessian0=H0, mode="ts", roots=[0], freeze=st.freeze,
              thresh="baker", hessian_update="bofill", max_cycles=300)
    res = td.dlc_rfo_optimize(calc.au_energy_force_fn(),
                              calc.pad_bohr(st.coords_bohr), st.numbers,
                              calc.n_atoms, **kw)
    rj = jd.dlc_rfo_optimize(jc.au_energy_force_fn(),
                             jc.pad_bohr(st.coords_bohr), st.numbers,
                             jc.n_atoms, **kw)
    assert res.converged and rj.converged and res.cycles == rj.cycles
    x = res.x.numpy()[:3]
    assert abs(x[1, 0] * BOHR2ANG - L / 2) < 1e-3
    assert np.array_equal(x[[0, 2]], st.coords_bohr[[0, 2]])
    assert np.abs(x - np.asarray(rj.x)[:3]).max() <= 1e-10
    assert abs(res.e - rj.e) <= 1e-12


def test_dlc_rfo_min_water_matches_cart():
    xs = [[0.0, 0.0, 0.0], [1.1, 0.1, 0.0], [-0.3, 1.05, 0.0]]
    st = Structure.from_symbols(["O", "H", "H"], xs)
    calc = Calculator(st, potentials.make_morse(), device="cpu")
    fn = calc.au_energy_force_fn()
    x0 = calc.pad_bohr(st.coords_bohr)
    H0 = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    res_d = td.dlc_rfo_optimize(fn, x0, st.numbers, calc.n_atoms,
                                hessian0=H0, mode="min", thresh="gau",
                                hessian_update="bfgs", max_cycles=200)
    res_c = rfo_optimize(fn, x0, calc.system.free_mask, calc.n_atoms,
                         hessian0=H0, thresh="gau", max_cycles=200)
    assert res_d.converged and res_c.converged
    assert abs(res_d.e - res_c.e) < 5e-5
    jc = JCalculator(JStructure.from_symbols(["O", "H", "H"], xs),
                     jpot.make_morse())
    rj = jd.dlc_rfo_optimize(jc.au_energy_force_fn(), jc.pad_bohr(
        st.coords_bohr), st.numbers, 3, hessian0=H0, mode="min",
        thresh="gau", hessian_update="bfgs", max_cycles=200)
    assert res_d.cycles == rj.cycles and abs(res_d.e - rj.e) <= 1e-12
    assert np.abs(res_d.x.numpy() - np.asarray(rj.x)).max() <= 1e-10


def test_dlc_rfo_through_tsopt_workflow(tmp_path):
    xyz = tmp_path / "h3.xyz"
    xyz.write_text("3\n\nH 0 0 0\nH 1.05 0 0\nH 2.4 0 0\n")
    kw = dict(charge=0, spin=1, calc_mode="morse", opt_mode="rsirfo",
              coord_type="dlc", freeze_atoms=[0, 2],
              auto_freeze_links=False, verbose=False)
    rt = run_tsopt(xyz, out_dir=tmp_path / "t", device="cpu", **kw)
    rj = j_run_tsopt(xyz, out_dir=tmp_path / "j", **kw)
    assert rt["converged"] and rt["n_imag"] >= 1
    assert abs(rt["coords_bohr"][1, 0] * BOHR2ANG - 1.2) < 1e-3
    assert rt["cycles"] == rj["cycles"] and rt["n_imag"] == rj["n_imag"]
    assert abs(rt["energy"] - rj["energy"]) <= 1e-12
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= 1e-10
    np.testing.assert_allclose(rt["freqs_cm"], rj["freqs_cm"], rtol=1e-8)
    # the seed and final Hessians' force calls, the start, one a cycle
    assert rt["force_calls"] == rt["cycles"] + 3


# ---------------------------------------------------------------------------
# the escn-test calculator through both engines
# ---------------------------------------------------------------------------

def test_dlc_lbfgs_escn_test_matches_jax():
    jc, tc, cb = _pair(freeze=[0], seed=11, n=6)
    kw = dict(freeze=[0], thresh="gau", max_cycles=6)
    rt = td.dlc_lbfgs_minimize(tc.au_energy_force_fn(), tc.pad_bohr(cb),
                               tc.structure.numbers, tc.n_atoms, **kw)
    rj = jd.dlc_lbfgs_minimize(jc.au_energy_force_fn(), jc.pad_bohr(cb),
                               jc.structure.numbers, jc.n_atoms, **kw)
    e0 = tc.get_energy(cb)["energy"]
    assert rt.cycles == rj.cycles == 6 and rt.e < e0
    assert abs(rt.e - rj.e) <= 1e-8
    assert np.abs(rt.x.numpy()[:6] - np.asarray(rj.x)[:6]).max() <= 1e-6
    assert np.array_equal(rt.x.numpy()[0], cb.reshape(-1, 3)[0])
    assert tc.force_calls == 7
