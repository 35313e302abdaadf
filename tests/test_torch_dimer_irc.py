"""Port Hessian dimer and EulerPC IRC (``engines/dimer.py``,
``engines/irc.py``) against the JAX package's:

- twins of the six tests of ``tests/test_tsopt_irc.py`` on the port (the
  two the JAX suite counts as slow run here in a few seconds each, under
  their own names);
- ``hessian_dimer`` against JAX on the H3 double well and the 3D offset
  start: the same cycles, force calls and frequencies, the TS to 1e-7
  Bohr (the port's closures count the evaluations JAX meters from its
  device loop's ``calls``);
- the DWI gradient in closed form against ``jax.grad(_dwi_energy)``,
  with symmetric and asymmetric Hessians, to 1e-12; ``_mbs_integrate``
  against JAX's on the same analytic field, to 1e-12;
- ``eulerpc_irc`` against JAX on the H3 TS, both branches, with and
  without exact-Hessian refreshes: the same step counts and force calls
  (a refresh metered as 3n), endpoints to 1e-7 Bohr;
- twins of the restart tests (``tests/test_restart.py:100, 143``): a
  killed IRC branch and a killed dimer pass resume from their last dump;
- the flatten loop (probes and the Bofill variant) from a second-order
  saddle of a two-well test surface."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines import irc as jirc
from pdb2reaction_tpu.engines.dimer import hessian_dimer as j_dimer
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines import irc
from pdb2reaction_tpu_torch.engines.dimer import hessian_dimer
from pdb2reaction_tpu_torch.engines.irc import eulerpc_irc
from pdb2reaction_tpu_torch.engines.vib import frequencies_and_modes
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.runtime.checkpoint import CheckpointStore

L = 2.4
X_TOL = 1e-7


def double_well(x1=1.05, freeze=(0, 2)):
    return Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [x1, 0, 0], [L, 0, 0]],
        freeze=list(freeze))


def _calc(st):
    return Calculator(st, potentials.make_morse(), device="cpu")


def _pair(xyz, freeze=(0, 2)):
    jc = JCalculator(JStructure.from_symbols(["H"] * 3, xyz,
                                             freeze=list(freeze)),
                     jpot.make_morse())
    tc = _calc(Structure.from_symbols(["H"] * 3, xyz, freeze=list(freeze)))
    return jc, tc


# ---- twins of tests/test_tsopt_irc.py -------------------------------------

def test_hessian_dimer_finds_ts():
    st = double_well(1.05)
    calc = _calc(st)
    res = hessian_dimer(calc, calc.pad_bohr(st.coords_bohr),
                        flatten_max_iter=0)
    assert res.converged
    assert res.x.numpy()[1, 0] * BOHR2ANG == pytest.approx(L / 2, abs=2e-3)
    assert res.cycles > 0


def test_hessian_dimer_3d_offset_start():
    st = Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [1.0, 0.12, -0.08], [L, 0, 0]],
        freeze=[0, 2])
    calc = _calc(st)
    res = hessian_dimer(calc, calc.pad_bohr(st.coords_bohr),
                        flatten_max_iter=0)
    assert res.converged
    x = res.x.numpy()[:3] * BOHR2ANG
    assert x[1, 0] == pytest.approx(L / 2, abs=5e-3)
    assert abs(x[1, 1]) < 2e-3 and abs(x[1, 2]) < 2e-3


def test_irc_connects_minima():
    st = double_well(L / 2)
    calc = _calc(st)
    res = eulerpc_irc(calc, calc.pad_bohr(st.coords_bohr),
                      step_length=0.10, max_cycles=80,
                      rms_grad_thresh=5e-4)
    ends = sorted([res.forward.coords[-1][1, 0] * BOHR2ANG,
                   res.backward.coords[-1][1, 0] * BOHR2ANG])
    assert ends[0] == pytest.approx(0.686, abs=0.08)
    assert ends[1] == pytest.approx(L - 0.686, abs=0.08)
    assert res.forward.energies[-1] < res.ts_energy
    assert res.backward.energies[-1] < res.ts_energy
    assert res.forward.converged and res.backward.converged


def _steepest_field(q):
    g = torch.stack([q[0], 9.0 * q[1]])
    return -g / torch.linalg.norm(g).clamp_min(1e-12)


def test_mbs_corrector_order():
    q0 = torch.tensor([1.0, 0.4], dtype=torch.float64)
    free = torch.ones(2, dtype=torch.float64)
    H = 0.5

    def f_np(q):
        g = np.array([q[0], 9.0 * q[1]])
        return -g / np.linalg.norm(g)

    q_ref = q0.numpy().copy()
    h = H / 2000
    for _ in range(2000):          # RK4 reference
        k1 = f_np(q_ref)
        k2 = f_np(q_ref + 0.5 * h * k1)
        k3 = f_np(q_ref + 0.5 * h * k2)
        k4 = f_np(q_ref + h * k3)
        q_ref = q_ref + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    q_mbs = irc._mbs_integrate(_steepest_field, q0, H, free).numpy()
    z0 = q0.numpy()
    z1 = z0 + H / 2 * f_np(z0)
    z2 = z0 + H * f_np(z1)
    q_mid = 0.5 * (z2 + z1 + H / 2 * f_np(z2))       # one n = 2 pass
    err_mbs = np.linalg.norm(q_mbs - q_ref)
    assert err_mbs < 1e-6
    assert err_mbs < np.linalg.norm(q_mid - q_ref) / 100.0


def test_irc_both_branches_12_atoms_port():
    """Twin of ``test_irc_both_branches_12_atoms``."""
    rng = np.random.default_rng(11)
    cage = 20.0 + 3.0 * np.stack(
        np.meshgrid([0, 1, 2], [0, 1], [0, 1]), -1).reshape(-1, 3)[:9] \
        + rng.normal(scale=0.05, size=(9, 3))
    reactive = np.array([[0.0, 0.0, 0.0], [L / 2, 0.0, 0.0], [L, 0.0, 0.0]])
    st = Structure.from_symbols(["C"] * 9 + ["H", "H", "H"],
                                np.vstack([cage, reactive]),
                                freeze=list(range(9)) + [9, 11])
    calc = _calc(st)
    ts = hessian_dimer(calc, calc.pad_bohr(st.coords_bohr),
                       flatten_max_iter=0)
    res = eulerpc_irc(calc, ts.x, step_length=0.10, max_cycles=120,
                      rms_grad_thresh=5e-4)
    assert res.forward.converged and res.backward.converged
    assert res.forward.energies[-1] < res.ts_energy
    assert res.backward.energies[-1] < res.ts_energy
    ends = sorted([res.forward.coords[-1][10, 0] * BOHR2ANG,
                   res.backward.coords[-1][10, 0] * BOHR2ANG])
    assert ends[0] == pytest.approx(0.686, abs=0.08)
    assert ends[1] == pytest.approx(L - 0.686, abs=0.08)
    assert len(res.forward.gradients) == len(res.forward.coords)


_MB = dict(A=[-200., -100., -170., 15.], a=[-1., -1., -6.5, 0.7],
           b=[0., 0., 11., 0.6], c=[-10., -10., -6.5, 0.7],
           x0=[1., 0., -0.5, -1.], y0=[0., 0.5, 1.5, 1.])
_SCALE = 0.02


def _mb2d(x, y):
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in _MB.items()}
    dx, dy = x - t["x0"], y - t["y0"]
    return _SCALE * torch.sum(t["A"] * torch.exp(
        t["a"] * dx ** 2 + t["b"] * dx * dy + t["c"] * dy ** 2))


def test_irc_hessian_recalc_tracks_curved_valley_port():
    """Twin of ``test_irc_hessian_recalc_tracks_curved_valley`` on the
    Muller-Brown surface."""
    def efn(coords, system, params):
        return _mb2d(coords[0, 0], coords[0, 1]) \
            + 0.5 * _SCALE * coords[0, 2] ** 2

    p = torch.tensor([-0.822, 0.624], dtype=torch.float64)
    f2 = lambda v: _mb2d(v[0], v[1])  # noqa: E731
    for _ in range(20):            # Newton onto the saddle
        g = torch.autograd.functional.jacobian(f2, p)
        Hs = torch.autograd.functional.hessian(f2, p)
        p = p - torch.linalg.solve(Hs, g)
    st = Structure.from_symbols(["H"], [[float(p[0]), float(p[1]), 0.0]])

    def run(recalc):
        calc = Calculator(st, efn, device="cpu")
        res = eulerpc_irc(calc, calc.pad_bohr(st.coords_bohr),
                          step_length=0.35, max_cycles=60,
                          rms_grad_thresh=8e-4, hessian_recalc=recalc)
        return res, calc.force_calls

    res_b, nf_b = run(None)
    res_e, nf_e = run(2)
    assert res_b.forward.converged and res_e.forward.converged
    target = np.array([-0.55826787, 1.44177002])

    def end_err(res):
        return float(np.linalg.norm(
            res.forward.coords[-1][0, :2] * BOHR2ANG - target))

    assert end_err(res_b) > 0.05
    assert end_err(res_e) < 0.02
    assert nf_e > nf_b


# ---- against the JAX package ----------------------------------------------

@pytest.mark.parametrize("x1", [[1.05, 0, 0], [1.0, 0.12, -0.08]])
def test_hessian_dimer_matches_jax(x1):
    jc, tc = _pair([[0, 0, 0], x1, [L, 0, 0]])
    rj = j_dimer(jc, jc.pad_bohr(jc.structure.coords_bohr),
                 flatten_max_iter=0)
    rt = hessian_dimer(tc, tc.pad_bohr(tc.structure.coords_bohr),
                       flatten_max_iter=0)
    assert rt.converged == bool(rj.converged) is True
    assert rt.cycles == rj.cycles
    assert tc.force_calls == jc.force_calls
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= X_TOL
    assert abs(rt.e - rj.e) <= 1e-10
    np.testing.assert_allclose(rt.freqs_cm, rj.freqs_cm, rtol=1e-8)
    assert rt.n_imag == rj.n_imag


def _dwi_inputs(seed, asym):
    rng = np.random.default_rng(seed)
    n3 = 12
    q, q1, q2, g1, g2 = (rng.normal(size=n3) for _ in range(5))
    h = []
    for _ in range(2):
        A = rng.normal(size=(n3, n3))
        h.append(A + A.T + (0.3 * rng.normal(size=(n3, n3)) if asym else 0))
    return q, q1, -0.4, g1, h[0], q2, -0.41, g2, h[1]


@pytest.mark.parametrize("seed,asym", [(0, False), (1, True), (2, True)])
def test_dwi_gradient_matches_jax_grad(seed, asym):
    q, q1, e1, g1, h1, q2, e2, g2, h2 = _dwi_inputs(seed, asym)
    gj = np.asarray(jax.grad(jirc._dwi_energy)(
        jnp.asarray(q), jnp.asarray(q1), e1, jnp.asarray(g1),
        jnp.asarray(h1), jnp.asarray(q2), e2, jnp.asarray(g2),
        jnp.asarray(h2)))
    T = torch.as_tensor
    gt = irc._dwi_grad(T(q), torch.stack([T(q1), T(q2)]),
                       torch.tensor([e1, e2], dtype=torch.float64),
                       torch.stack([T(g1), T(g2)]),
                       torch.stack([irc._sym(T(h1)), irc._sym(T(h2))]))
    assert np.abs(gt.numpy() - gj).max() <= 1e-12 * np.abs(gj).max()
    ej = float(jirc._dwi_energy(*(jnp.asarray(a) for a in
                                  (q, q1, e1, g1, h1, q2, e2, g2, h2))))
    et = float(irc._dwi_energy(*(T(np.asarray(a)) for a in
                                 (q, q1, e1, g1, h1, q2, e2, g2, h2))))
    assert abs(et - ej) <= 1e-12 * abs(ej)


def test_mbs_integrate_matches_jax():
    def jfield(q):
        g = jnp.asarray([q[0], 9.0 * q[1]])
        return -g / jnp.maximum(jnp.linalg.norm(g), 1e-12)

    for q0, H in (([1.0, 0.4], 0.5), ([0.3, -0.7], 0.1)):
        qj = np.asarray(jirc._mbs_integrate(jfield, jnp.asarray(q0), H,
                                            jnp.asarray([1.0, 0.0])))
        qt = irc._mbs_integrate(_steepest_field,
                                torch.tensor(q0, dtype=torch.float64), H,
                                torch.tensor([1.0, 0.0],
                                             dtype=torch.float64)).numpy()
        assert np.abs(qt - qj).max() <= 1e-12
        assert qt[1] == q0[1]                 # the frozen component


@pytest.mark.parametrize("recalc", [None, 3])
def test_eulerpc_irc_matches_jax(recalc):
    jc, tc = _pair([[0, 0, 0], [L / 2, 0, 0], [L, 0, 0]])
    kw = dict(step_length=0.10, max_cycles=40, rms_grad_thresh=5e-4,
              hessian_recalc=recalc)
    rj = jirc.eulerpc_irc(jc, jc.pad_bohr(jc.structure.coords_bohr), **kw)
    rt = eulerpc_irc(tc, tc.pad_bohr(tc.structure.coords_bohr), **kw)
    assert abs(rt.ts_energy - rj.ts_energy) <= 1e-12
    for b in ("forward", "backward"):
        bj, bt = getattr(rj, b), getattr(rt, b)
        assert bt.converged == bj.converged is True
        assert len(bt.coords) == len(bj.coords)
        assert np.abs(bt.coords[-1] - bj.coords[-1]).max() <= X_TOL
        assert np.abs(np.subtract(bt.energies, bj.energies)).max() <= 1e-10
        assert np.abs(bt.gradients[-1] - bj.gradients[-1]).max() <= 1e-8
    assert tc.force_calls == jc.force_calls
    assert tc.energy_calls == jc.energy_calls == 1


# ---- restart twins (tests/test_restart.py) --------------------------------

class _KillAfter:
    """CheckpointStore.save raising after n dumps: a kill between chunks
    leaves exactly this on disk."""

    def __init__(self, store, n):
        self.store, self.left = store, n

    def __getattr__(self, k):
        return getattr(self.store, k)

    def save(self, *a, **kw):
        self.store.save(*a, **kw)
        self.left -= 1
        if self.left <= 0:
            raise KeyboardInterrupt("simulated kill after dump")


def test_irc_restart_resumes_branch_port(tmp_path, monkeypatch):
    """Twin of ``test_irc_restart_resumes_branch``."""
    st = double_well(L / 2)
    kw = dict(step_length=0.10, max_cycles=80, rms_grad_thresh=5e-4,
              backward=False)
    calc = _calc(st)
    ref = eulerpc_irc(calc, calc.pad_bohr(st.coords_bohr), **kw)
    n_ref = len(ref.forward.coords)

    store = CheckpointStore(tmp_path / "rst")
    calc2 = _calc(st)
    with pytest.raises(KeyboardInterrupt):
        eulerpc_irc(calc2, calc2.pad_bohr(st.coords_bohr),
                    restart={"store": _KillAfter(store, 2), "name": "irc",
                             "every": 5}, **kw)
    rec = store.load("irc_fwd")
    assert rec is not None and not rec[0]["done"]
    assert int(rec[1]["cycle"]) == 10

    saves = []
    orig_save = CheckpointStore.save

    def spy(self, name, meta, arrays=None):
        saves.append(name)
        return orig_save(self, name, meta, arrays)

    monkeypatch.setattr(CheckpointStore, "save", spy)
    calc3 = _calc(st)
    res = eulerpc_irc(calc3, calc3.pad_bohr(st.coords_bohr),
                      restart={"store": store, "name": "irc", "every": 5},
                      **kw)
    assert len(saves) == -(-(n_ref - 10) // 5)
    assert len(res.forward.coords) == n_ref
    np.testing.assert_allclose(res.forward.coords[-1],
                               ref.forward.coords[-1], atol=1e-8)
    assert store.load("irc_fwd")[0]["done"]
    # the resumed branch evaluated only the cycles after the dump
    assert calc3.force_calls < calc.force_calls


def test_dimer_restart_resumes_pass_port(tmp_path):
    """Twin of ``test_dimer_restart_resumes_pass``."""
    st = double_well(1.05)
    calc = _calc(st)
    ref = hessian_dimer(calc, calc.pad_bohr(st.coords_bohr),
                        flatten_max_iter=0)
    assert ref.converged
    store = CheckpointStore(tmp_path / "rst")
    calc2 = _calc(st)
    with pytest.raises(KeyboardInterrupt):
        hessian_dimer(calc2, calc2.pad_bohr(st.coords_bohr),
                      flatten_max_iter=0,
                      restart={"store": _KillAfter(store, 2), "name": "ts",
                               "every": 2})
    assert store.has("ts_hess000") and store.load("ts_pass000") is not None
    calc3 = _calc(st)
    res = hessian_dimer(calc3, calc3.pad_bohr(st.coords_bohr),
                        flatten_max_iter=0,
                        restart={"store": store, "name": "ts", "every": 2})
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), atol=1e-6)
    assert res.x.numpy()[1, 0] * BOHR2ANG == pytest.approx(L / 2, abs=2e-3)
    assert calc3.force_calls < calc.force_calls


# ---- the flatten loop -------------------------------------------------------

def _two_wells(c, system, params):
    """Double wells along r01 and r12 (maxima at 1 Angstrom, unequal
    curvatures) and a spring on r02: the triangle with r01 = r12 = 1,
    r02 = 1.6 is a stationary point with two imaginary modes."""
    def r(i, j):
        return torch.linalg.norm(c[i] - c[j])
    u1, u2, u3 = r(0, 1) - 1.0, r(1, 2) - 1.0, r(0, 2) - 1.6
    return (-0.8 * u1 ** 2 + 2.0 * u1 ** 4 - 0.5 * u2 ** 2 + 2.0 * u2 ** 4
            + u3 ** 2)


@pytest.mark.parametrize("bofill", [False, True])
def test_flatten_loop_leaves_one_imaginary_mode(bofill):
    """From a second-order saddle the dimer passes converge at once; the
    flatten loop probes the extra imaginary mode in one batched call,
    moves downhill along it and refines to a first-order saddle."""
    st = Structure.from_symbols(["H"] * 3,
                                [[0, 0, 0], [0.8, 0.6, 0], [1.6, 0, 0]])
    calc = Calculator(st, _two_wells, device="cpu")
    H = calc.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    vib = frequencies_and_modes(H, st.numbers, st.coords_bohr)
    assert int((vib.freqs_cm < -5.0).sum()) == 2
    calls = []
    orig = calc.au_energy_force_batch_fn()

    def spy(xb):
        calls.append(xb.shape[0])
        return orig(xb)

    calc.au_energy_force_batch_fn = lambda: spy
    res = hessian_dimer(calc, calc.pad_bohr(st.coords_bohr),
                        flatten_max_iter=3, flatten_bofill=bofill,
                        max_cycles_total=300)
    assert res.converged and res.n_imag == 1
    # +/- along the one extra mode (and the Bofill variant's own point)
    assert calls[:2] == ([2, 1] if bofill else [2])[:2]
