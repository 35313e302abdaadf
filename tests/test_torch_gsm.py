"""Port GSM engine (``engines/gsm.py``) against the JAX package's
``gsm_mep`` on the same inputs in float64:

- the Morse H3 double well with the climbing image and Lanczos tangents,
  against both JAX loops (``loop="device"`` and ``"host"``): the same
  ``converged``, ``cycles``, ``force_calls`` and ``hei_idx``, images to
  1e-7 Bohr and energies to 1e-9 Hartree. At ``max_nodes=9`` the string
  has one middle image and is compared as it is. At the JAX test's
  ``max_nodes=8`` the two middle images are mirror images whose energies
  are equal to the last bit, so which one climbs is decided by rounding,
  and XLA and PyTorch sum in different orders: there the port's string is
  held to the mirror image of JAX's, to the same bounds;
- force-call accounting, (cycles + 1) x M, equal to the calculator's own
  count;
- ``lanczos_lowest_mode`` against the exact lowest eigenvector and JAX's
  direction (up to sign), on H3, whose 3 free DOFs against 10 iterations
  take the Krylov-breakdown branch, and on a 6-atom Morse cluster;
- the Mueller-Brown curved valley: the port's string converges, its
  climbing image lies within 0.02 Angstrom of the analytic saddle and the
  relaxed string within 0.06 Angstrom of a dense steepest-descent MEP
  (the grown-only half of the JAX test, through the device growth loop,
  is in ``tests/test_torch_gsm_device.py``);
- a short escn-test string whose climbing image and Lanczos tangent
  switch on within the run, the port's default (device) loop against
  JAX's host loop."""

import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines.gsm import gsm_mep as j_gsm
from pdb2reaction_tpu.engines.gsm import lanczos_lowest_mode as j_lanczos
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu_torch.constants import ANG2BOHR, BOHR2ANG
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines.gsm import (gsm_mep, lanczos_lowest_mode,
                                                select_hei_index)
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator

from test_torch_calculator import _pair

L = 2.4
H3_A = [[0, 0, 0], [0.686, 0, 0], [L, 0, 0]]
H3_B = np.array([[0, 0, 0], [L - 0.686, 0, 0], [L, 0, 0]])


def _h3():
    jc = JCalculator(JStructure.from_symbols(["H"] * 3, H3_A, freeze=[0, 2]),
                     jpot.make_morse())
    tc = Calculator(Structure.from_symbols(["H"] * 3, H3_A, freeze=[0, 2]),
                    potentials.make_morse(), device="cpu")
    return jc, tc


def _counted(hvp):
    n = [0]

    def fn(x, v):
        n[0] += 1
        return hvp(x, v)
    return fn, n


def _run_both(jc, tc, xA, xB, loop, **kw):
    rj = j_gsm(jc.au_energy_force_batch_fn(), jc.pad_bohr(xA),
               jc.pad_bohr(xB), jc.system.free_mask, loop=loop,
               hvp_fn=jc.au_hvp_fn(), **kw)
    hvp, n = _counted(tc.au_hvp_fn())
    rt = gsm_mep(tc.au_energy_force_batch_fn(), tc.pad_bohr(xA),
                 tc.pad_bohr(xB), tc.system.free_mask, hvp_fn=hvp, **kw)
    return rj, rt, n[0]


def _mirror_h3(images):
    """The H3 string reflected through the well's midpoint: image order
    reversed, x -> L - x, the two frozen end atoms swapped."""
    m = images[::-1].copy()
    m[:, :3, 0] = L * ANG2BOHR - m[:, :3, 0]
    m[:, [0, 2]] = m[:, [2, 0]]
    return m


def test_select_hei_prefers_internal_maxima():
    assert select_hei_index([0.0, 1.0, 0.5, 2.0, 0.1]) == 3
    # no internal local max -> argmax of the interior
    assert select_hei_index([0.0, 1.0, 2.0, 3.0, 4.0]) == 3
    assert select_hei_index([1.0, 0.5]) == 0


@pytest.mark.parametrize("loop", ["device", "host"])
@pytest.mark.parametrize("max_nodes", [9, 8])
def test_gsm_morse_double_well_matches_jax(loop, max_nodes):
    jc, tc = _h3()
    xA = np.asarray(H3_A, float) * ANG2BOHR
    rj, rt, n_hvp = _run_both(jc, tc, xA, H3_B * ANG2BOHR, loop,
                              max_nodes=max_nodes, max_cycles=300,
                              conv_perp_rms=5e-4, climb=True)
    M = max_nodes + 2
    assert rt.converged and rj.converged
    assert rt.cycles == rj.cycles
    assert rt.force_calls == rj.force_calls == (rt.cycles + 1) * M
    assert tc.force_calls == rt.force_calls
    # the climbing image ran on Lanczos tangents, 10 HVPs a cycle
    assert n_hvp > 0 and n_hvp % 10 == 0
    ji, je = np.asarray(rj.images), np.asarray(rj.energies)
    if max_nodes % 2:
        assert rt.hei_idx == rj.hei_idx
        ti, te = rt.images, rt.energies
    else:
        assert rt.hei_idx in (M // 2 - 1, M // 2)
        assert rt.hei_idx == M - 1 - rj.hei_idx
        ti, te = _mirror_h3(rt.images), rt.energies[::-1]
    assert np.abs(ti[:, :3] - ji[:, :3]).max() <= 1e-7
    assert np.all(rt.images[:, 3:] == 0.0)               # padding rows
    assert np.abs(te - je).max() <= 1e-9
    # the JAX test's physics: endpoints kept, barrier at the midpoint
    np.testing.assert_allclose(rt.images[0][:3] * BOHR2ANG, H3_A,
                               atol=1e-10)
    np.testing.assert_allclose(rt.images[-1][:3] * BOHR2ANG, H3_B,
                               atol=1e-10)
    x_hei = rt.images[rt.hei_idx][:3] * BOHR2ANG
    assert x_hei[1, 0] == pytest.approx(L / 2, abs=0.05)
    assert rt.energies[rt.hei_idx] - rt.energies[0] == pytest.approx(
        0.0177, abs=2e-3)


@pytest.mark.parametrize("max_cycles,stop", [(50, 300), (3, 300), (12, 2)])
def test_gsm_force_call_accounting(max_cycles, stop):
    """Growth cycles + relaxation cycles + the relaxation's energy seed,
    M = 6 images each; the batched closure counts the same calls on the
    calculator (the workflow adds nothing)."""
    jc, tc = _h3()
    xA = np.asarray(H3_A, float) * ANG2BOHR
    res = gsm_mep(tc.au_energy_force_batch_fn(), tc.pad_bohr(xA),
                  tc.pad_bohr(H3_B * ANG2BOHR), tc.system.free_mask,
                  max_nodes=4, max_cycles=max_cycles, stop_in_when_full=stop,
                  conv_perp_rms=5e-4)
    assert res.force_calls == (res.cycles + 1) * 6
    assert tc.force_calls == res.force_calls
    rj = j_gsm(jc.au_energy_force_batch_fn(), jc.pad_bohr(xA),
               jc.pad_bohr(H3_B * ANG2BOHR), jc.system.free_mask,
               max_nodes=4, max_cycles=max_cycles, stop_in_when_full=stop,
               conv_perp_rms=5e-4, loop="host")
    assert (res.cycles, res.converged) == (rj.cycles, rj.converged)


def _morse_cluster():
    rng = np.random.default_rng(5)
    zs = np.array([6, 1, 1, 8, 1, 7], np.int32)
    xyz = rng.normal(scale=1.1, size=(6, 3))
    jc = JCalculator(JStructure(zs, xyz), jpot.make_morse())
    tc = Calculator(Structure(zs, xyz), potentials.make_morse(),
                    device="cpu")
    return jc, tc, Structure(zs, xyz).coords_bohr


@pytest.mark.parametrize("case", ["h3-breakdown", "cluster"])
def test_lanczos_lowest_mode_matches_exact_and_jax(case):
    import jax.numpy as jnp
    if case == "h3-breakdown":
        st = [[0, 0, 0], [1.2, 0, 0], [2.4, 0, 0]]
        jc = JCalculator(JStructure.from_symbols(["H"] * 3, st,
                                                 freeze=[0, 2]),
                         jpot.make_morse())
        tc = Calculator(Structure.from_symbols(["H"] * 3, st, freeze=[0, 2]),
                        potentials.make_morse(), device="cpu")
        cb = np.asarray(st, float) * ANG2BOHR
        iters = 10                              # > 3 free DOFs
    else:
        jc, tc, cb = _morse_cluster()
        iters = 18                              # = the free DOFs: exact
    x = tc.pad_bohr(cb)
    fm = tc.system.free_mask.double().repeat_interleave(3)
    v0 = np.random.default_rng(0).normal(size=x.numel())
    hvp, n = _counted(tc.au_hvp_fn())
    d = lanczos_lowest_mode(hvp, x, torch.as_tensor(v0), fm,
                            iters=iters).numpy()
    assert n[0] == iters
    dj = np.asarray(j_lanczos(jc.au_hvp_fn(), jc.pad_bohr(cb),
                              jnp.asarray(v0),
                              jnp.repeat(jnp.asarray(jc.system.free_mask),
                                         3), iters=iters))
    # the Ritz vector's sign is arbitrary: compare directions
    assert abs(float(d @ dj)) >= 1 - 1e-8
    H = tc.get_hessian(cb.reshape(-1))["hessian"]
    free = tc.free_dof_mask
    w, V = np.linalg.eigh(H[np.ix_(free, free)])
    exact = np.zeros(x.numel())
    exact[: 3 * tc.n_atoms][free] = V[:, 0]
    assert abs(float(d @ exact)) > 0.999
    # 10 iterations of 18 DOFs approximate it; JAX agrees there too
    if case == "cluster":
        d10 = lanczos_lowest_mode(tc.au_hvp_fn(), x, torch.as_tensor(v0), fm,
                                  iters=10).numpy()
        dj10 = np.asarray(j_lanczos(
            jc.au_hvp_fn(), jc.pad_bohr(cb), jnp.asarray(v0),
            jnp.repeat(jnp.asarray(jc.system.free_mask), 3), iters=10))
        assert abs(float(d10 @ dj10)) >= 1 - 1e-8


# Mueller-Brown surface scaled to eV (the JAX test's constants)
MB = dict(S=0.02, A=np.array([-200., -100., -170., 15.]),
          a=np.array([-1., -1., -6.5, 0.7]), b=np.array([0., 0., 11., 0.6]),
          c=np.array([-10., -10., -6.5, 0.7]),
          x0=np.array([1., 0., -0.5, -1.]), y0=np.array([0., 0.5, 1.5, 1.]))


def _mb_terms(p):
    dx, dy = p[0] - MB["x0"], p[1] - MB["y0"]
    e = MB["S"] * MB["A"] * np.exp(MB["a"] * dx ** 2 + MB["b"] * dx * dy
                                   + MB["c"] * dy ** 2)
    gx = 2 * MB["a"] * dx + MB["b"] * dy
    gy = MB["b"] * dx + 2 * MB["c"] * dy
    return e, gx, gy


def _mb_grad(p):
    e, gx, gy = _mb_terms(p)
    return np.array([(e * gx).sum(), (e * gy).sum()])


def _mb_hess(p):
    e, gx, gy = _mb_terms(p)
    return np.array([[(e * (gx * gx + 2 * MB["a"])).sum(),
                      (e * (gx * gy + MB["b"])).sum()],
                     [(e * (gx * gy + MB["b"])).sum(),
                      (e * (gy * gy + 2 * MB["c"])).sum()]])


def _mb_energy(coords, system, params=None):
    t = lambda v: torch.as_tensor(v, dtype=coords.dtype)   # noqa: E731
    dx = coords[0, 0] - t(MB["x0"])
    dy = coords[0, 1] - t(MB["y0"])
    e = MB["S"] * (t(MB["A"]) * torch.exp(
        t(MB["a"]) * dx ** 2 + t(MB["b"]) * dx * dy + t(MB["c"]) * dy ** 2)
    ).sum()
    return e + 0.5 * MB["S"] * coords[0, 2] ** 2


def test_gsm_curved_valley_saddle_and_mep():
    def newton(p):
        p = np.array(p, float)
        for _ in range(30):
            p = p - np.linalg.solve(_mb_hess(p), _mb_grad(p))
        return p

    mA = newton([-0.05, 0.47])
    mB = newton([-0.56, 1.44])
    sad = newton([-0.822, 0.624])
    stA = Structure.from_symbols(["H"], [[mA[0], mA[1], 0.0]])
    stB = Structure.from_symbols(["H"], [[mB[0], mB[1], 0.0]])
    calc = Calculator(stA, _mb_energy, device="cpu")
    res = gsm_mep(calc.au_energy_force_batch_fn(),
                  calc.pad_bohr(stA.coords_bohr),
                  calc.pad_bohr(stB.coords_bohr), calc.system.free_mask,
                  max_nodes=12, max_cycles=600, stop_in_when_full=600,
                  conv_perp_rms=4e-4, perp_thresh=2e-3, climb=True,
                  hvp_fn=calc.au_hvp_fn())
    assert res.converged
    pts = res.images[:, 0, :2] * BOHR2ANG
    assert np.linalg.norm(pts[res.hei_idx] - sad) < 0.02

    # dense steepest-descent MEP from the saddle, both directions
    w, V = np.linalg.eigh(_mb_hess(sad))
    mode = V[:, 0]

    def dense(sign, ds=2e-4):
        q = sad + sign * 1e-3 * mode
        out = [q.copy()]
        for _ in range(40000):
            g = _mb_grad(q)
            ng = np.linalg.norm(g)
            if ng < 1e-4:
                break
            q = q - ds * g / ng
            out.append(q.copy())
        return np.array(out)

    ref = np.vstack([dense(1.0), dense(-1.0), sad[None]])
    dev = np.sqrt(((pts[:, None, :] - ref[None, :, :]) ** 2).sum(-1))
    assert dev.min(1).max() < 0.06


def test_gsm_escn_string_climbs_like_jax():
    """escn-test, 6 atoms, one frozen, max_nodes=4, through the port's
    default loop (the device loop: its relaxation switches from the cycle
    without Lanczos to the one with it): the climbing image switches on
    after the string has relaxed a while, and from then on every cycle
    runs a 10-step Lanczos tangent; the JAX host loop on the same weights
    takes the same path."""
    jc, tc, cb = _pair(freeze=[0], seed=7, n=6)
    rng = np.random.default_rng(2)
    xA = cb.reshape(-1, 3)
    xB = xA + 0.25 * rng.normal(size=(6, 3))
    xB[0] = xA[0]
    kw = dict(max_nodes=4, max_cycles=25, conv_perp_rms=7e-4, climb=True,
              climb_rms=6.5e-4, perp_thresh=5e-3)
    rj, rt, n_hvp = _run_both(jc, tc, xA, xB, "host", **kw)
    assert rt.cycles == rj.cycles and rt.converged == rj.converged
    assert rt.force_calls == rj.force_calls == tc.force_calls
    # climbing switched on within the run, not at its first cycle
    relax = rt.cycles - 2                       # two growth cycles
    assert 0 < n_hvp < 10 * (relax - 1) and n_hvp % 10 == 0
    assert rt.hei_idx == rj.hei_idx
    assert np.abs(rt.images - np.asarray(rj.images)).max() <= 1e-6
    assert np.abs(rt.energies - np.asarray(rj.energies)).max() <= 1e-9
