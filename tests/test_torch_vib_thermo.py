"""Port vibrational analysis and thermochemistry (``engines/vib.py``,
``engines/thermo.py``) against the JAX package's:

- twins of the seven tests of ``tests/test_vib_thermo.py`` on the port;
- ``frequencies_and_modes`` against JAX on random symmetric Hessians and
  on Morse Hessians, with and without a freeze list (full 3N and
  active-block inputs): frequencies to 1e-8 relative to the largest,
  modes compared as the projector onto each group of (near-)degenerate
  modes, which is blind to eigenvector signs and to the arbitrary basis
  of a degenerate group, to 1e-8;
- ``thermochemistry`` against JAX's, every term to 1e-10 relative."""

import numpy as np
import pytest
import torch

from pdb2reaction_tpu.engines.thermo import thermochemistry as j_thermo
from pdb2reaction_tpu.engines.vib import frequencies_and_modes as j_freqs
from pdb2reaction_tpu.engines.vib import free_block_modes as j_free_block
from pdb2reaction_tpu_torch import elements
from pdb2reaction_tpu_torch.constants import H_EVAA_2_AU, NU_CM_FACTOR
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines.thermo import thermochemistry
from pdb2reaction_tpu_torch.engines.vib import (count_imaginary,
                                                free_block_modes,
                                                frequencies_and_modes,
                                                tr_basis)
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator

FREQ_TOL = 1e-8     # max|dnu| / max|nu|
MODE_TOL = 1e-8     # max|dP| of the projectors onto each mode group
THERMO_TOL = 1e-10  # relative, every term


def _calc(st, **kw):
    return Calculator(st, potentials.make_morse(), device="cpu", **kw)


def _groups(freqs, rel=1e-6):
    """Index groups of frequencies equal to ``rel`` of the largest."""
    order = np.argsort(freqs)
    scale = max(np.abs(freqs).max(), 1.0)
    groups, cur = [], [order[0]]
    for a, b in zip(order[:-1], order[1:]):
        if abs(freqs[b] - freqs[a]) <= rel * scale:
            cur.append(b)
        else:
            groups.append(cur)
            cur = [b]
    return groups + [cur]


def _assert_same_vib(vt, vj):
    assert vt.freqs_cm.shape == vj.freqs_cm.shape
    scale = np.abs(vj.freqs_cm).max()
    assert np.abs(vt.freqs_cm - vj.freqs_cm).max() <= FREQ_TOL * scale
    for g in _groups(vj.freqs_cm):
        Pj = vj.modes_mw[g].T @ vj.modes_mw[g]
        Pt = vt.modes_mw[g].T @ vt.modes_mw[g]
        assert np.abs(Pt - Pj).max() <= MODE_TOL
        if len(g) == 1:         # a lone mode: equal up to sign
            k = g[0]
            s = np.sign(vt.modes_cart[k].ravel() @ vj.modes_cart[k].ravel())
            np.testing.assert_allclose(s * vt.modes_cart[k],
                                       vj.modes_cart[k], atol=MODE_TOL)


# ---- twins of tests/test_vib_thermo.py ------------------------------------

def test_diatomic_frequency_analytic():
    De, a = 4.0, 2.0
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.64, 0, 0]])
    calc = Calculator(st, potentials.make_morse(De=De, a=a), device="cpu")
    res = calc.get_hessian(st.coords_bohr.reshape(-1))
    vib = frequencies_and_modes(res["hessian"], st.numbers, st.coords_bohr)
    assert len(vib.freqs_cm) == 1
    k_au = 2 * De * a * a * H_EVAA_2_AU
    mu = elements.MASSES[1] / 2
    assert vib.freqs_cm[0] == pytest.approx(np.sqrt(k_au / mu)
                                            * NU_CM_FACTOR, rel=1e-4)


def test_ts_imaginary_modes():
    L = 2.4
    st = Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [L / 2, 0, 0], [L, 0, 0]])
    H = _calc(st).get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    vib = frequencies_and_modes(H, st.numbers, st.coords_bohr)
    assert count_imaginary(vib.freqs_cm) == 2
    imode = vib.modes_cart[np.argmin(vib.freqs_cm)]
    assert abs(imode[1, 0]) > 0.8
    np.testing.assert_allclose(imode[:, 1:], 0.0, atol=1e-6)


def test_phva_single_active_atom_projected_empty():
    L = 2.4
    st = Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [L / 2, 0, 0], [L, 0, 0]],
        freeze=[0, 2])
    H = _calc(st).get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    vib = frequencies_and_modes(H, st.numbers, st.coords_bohr,
                                freeze_idx=[0, 2])
    assert len(vib.freqs_cm) == 0


def test_phva_block_equals_full():
    L = 2.4
    st = Structure.from_symbols(
        ["H", "H", "H"], [[0, 0, 0], [1.0, 0, 0], [L, 0, 0]],
        freeze=[0, 2])
    x = st.coords_bohr.reshape(-1)
    Hf = _calc(st).get_hessian(x)["hessian"]
    Hp = _calc(st, return_partial_hessian=True).get_hessian(x)["hessian"]
    vf = frequencies_and_modes(Hf, st.numbers, st.coords_bohr,
                               freeze_idx=[0, 2])
    vp = frequencies_and_modes(Hp, st.numbers, st.coords_bohr,
                               freeze_idx=[0, 2])
    np.testing.assert_allclose(vf.freqs_cm, vp.freqs_cm, atol=1e-8)


def test_tr_basis_orthonormal():
    st = Structure.from_symbols(
        ["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    Q = tr_basis(torch.as_tensor(st.coords_bohr),
                 torch.as_tensor(st.masses)).numpy()
    np.testing.assert_allclose(Q.T @ Q, np.eye(6), atol=1e-10)


def _water():
    return Structure.from_symbols(
        ["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])


def test_thermo_water_sanity():
    st = _water()
    th = thermochemistry([1600.0, 3650.0, 3750.0], st.numbers, st.coords,
                         T=298.15, electronic_energy=-76.4)
    assert th.zpe == pytest.approx(0.0205, abs=5e-4)
    assert th.s_trans * 2625499.6 == pytest.approx(144.8, rel=0.01)
    assert th.gibbs < th.electronic_energy + th.enthalpy_corr
    assert th.n_imag == 0


def test_qrrho_damps_low_freq_entropy():
    st = _water()
    th_low = thermochemistry([10.0, 3650.0], st.numbers, st.coords)
    th_rrho = thermochemistry([10.0, 3650.0], st.numbers, st.coords,
                              qrrho_nu0=1e-6)
    assert th_low.s_vib < th_rrho.s_vib
    assert th_low.s_vib > 0


# ---- against the JAX package ----------------------------------------------

def _random_case(seed, n=6):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n)
    xyz = rng.normal(scale=1.5, size=(n, 3))
    A = rng.normal(size=(3 * n, 3 * n))
    return zs, xyz * 1.8897, (A + A.T) * 0.05


@pytest.mark.parametrize("seed,freeze", [(0, None), (1, [2]), (2, [0, 4]),
                                         (3, [1, 3, 5])])
def test_frequencies_match_jax_random_hessians(seed, freeze):
    zs, xb, H = _random_case(seed)
    vj = j_freqs(H, zs, xb, freeze_idx=freeze)
    vt = frequencies_and_modes(H, zs, xb, freeze_idx=freeze)
    _assert_same_vib(vt, vj)
    assert count_imaginary(vt.freqs_cm) == count_imaginary(vj.freqs_cm)
    if freeze:
        # the active block alone gives the same analysis
        act = np.repeat(~np.isin(np.arange(len(zs)), freeze), 3)
        _assert_same_vib(frequencies_and_modes(H[np.ix_(act, act)], zs, xb,
                                               freeze_idx=freeze), vj)
        wj, mj = j_free_block(H, zs, freeze)
        wt, mt = free_block_modes(H, zs, freeze)
        np.testing.assert_allclose(wt, wj, rtol=0,
                                   atol=1e-12 * np.abs(wj).max())


@pytest.mark.parametrize("freeze", [None, [0], [0, 4]])
def test_frequencies_match_jax_morse(freeze):
    rng = np.random.default_rng(7)
    st = Structure.from_symbols(["C", "H", "H", "O", "H"],
                                rng.normal(scale=0.9, size=(5, 3)),
                                freeze=list(freeze or []))
    H = _calc(st).get_hessian(st.coords_bohr.reshape(-1))["hessian"]
    vj = j_freqs(H, st.numbers, st.coords_bohr, freeze_idx=freeze)
    vt = frequencies_and_modes(H, st.numbers, st.coords_bohr,
                               freeze_idx=freeze)
    assert len(vt.freqs_cm) > 0
    _assert_same_vib(vt, vj)
    # a card run hands the analysis a tensor: the same numbers
    vtt = frequencies_and_modes(torch.as_tensor(H), st.numbers,
                                torch.as_tensor(st.coords_bohr),
                                freeze_idx=freeze)
    np.testing.assert_array_equal(vtt.freqs_cm, vt.freqs_cm)


@pytest.mark.parametrize("freqs,kw", [
    ([1600.0, 3650.0, 3750.0], {}),
    ([-450.0, 12.0, 85.0, 640.0, 1200.0, 3100.0],
     dict(T=350.0, pressure=2e5, multiplicity=2, electronic_energy=-40.1)),
    ([30.0, 3650.0], dict(qrrho_nu0=50.0, scale=0.97, sigma_rot=2)),
])
def test_thermochemistry_matches_jax(freqs, kw):
    rng = np.random.default_rng(4)
    zs = np.array([8, 1, 1, 6])
    xyz = rng.normal(scale=1.0, size=(4, 3))
    tj = j_thermo(freqs, zs, xyz, **kw).as_dict()
    tt = thermochemistry(freqs, zs, xyz, **kw).as_dict()
    assert tt.keys() == tj.keys()
    for k, v in tj.items():
        assert tt[k] == pytest.approx(v, rel=THERMO_TOL, abs=1e-300), k
