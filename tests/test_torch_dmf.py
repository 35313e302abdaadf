"""Port DMF engine (``engines/dmf.py``) and ``mep_mode="dmf"`` in the
workflows against the JAX package's, in float64 on numpy-seeded inputs:

- ``fbenm_interpolate`` to 1e-10 Bohr on the H3 pair and on a six-atom
  pair with padding rows;
- ``dmf_mep`` on the Morse H3 double well with both solvers at
  ``max_cycles`` 60: images to 1e-8 Bohr, energies to 1e-10 Hartree,
  the HEI index and the constraint violation. The heavy-ball solver also
  takes JAX's cycles; the native solver's iteration count is not
  compared: its Armijo test meets the objective's last bits near the
  minimum, where the two packages' sums (and the two builds of the same
  C++) round differently, and a line search that gives up in one ends
  an outer solve an iteration earlier than in the other, on images that
  agree to the bound above;
- twins of ``tests/test_dmf.py`` (the monotone interpolation, the double
  well's barrier, the path against a tight climbing GSM);
- a short escn-test pair with the JAX weights carried across
  (``params_from_jax``) through both packages' ``dmf_mep``;
- ``run_all`` with ``mep_mode="dmf"`` on Morse H3 against the JAX
  pipeline.

Force calls: the port counts every image evaluated (one batch of M a
gradient, M for the final energies); the JAX engine adds
(cycles + 2) x M whatever it evaluated, so its count is not compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.engines import dmf as jd
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.workflows.allflow import run_all as j_run_all
from pdb2reaction_tpu_torch.constants import ANG2BOHR, AU2KCALPERMOL, BOHR2ANG
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.engines import dmf as td
from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.workflows.allflow import run_all

from test_torch_calculator import _pair
from test_torch_native import jax_native

L = 2.4
H3_A = [[0, 0, 0], [0.686, 0, 0], [L, 0, 0]]
H3_B = np.array([[0, 0, 0], [L - 0.686, 0, 0], [L, 0, 0]]) * ANG2BOHR


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the host loops make many small ops, which a
    spinning thread pool slows beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h3():
    jc = JCalculator(JStructure.from_symbols(["H"] * 3, H3_A, freeze=[0, 2]),
                     jpot.make_morse())
    tc = Calculator(Structure.from_symbols(["H"] * 3, H3_A, freeze=[0, 2]),
                    potentials.make_morse(), device="cpu")
    return jc, tc


@pytest.mark.parametrize("system", ["h3", "cluster"])
def test_fbenm_interpolate_matches_jax(system):
    rng = np.random.default_rng(6)
    if system == "h3":
        zs = np.array([1, 1, 1, 0])
        xA = np.vstack([np.asarray(H3_A, float) * ANG2BOHR, np.zeros(3)])
        xB = np.vstack([H3_B, np.zeros(3)])
    else:                       # six atoms and two padding rows
        zs = np.array([6, 1, 8, 6, 1, 1, 0, 0])
        xA = np.zeros((8, 3))
        xA[:6] = rng.normal(scale=1.6, size=(6, 3))
        xB = xA.copy()
        xB[:6] += 0.3 * rng.normal(size=(6, 3))
    mask = (zs > 0).astype(np.float32)
    it = td.fbenm_interpolate(torch.as_tensor(xA), torch.as_tensor(xB), 8,
                              torch.as_tensor(zs), torch.as_tensor(mask),
                              cycles=50).numpy()
    ij = np.asarray(jd.fbenm_interpolate(
        jnp.asarray(xA), jnp.asarray(xB), 8, zs, mask, cycles=50))
    assert it.shape == ij.shape == (8,) + xA.shape
    assert np.abs(it - ij).max() <= 1e-10
    assert np.array_equal(it[0], xA) and np.array_equal(it[-1], xB)
    if system == "h3":
        assert np.all(np.diff(it[:, 1, 0]) > 0)   # the middle H moves on


@pytest.mark.parametrize("solver", ["device", "native"])
def test_dmf_morse_matches_jax(solver):
    if solver == "native":
        jax_native()
    jc, tc = _h3()
    kw = dict(n_images=10, max_cycles=60, solver=solver)
    rj = jd.dmf_mep(jc, jc.pad_bohr(jc.structure.coords_bohr),
                    jc.pad_bohr(H3_B), **kw)
    rt = td.dmf_mep(tc, tc.pad_bohr(tc.structure.coords_bohr),
                    tc.pad_bohr(H3_B), **kw)
    assert rt.images.shape == np.asarray(rj.images).shape
    assert np.abs(rt.images - np.asarray(rj.images)).max() <= 1e-8
    assert np.abs(rt.energies - rj.energies).max() <= 1e-10
    assert rt.hei_idx == rj.hei_idx and 0 < rt.hei_idx < 9
    assert abs(rt.constraint_violation - rj.constraint_violation) <= 1e-8
    assert rt.force_calls == tc.force_calls
    if solver == "device":
        assert rt.cycles == rj.cycles == 60
        assert rt.converged == rj.converged
        assert rt.force_calls == (rt.cycles + 1) * 10
    else:
        # a batch of 10 a callback, at least one a solver iteration
        assert rt.force_calls % 10 == 0
        assert rt.force_calls >= (rt.cycles + 1) * 10
    # the frozen end atoms stay where the interpolation put them
    start = td.fbenm_interpolate(tc.pad_bohr(tc.structure.coords_bohr),
                                 tc.pad_bohr(H3_B), 10, tc.system.numbers,
                                 tc.system.atom_mask).numpy()
    assert np.array_equal(rt.images[:, [0, 2]], start[:, [0, 2]])


def test_dmf_double_well_barrier():
    """Twin of tests/test_dmf.py:31."""
    _, tc = _h3()
    res = td.dmf_mep(tc, tc.pad_bohr(tc.structure.coords_bohr),
                     tc.pad_bohr(H3_B), n_images=10, max_cycles=400)
    E, hei = res.energies, res.hei_idx
    assert 0 < hei < len(E) - 1
    assert res.images[hei][1, 0] * BOHR2ANG == pytest.approx(L / 2,
                                                             abs=0.12)
    assert (E[hei] - E[0]) * AU2KCALPERMOL == pytest.approx(11.1, abs=1.5)


def test_port_dmf_path_quality_vs_tight_gsm():
    """Twin of tests/test_dmf.py:46: the barrier within 0.5 kcal/mol of a
    tight climbing GSM's, and the equal-spacing constraints met to 5% of
    the mean segment."""
    _, tc = _h3()
    xA, xB = tc.pad_bohr(tc.structure.coords_bohr), tc.pad_bohr(H3_B)
    gs = gsm_mep(tc.au_energy_force_batch_fn(), xA, xB,
                 tc.system.free_mask, max_nodes=10, max_cycles=500,
                 conv_perp_rms=1e-5, climb=True, hvp_fn=tc.au_hvp_fn())
    dm = td.dmf_mep(tc, xA, xB, n_images=12, max_cycles=600)
    e_gsm = gs.energies[gs.hei_idx] - gs.energies[0]
    e_dmf = dm.energies[dm.hei_idx] - dm.energies[0]
    assert abs(e_gsm - e_dmf) < 8e-4, (e_gsm, e_dmf)
    seglen = np.sqrt(((dm.images[1:] - dm.images[:-1]) ** 2).sum(axis=(1,
                                                                     2)))
    assert dm.constraint_violation < 0.05 * seglen.mean()


def test_dmf_escn_test_matches_jax():
    """escn-test, 6 atoms, atom 0 frozen, the JAX weights carried
    across: 12 heavy-ball steps of 5 images."""
    jc, tc, cb = _pair(freeze=[0], seed=8, n=6)
    xA = cb.reshape(-1, 3)
    xB = xA + 0.2 * np.random.default_rng(9).normal(size=xA.shape)
    xB[0] = xA[0]
    kw = dict(n_images=5, max_cycles=12, fbenm_cycles=20)
    rj = jd.dmf_mep(jc, jc.pad_bohr(xA), jc.pad_bohr(xB), **kw)
    rt = td.dmf_mep(tc, tc.pad_bohr(xA), tc.pad_bohr(xB), **kw)
    assert rt.cycles == rj.cycles == 12 and rt.hei_idx == rj.hei_idx
    assert np.abs(rt.images - np.asarray(rj.images)).max() <= 1e-8
    assert np.abs(rt.energies - rj.energies).max() <= 1e-8
    assert rt.force_calls == tc.force_calls == 13 * 5
    assert np.all(rt.images[:, 0] == tc.pad_bohr(xA).numpy()[0])


def test_run_all_dmf_matches_jax(tmp_path):
    """``all`` on two H3 .xyz inputs with DMF segments (stage 4 off):
    the same segments, HEIs and energies as the JAX pipeline."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text("3\nR\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n")
    b.write_text("3\nP\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n")
    kw = dict(charge=0, calc_mode="morse", freeze_atoms=[0, 2],
              mep_mode="dmf", verbose=False, preopt=False,
              search_kw={"max_depth": 0}, n_images=7)
    rj = j_run_all([a, b], out_dir=tmp_path / "jax", **kw)
    rt = run_all([a, b], out_dir=tmp_path / "port", device="cpu", **kw)
    pj, pt = rj["path"]["segments"], rt["path"]["segments"]
    assert len(pt) == len(pj) >= 1
    for st, sj in zip(pt, pj):
        for k in ("kind", "reactive", "barrier_kcal", "delta_e_kcal",
                  "bond_changes", "converged"):
            assert st[k] == sj[k], k
        for k in ("e_start_au", "e_ts_au", "e_end_au"):
            assert abs(st[k] - sj[k]) <= 1e-10, k
    for f in ("summary.yaml", "stage2_path/mep.trj",
              "stage2_path/seg_000_mep/final_geometries.trj"):
        assert (tmp_path / "port" / f).exists(), f
