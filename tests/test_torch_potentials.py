"""Port analytic potentials (``mlip/potentials.py``) and the pieces of
``core`` they and the path workflow use, against the JAX package on the
same seeded inputs in float64:

- Morse, LJ and harmonic-well energies (eV) and forces through the
  Calculator (Hartree/Bohr) to 1e-12 relative, padding and frozen atoms
  included;
- ``workflows.common.make_calculator`` for ``calc_mode`` morse and lj;
- ``pairwise_distances``, ``write_trj`` and ``parse_energy_comment``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.core import io_xyz as j_io
from pdb2reaction_tpu.core.neighbors import pairwise_distances as j_pdist
from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.core.structure import pad_to as jpad_to
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.workflows import common as j_common
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.neighbors import pairwise_distances
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.workflows import common

REL = 1e-12


def molecule(n, seed, scale=1.2):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n).astype(np.int32)
    return zs, rng.normal(scale=scale, size=(n, 3))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


POTS = [("morse", {}), ("morse", dict(De=2.5, a=1.3, re_scale=1.1)),
        ("lj", {}), ("lj", dict(epsilon=0.3, sigma=1.9))]


@pytest.mark.parametrize("name,kw", POTS)
@pytest.mark.parametrize("n,n_pad,seed", [(5, 8, 0), (9, 16, 1)])
def test_potential_energy_and_grad_match_jax(name, kw, n, n_pad, seed):
    zs, xyz = molecule(n, seed)
    jsys = jpad_to(JStructure(zs, xyz), n_pad=n_pad)
    tsys = pad_to(Structure(zs, xyz), n_pad=n_pad)
    jfn = getattr(jpot, f"make_{name}")(**kw)
    tfn = getattr(potentials, f"make_{name}")(**kw)
    import jax
    e_j, g_j = jax.value_and_grad(lambda c: jfn(c, jsys))(
        jnp.asarray(jsys.coords))
    c = tsys.coords.clone().requires_grad_(True)
    e_t = tfn(c, tsys, None)
    (g_t,) = torch.autograd.grad(e_t, c)
    assert _rel(float(e_t.detach()), float(e_j)) <= REL
    assert _rel(g_t.numpy(), np.asarray(g_j)) <= REL
    assert np.all(g_t.numpy()[n:] == 0.0)          # padding rows


def test_harmonic_wells_match_jax():
    zs, xyz = molecule(6, 3)
    centers = np.random.default_rng(4).normal(size=(8, 3))
    jsys = jpad_to(JStructure(zs, xyz), n_pad=8)
    tsys = pad_to(Structure(zs, xyz), n_pad=8)
    e_j = float(jpot.harmonic_wells(jnp.asarray(jsys.coords), jsys,
                                    jnp.asarray(centers), k=3.0))
    e_t = float(potentials.harmonic_wells(tsys.coords, tsys,
                                          torch.as_tensor(centers), k=3.0))
    assert _rel(e_t, e_j) <= REL


@pytest.mark.parametrize("mode", ["morse", "lj"])
def test_make_calculator_potentials_match_jax(mode):
    """``calc_mode`` morse/lj: energies and forces in Hartree/Bohr with a
    frozen atom, and every evaluation counted."""
    zs, xyz = molecule(7, 5)
    jst = JStructure(zs, xyz, freeze=[2])
    tst = Structure(zs, xyz, freeze=[2])
    jc = j_common.make_calculator(jst, calc_mode=mode, freeze_atoms=[2])
    tc = common.make_calculator(tst, calc_mode=mode, freeze_atoms=[2],
                                device="cpu", hessian_calc_mode="auto",
                                spatial=1)
    assert tc.hessian_calc_mode == "Analytical"
    cb = tst.coords_bohr.reshape(-1)
    rj, rt = jc.get_forces(cb), tc.get_forces(cb)
    assert _rel(rt["energy"], rj["energy"]) <= REL
    assert _rel(rt["forces"], rj["forces"]) <= REL
    assert np.all(rt["forces"][6:9] == 0.0)
    assert tc.get_energy(cb)["energy"] == pytest.approx(rt["energy"],
                                                       rel=1e-15)
    rng = np.random.default_rng(0)
    batch = np.stack([cb, cb + 0.02 * rng.normal(size=cb.shape)])
    rb_j, rb_t = jc.get_forces_batch(batch), tc.get_forces_batch(batch)
    assert _rel(rb_t["forces"], rb_j["forces"]) <= REL
    assert tc.force_calls == 3
    with pytest.raises(ValueError, match="calc mode"):
        common.make_calculator(tst, calc_mode="xtb", device="cpu")
    # the analytic potentials do not shard: spatial > 1 is refused
    with pytest.raises(ValueError, match="spatial"):
        common.make_calculator(tst, calc_mode=mode, device="cpu", spatial=2)


def test_morse_minimum_and_fd_forces():
    """The JAX package's own Morse checks on the port: E = -De at the
    covalent-radius sum with zero forces; forces match central
    differences of the energy."""
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [2 * 0.32, 0, 0]])
    calc = Calculator(st, potentials.make_morse(De=4.0, a=2.0),
                      device="cpu")
    res = calc.get_forces(st.coords_bohr.reshape(-1))
    assert res["energy"] == pytest.approx(-4.0 / 27.211386245988, rel=1e-9)
    np.testing.assert_allclose(res["forces"], 0.0, atol=1e-12)
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.8, 0.1, 0]])
    calc = Calculator(st, potentials.make_morse(), device="cpu")
    x0 = st.coords_bohr.reshape(-1)
    f = calc.get_forces(x0)["forces"]
    eps = 1e-5
    for k in range(6):
        xp, xm = x0.copy(), x0.copy()
        xp[k] += eps
        xm[k] -= eps
        fd = -(calc.get_energy(xp)["energy"]
               - calc.get_energy(xm)["energy"]) / (2 * eps)
        assert f[k] == pytest.approx(fd, abs=1e-8)


def test_pairwise_distances_match_jax():
    _, xyz = molecule(11, 7)
    xyz[3] = xyz[4]                               # a zero distance
    d_j = np.asarray(j_pdist(jnp.asarray(xyz)))
    d_t = pairwise_distances(torch.as_tensor(xyz)).numpy()
    assert _rel(d_t, d_j) <= REL


def test_trj_and_energy_comment_match_jax(tmp_path):
    zs, xyz = molecule(4, 8)
    frames_t = [Structure(zs, xyz + k) for k in range(3)]
    frames_j = [JStructure(zs, xyz + k) for k in range(3)]
    E = [-1.25, -1.5, 0.125]
    io_xyz.write_trj(tmp_path / "t.trj", frames_t, energies=E)
    j_io.write_trj(tmp_path / "j.trj", frames_j, energies=E)
    assert (tmp_path / "t.trj").read_text() == \
        (tmp_path / "j.trj").read_text()
    back = io_xyz.read_xyz_frames(tmp_path / "t.trj")
    assert [io_xyz.parse_energy_comment(f.comment) for f in back] == E
    for c in ("-76.4", "E = -1.5e-3 Ha", "energy: 2", "step 3 x", "", "a b"):
        assert io_xyz.parse_energy_comment(c) == j_io.parse_energy_comment(c)
