"""Port Calculator (make_uma_calculator, escn-test, CPU, f64, JAX weights
carried across) against the JAX Calculator over the same weights."""


import numpy as np
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

from test_torch_escn import jax_weights_np


def _pair(freeze=(), charge=0, spin=1, seed=0, n=7):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 8], size=n).astype(np.int32)
    xyz = rng.normal(scale=1.4, size=(n, 3))
    p, cfg = jax_weights_np("escn-test", jnp.float64, seed=seed,
                            charge=charge, spin=spin)
    jp = j_premerge(jtu.tree_map(jnp.asarray, p), cfg)
    jcalc = JCalculator(JStructure(zs, xyz), ESCN_FN_FOR(cfg), params=jp,
                        freeze_atoms=list(freeze))
    tcalc = make_uma_calculator(
        Structure(zs, xyz), model="escn-test", charge=charge, spin=spin,
        freeze_atoms=list(freeze), device="cpu", dtype=torch.float64,
        params=params_from_jax(p), weights_source="from_jax")
    return jcalc, tcalc, Structure(zs, xyz).coords_bohr.reshape(-1)


@pytest.mark.parametrize("charge,spin", [(0, 1), (-1, 2)])
def test_calculator_matches_jax_f64(charge, spin):
    jcalc, tcalc, cb = _pair(charge=charge, spin=spin, seed=charge + 3)
    rj, rt = jcalc.get_forces(cb), tcalc.get_forces(cb)
    assert abs(rj["energy"] - rt["energy"]) < 1e-8
    assert np.abs(rj["forces"] - rt["forces"]).max() < 1e-7
    assert abs(tcalc.get_energy(cb)["energy"] - rt["energy"]) < 1e-12
    assert tcalc.weights_source == "from_jax"


def test_frozen_counts_and_batch():
    jcalc, tcalc, cb = _pair(freeze=[0, 3], seed=5)
    r = tcalc.get_forces(cb)
    f = r["forces"].reshape(-1, 3)
    assert np.all(f[[0, 3]] == 0.0) and np.any(f[1] != 0.0)
    np.testing.assert_allclose(r["forces"], jcalc.get_forces(cb)["forces"],
                               atol=1e-7)
    assert tcalc.force_calls == 1
    rng = np.random.default_rng(0)
    batch = np.stack([cb, cb + 0.01 * rng.normal(size=cb.shape)])
    rb = tcalc.get_forces_batch(batch)
    assert tcalc.force_calls == 3
    assert abs(rb["energy"][0] - r["energy"]) < 1e-12
    np.testing.assert_allclose(rb["forces"][0], r["forces"], atol=1e-12)
    np.testing.assert_allclose(rb["forces"][1],
                               tcalc.get_forces(batch[1])["forces"],
                               atol=1e-12)
    fn = tcalc.au_energy_force_fn()
    e, fp = fn(tcalc.pad_bohr(cb))
    assert abs(e - r["energy"]) < 1e-12 and tcalc.force_calls == 5
    np.testing.assert_allclose(tcalc.unpad(fp).reshape(-1), r["forces"],
                               atol=1e-12)
    # the Hessian is ported: symmetric, frozen rows and columns zero, and
    # one force call beside it
    H = tcalc.get_hessian(cb)["hessian"]
    assert H.shape == (cb.size, cb.size) and tcalc.force_calls == 6
    np.testing.assert_allclose(H, H.T, rtol=0, atol=1e-12)
    frozen = ~tcalc.free_dof_mask
    assert np.all(H[frozen] == 0.0) and np.all(H[:, frozen] == 0.0)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    st = Structure(np.array([1, 1], np.int32), [[0, 0, 0], [0.7, 0, 0]])
    with pytest.raises(RuntimeError, match="cuda"):
        make_uma_calculator(st, model="escn-test")      # default: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        make_uma_calculator(st, model="uma-s-1p1")      # default: cuda


def test_seeded_surrogate_is_deterministic(capsys):
    st = Structure(np.array([8, 1, 1], np.int32),
                   [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    a = make_uma_calculator(st, model="escn-test", device="cpu", seed=3)
    b = make_uma_calculator(st, model="escn-test", device="cpu", seed=3)
    assert "SURROGATE" in capsys.readouterr().err
    assert a.weights_source.startswith("surrogate-seeded")
    cb = st.coords_bohr.reshape(-1)
    assert a.get_forces(cb)["energy"] == b.get_forces(cb)["energy"]
