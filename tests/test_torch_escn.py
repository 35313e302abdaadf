"""Port eSCN energy and forces (plain path, CPU) against the JAX
package's ``escn_energy`` (XLA path) with the same weights carried
across: f64 to 1e-6 eV/atom and 1e-6 eV/Angstrom, f32 to 1e-5 relative."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.core.structure import pad_to as jpad_to
from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn import make_escn_model
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS as TCFG
from pdb2reaction_tpu_torch.mlip.escn import escn_energy
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax


def jax_weights_np(name, jdt, seed=0, charge=0, spin=1, **over):
    """JAX eSCN weights with every float perturbed (non-zero biases), as a
    numpy tree; also returns the JAX config."""
    cfg = dataclasses.replace(JCFG[name], dtype=jdt, **over)
    _, p, cfg = make_escn_model(cfg, seed=seed, charge=charge, spin=spin)
    rng = np.random.default_rng(seed + 100)
    p = jtu.tree_map(np.asarray, p)
    p = jtu.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim > 0 and a.dtype.kind == "f" else a, p)
    return p, cfg


def cluster(n, n_pad, seed):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n).astype(np.int32)
    return zs, rng.normal(scale=1.5, size=(n, 3)), n_pad


def jax_energy_forces(p_np, cfg, zs, xyz, n_pad):
    from pdb2reaction_tpu.mlip.escn import escn_energy as j_energy
    sysp = jpad_to(JStructure(zs, xyz), n_pad=n_pad)
    p = jtu.tree_map(jnp.asarray, p_np)
    e, g = jax.jit(jax.value_and_grad(lambda c: j_energy(c, sysp, p, cfg)))(
        jnp.asarray(sysp.coords))
    return float(e), -np.asarray(g)


def torch_energy_forces(p_np, name, tdt, zs, xyz, n_pad, **over):
    cfg = dataclasses.replace(TCFG[name], dtype=tdt, **over)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    c = sysp.coords.clone().requires_grad_(True)
    e = escn_energy(c, sysp, params_from_jax(p_np, dtype=tdt), cfg)
    (g,) = torch.autograd.grad(e, c)
    return float(e), -g.numpy()


@pytest.mark.parametrize("premerged", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_escn_f64_matches_jax(premerged, seed):
    p, cfg = jax_weights_np("escn-test", jnp.float64, seed=seed, charge=-1,
                            spin=2)
    if premerged:
        p = jtu.tree_map(np.asarray,
                         j_premerge(jtu.tree_map(jnp.asarray, p), cfg))
    zs, xyz, n_pad = cluster(9, 16, seed)
    e_j, f_j = jax_energy_forces(p, cfg, zs, xyz, n_pad)
    e_t, f_t = torch_energy_forces(p, "escn-test", torch.float64, zs, xyz,
                                   n_pad)
    assert abs(e_j - e_t) / len(zs) < 1e-6
    assert np.abs(f_j - f_t).max() < 1e-6
    assert np.abs(f_t[len(zs):]).max() == 0.0      # padding rows


def test_escn_f32_matches_jax():
    p, cfg = jax_weights_np("escn-test", jnp.float32, seed=2)
    zs, xyz, n_pad = cluster(12, 16, 2)
    e_j, f_j = jax_energy_forces(p, cfg, zs, xyz, n_pad)
    e_t, f_t = torch_energy_forces(p, "escn-test", torch.float32, zs, xyz,
                                   n_pad)
    assert abs(e_j - e_t) <= 1e-5 * max(1.0, abs(e_j))
    assert np.abs(f_j - f_t).max() <= 1e-5 * max(1.0, np.abs(f_j).max())


@pytest.mark.slow
def test_escn_md_width_f64_matches_jax():
    """escn-md at full width (lmax=4, mmax=2, C=h=128), two layers."""
    p, cfg = jax_weights_np("escn-md", jnp.float64, seed=3, num_layers=2)
    zs, xyz, n_pad = cluster(10, 16, 3)
    e_j, f_j = jax_energy_forces(p, cfg, zs, xyz, n_pad)
    e_t, f_t = torch_energy_forces(p, "escn-md", torch.float64, zs, xyz,
                                   n_pad, num_layers=2)
    assert abs(e_j - e_t) / len(zs) < 1e-6
    assert np.abs(f_j - f_t).max() < 1e-6


def test_unported_branches_raise():
    zs, xyz, n_pad = cluster(4, 8, 0)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    for name in ("escn-s", "escn-test-gate"):
        from pdb2reaction_tpu_torch.mlip.escn import init_escn_params
        cfg = TCFG[name]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            escn_energy(sysp.coords, sysp, init_escn_params(cfg), cfg)
