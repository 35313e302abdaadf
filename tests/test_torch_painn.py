"""Port PaiNN-class model (mlip/model.py) against the JAX package's
``make_model`` with the same weights carried across (``from_jax``):

- dense and gather modes in f64: forces to 1e-9 relative, energy to
  1e-9 relative plus the float32 rounding of the readout sum (both
  packages sum the per-atom energies in float32, JAX model.py:184-185,
  and the two frameworks order that sum differently);
- pallas mode (K5's plain version on the CPU) in f32 against JAX's
  ``energy_fn_pallas`` (its jnp reference on the CPU) to 1e-5 relative,
  and against the port's own dense mode in f64;
- ``make_uma_calculator(model="small", device="cpu")`` against the JAX
  calculator in Hartree/Bohr;
- the ``opt`` CLI with no ``--model`` runs uma-s-1p1 on the CPU.

Configurations: ``small`` and ``uma-s-1p1`` narrowed to hidden 32, two
layers."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.core.structure import pad_to as jpad_to
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.model import CONFIGS as JCFG
from pdb2reaction_tpu.mlip.model import make_model as j_make_model
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import model as tm
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

REPO = Path(__file__).resolve().parents[1]
# a few float32 ulps: the readout sums per-atom energies in float32
F32_SUM = 8 * float(np.finfo(np.float32).eps)
CASES = [("small", {}), ("uma-s-1p1", dict(hidden=32, n_layers=2))]


def jax_painn(name, jdt, seed=0, charge=0, spin=1, **over):
    """(numpy weights with every float perturbed, JAX config)."""
    cfg = dataclasses.replace(JCFG[name], dtype=jdt, **over)
    _, p, cfg = j_make_model(cfg, seed=seed, charge=charge, spin=spin)
    rng = np.random.default_rng(seed + 50)
    p = jtu.tree_map(np.asarray, p)
    p = jtu.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim > 0 and a.dtype.kind == "f" else a, p)
    return p, cfg


def molecule(n, seed):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n).astype(np.int32)
    return zs, rng.normal(scale=1.6, size=(n, 3))


def jax_ef(p_np, cfg, zs, xyz, n_pad, mp_mode):
    from pdb2reaction_tpu.mlip.model import energy_fn
    cfg = dataclasses.replace(cfg, mp_mode=mp_mode)
    sysp = jpad_to(JStructure(zs, xyz), n_pad=n_pad)
    p = jtu.tree_map(jnp.asarray, p_np)
    c0 = jnp.asarray(sysp.coords)
    if mp_mode == "pallas":
        c0 = c0.astype(jnp.float32)
    e, g = jax.value_and_grad(lambda c: energy_fn(c, sysp, p, cfg))(c0)
    return float(e), -np.asarray(g, dtype=np.float64)


def torch_ef(p_np, name, tdt, zs, xyz, n_pad, mp_mode, coords_dt=None,
             **over):
    cfg = dataclasses.replace(tm.CONFIGS[name], dtype=tdt, mp_mode=mp_mode,
                              **over)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    c = sysp.coords.to(coords_dt or tdt).clone().requires_grad_(True)
    params = params_from_jax(p_np, dtype=tdt)
    e = tm.energy_fn(c, sysp, params, cfg)
    (g,) = torch.autograd.grad(e, c)
    return e.detach(), -g.double().numpy()


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() \
        / max(np.abs(np.asarray(b)).max(), 1e-30)


@pytest.mark.parametrize("mp_mode", ["dense", "gather"])
@pytest.mark.parametrize("name,over", CASES)
def test_dense_gather_match_jax_f64(mp_mode, name, over):
    p, cfg = jax_painn(name, jnp.float64, seed=2, charge=-1, spin=2, **over)
    zs, xyz = molecule(9, seed=4)
    e_j, f_j = jax_ef(p, cfg, zs, xyz, 16, mp_mode)
    e_t, f_t = torch_ef(p, name, torch.float64, zs, xyz, 16, mp_mode,
                        **over)
    assert e_t.dtype == torch.float64
    assert abs(float(e_t) - e_j) <= (1e-9 + F32_SUM) * abs(e_j)
    assert _rel(f_t, f_j) <= 1e-9
    assert np.all(f_t[9:] == 0.0)                 # padding rows


@pytest.mark.parametrize("name,over", CASES)
def test_pallas_mode_matches_jax_f32_and_dense(name, over):
    p, cfg = jax_painn(name, jnp.float32, seed=5, **over)
    zs, xyz = molecule(11, seed=6)
    e_j, f_j = jax_ef(p, cfg, zs, xyz, 13, "pallas")
    e_t, f_t = torch_ef(p, name, torch.float32, zs, xyz, 13, "pallas",
                        **over)
    assert e_t.dtype == torch.float32
    assert abs(float(e_t) - e_j) <= 1e-5 * abs(e_j)
    assert _rel(f_t, f_j) <= 1e-5
    # the same weights in the port's dense mode, f64
    p64 = jtu.tree_map(lambda a: a.astype(np.float64)
                       if a.dtype.kind == "f" else a, p)
    e_d, f_d = torch_ef(p64, name, torch.float64, zs, xyz, 13, "dense",
                        **over)
    assert abs(float(e_t) - float(e_d)) <= 1e-5 * abs(float(e_d))
    assert _rel(f_t, f_d) <= 1e-5


def test_remat_layers_gives_the_same_forces():
    p, _ = jax_painn("small", jnp.float64, seed=7)
    zs, xyz = molecule(6, seed=2)
    e0, f0 = torch_ef(p, "small", torch.float64, zs, xyz, 8, "dense")
    e1, f1 = torch_ef(p, "small", torch.float64, zs, xyz, 8, "dense",
                      remat_layers=True)
    assert abs(float(e1) - float(e0)) <= 1e-12 * abs(float(e0))
    assert _rel(f1, f0) <= 1e-12


def test_pallas_mode_f64_coords_give_f64_energy():
    p, _ = jax_painn("small", jnp.float32, seed=1)
    zs, xyz = molecule(5, seed=1)
    e, f = torch_ef(p, "small", torch.float32, zs, xyz, 8, "pallas",
                    coords_dt=torch.float64)
    assert e.dtype == torch.float64 and np.all(np.isfinite(f))


def test_calculator_small_matches_jax():
    p, cfg = jax_painn("small", jnp.float64, seed=3, charge=1, spin=1)
    zs, xyz = molecule(7, seed=8)
    jfn, _, _ = j_make_model(cfg)
    jcalc = JCalculator(JStructure(zs, xyz), jfn,
                        params=jtu.tree_map(jnp.asarray, p),
                        freeze_atoms=[2])
    tcalc = make_uma_calculator(Structure(zs, xyz), model="small", charge=1,
                                spin=1, freeze_atoms=[2], device="cpu",
                                dtype=torch.float64,
                                params=params_from_jax(p),
                                weights_source="from_jax")
    cb = Structure(zs, xyz).coords_bohr.reshape(-1)
    rj, rt = jcalc.get_forces(cb), tcalc.get_forces(cb)
    assert abs(rj["energy"] - rt["energy"]) \
        <= (1e-9 + F32_SUM) * abs(rj["energy"])
    assert np.abs(rj["forces"] - rt["forces"]).max() \
        <= 1e-9 * np.abs(rj["forces"]).max()
    assert np.all(rt["forces"].reshape(-1, 3)[2] == 0.0)
    assert tcalc.cfg.mp_mode == "dense" and tcalc.force_calls == 1


def test_default_model_is_uma_s_1p1(capsys):
    st = Structure(np.array([8, 1, 1], np.int32),
                   [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    calc = make_uma_calculator(st, device="cpu")
    assert calc.cfg == tm.CONFIGS["uma-s-1p1"]
    assert "SURROGATE" in capsys.readouterr().err
    r = calc.get_forces(st.coords_bohr.reshape(-1))
    assert np.all(np.isfinite(r["forces"])) and np.isfinite(r["energy"])
    # atom-axis sharding needs a process group of that many ranks
    with pytest.raises(RuntimeError, match="torchrun"):
        make_uma_calculator(st, device="cpu", spatial=2)


def test_opt_cli_default_model_runs_uma_s_1p1(tmp_path):
    xyz = tmp_path / "x.xyz"
    xyz.write_text("4\n\nO 0.0 0.0 0.0\nH 0.97 0.05 0.0\nH -0.2 0.95 0.0\n"
                   "C 0.3 -0.4 1.4\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "opt", "-i",
         str(xyz), "--device", "cpu", "--max-cycles", "2", "-q", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode in (0, 3), r.stderr
    assert "model 'uma-s-1p1'" in r.stderr       # the surrogate warning
    assert "uma-s-1p1" in r.stdout
    out = tmp_path / "result_opt" / "final_geometry.xyz"
    assert out.exists() and out.read_text().splitlines()[0] == "4"
