"""Every branch of the eSCN backbone against the JAX package's
``escn_energy`` in float64 on the CPU, with the same weights carried
across by ``from_jax``:

- the gate edge activation (escn-test-gate), the full layout (escn-s
  narrowed to escn-test's widths), ``remat_blocks`` and
  ``edge_grid_scale=3`` on "xla", in the default kernel layout (plain on
  CPU tensors) and, where the plain edge path differs (the S2 reduced
  configurations: plain K1 against the plain reduced path), in "xla":
  energy and forces within rtol 1e-10;
- the twin of tests/test_escn.py:83-132: exact translation and padding
  invariance (1e-12), rotation within the JAX test's tolerances (gate
  5e-5, s2 1e-1: the per-edge S2 grid aliases at fairchem's
  resolution), and ``edge_grid_scale=3`` shrinking the s2 rotation error
  50-fold;
- the analytic Hessian and HVPs of the gate and full configurations and
  through ``remat_blocks`` via ``make_uma_calculator`` against the JAX
  Calculator's, 1e-10 x max|H|, and the Hessian closure being the
  all-plain variant; escn-md-gate at full width (one layer) through the
  factory;
- rank 0's first-layer K3 inputs under a shard (sources gathered from
  all rows) against the unsharded call's;
- the edge path each configuration takes (``edge_route``) and the
  refusals of ``check_edge_kernel``."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR, make_escn_model
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import escn as tescn
from pdb2reaction_tpu_torch.mlip.escn import (ESCN_CONFIGS, check_edge_kernel,
                                              edge_route, escn_energy,
                                              first_layer_kernel_args,
                                              init_escn_params)
from pdb2reaction_tpu_torch.mlip.escn_edge_kernel import \
    fused_edge_block_plain
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

from test_torch_escn import (cluster, jax_energy_forces, jax_weights_np,
                             torch_energy_forces)
from test_torch_hessian import _hvps

RTOL = 1e-10
# escn-s (lmax = mmax = 2) at escn-test's widths and depth
NARROW = dict(sphere_channels=8, hidden_channels=8, edge_channels=8,
              ffn_hidden=16, num_experts=2, route_dim=4, num_gauss=8,
              max_neighbors=16)
CASES = {
    "gate": ("escn-test-gate", {}),
    "full": ("escn-s", NARROW),
    "remat": ("escn-test", dict(remat_blocks=True)),
    "full-remat": ("escn-s", dict(NARROW, remat_blocks=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_side(name, jover, seed, n, n_pad):
    """JAX weights and its XLA path's (its ``edge_kernel`` default)
    energy and forces, once per configuration (both layouts of a case
    compare against the same)."""
    p, cfg = jax_weights_np(name, jnp.float64, seed=seed, charge=-1, spin=2,
                            **dict(jover))
    zs, xyz, n_pad = cluster(n, n_pad, seed)
    return p, (zs, xyz, n_pad), jax_energy_forces(p, cfg, zs, xyz, n_pad)


def _match(name, over, seed, n=9, n_pad=16):
    """The port in ``over`` against the JAX package's XLA path on the
    same weights."""
    jover = tuple(sorted((k, v) for k, v in over.items()
                         if k != "edge_kernel"))
    p, (zs, xyz, n_pad), (e_j, f_j) = _jax_side(name, jover, seed, n, n_pad)
    e_t, f_t = torch_energy_forces(p, name, torch.float64, zs, xyz, n_pad,
                                   **over)
    assert abs(e_t - e_j) <= RTOL * abs(e_j)
    assert np.abs(f_t - f_j).max() <= RTOL * np.abs(f_j).max()
    assert np.abs(f_t[n:]).max() == 0.0            # padding rows
    return e_t


# the gate and full configurations take the same plain edge path and
# node FFN on CPU tensors in every layout, so one layout stands for all
@pytest.mark.parametrize("case,layout", [
    ("gate", "pallas-mega"), ("full", "pallas-mega"),
    ("remat", "pallas-mega"), ("remat", "xla"),
    ("full-remat", "pallas-mega")])
def test_branch_f64_matches_jax(case, layout):
    name, over = CASES[case]
    _match(name, dict(over, edge_kernel=layout), seed=1)


def test_edge_grid_scale_on_xla_matches_jax():
    e3 = _match("escn-test", dict(edge_kernel="xla", edge_grid_scale=3),
                seed=2)
    p, (zs, xyz, n_pad), _ = _jax_side("escn-test",
                                       (("edge_grid_scale", 3),), 2, 9, 16)
    e1, _ = torch_energy_forces(p, "escn-test", torch.float64, zs, xyz,
                                n_pad, edge_kernel="xla")
    assert e3 != e1                     # the oversampled grid is in use


# ---------------------------------------------------------------------------
# symmetries: the twin of tests/test_escn.py:83-132
# ---------------------------------------------------------------------------

def _random_rot(rng):
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _energy_grad(cfg, sysp, params, coords):
    c = torch.as_tensor(coords, dtype=torch.float64).requires_grad_(True)
    e = escn_energy(c, sysp, params, cfg)
    (g,) = torch.autograd.grad(e, c)
    return float(e.detach()), g.numpy()


@pytest.mark.parametrize("name,rot_tol", [("escn-test-gate", 5e-5),
                                          ("escn-test", 1e-1)])
def test_torch_escn_symmetries(name, rot_tol):
    rng = np.random.default_rng(3)
    zs = np.array([8, 1, 1, 6, 1, 1], np.int32)
    st = Structure(zs, rng.normal(scale=1.4, size=(6, 3)))
    sysp = pad_to(st, n_pad=10)
    _, jp, _ = make_escn_model(dataclasses.replace(JCFG[name],
                                                   dtype=jnp.float64), seed=0)
    params = params_from_jax(jtu.tree_map(np.asarray, jp))
    cfg = dataclasses.replace(ESCN_CONFIGS[name], dtype=torch.float64)
    rng = np.random.default_rng(4)
    c0 = sysp.coords.numpy()
    e0, g0 = _energy_grad(cfg, sysp, params, c0)
    # exact translation and padding invariance
    assert abs(e0 - _energy_grad(cfg, sysp, params, c0 + 3.3)[0]) < 1e-12
    cpad = c0.copy()
    cpad[st.n_atoms:] += 2.5
    assert abs(e0 - _energy_grad(cfg, sysp, params, cpad)[0]) < 1e-12
    Q = _random_rot(rng)
    e_r, g_r = _energy_grad(cfg, sysp, params, c0 @ Q.T)
    rot_err = abs(e0 - e_r)
    assert rot_err < rot_tol
    assert np.abs(g_r - g0 @ Q.T).max() < rot_tol
    if name == "escn-test":
        # the s2 rotation error is grid aliasing, not a bug: tripling the
        # edge grid's resolution shrinks it at least 50-fold
        cfg3 = dataclasses.replace(cfg, edge_kernel="xla", edge_grid_scale=3)
        err3 = abs(_energy_grad(cfg3, sysp, params, c0)[0]
                   - _energy_grad(cfg3, sysp, params, c0 @ Q.T)[0])
        assert err3 < max(rot_err / 50.0, 1e-10), (rot_err, err3)


# ---------------------------------------------------------------------------
# Hessians and HVPs through make_uma_calculator
# ---------------------------------------------------------------------------

def _calc_pair(name, over, monkeypatch):
    """The JAX Calculator and the port's factory calculator on the same
    weights (premerged on the JAX side, raw into the factory), atom 1
    frozen."""
    rng = np.random.default_rng(6)
    zs = rng.choice([1, 6, 8], size=5).astype(np.int32)
    xyz = rng.normal(scale=1.4, size=(5, 3))
    p, jcfg = jax_weights_np(name, jnp.float64, seed=6, **over)
    jc = JCalculator(JStructure(zs, xyz), ESCN_FN_FOR(jcfg),
                     params=j_premerge(jtu.tree_map(jnp.asarray, p), jcfg),
                     freeze_atoms=[1])
    monkeypatch.setitem(tescn.ESCN_CONFIGS, name,
                        dataclasses.replace(ESCN_CONFIGS[name], **over))
    tc = make_uma_calculator(Structure(zs, xyz), model=name, device="cpu",
                             dtype=torch.float64, params=params_from_jax(p),
                             freeze_atoms=[1])
    return jc, tc, Structure(zs, xyz).coords_bohr.reshape(-1)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("case", ["gate", "full", "remat"])
def test_hessian_and_hvps_match_jax(case, monkeypatch):
    """One message layer (every op of the branch, half the JAX compile).
    remat recomputes the block on both sides (jax.checkpoint,
    torch.utils.checkpoint): the plain path stays twice
    differentiable."""
    name, over = CASES[case]
    jc, tc, cb = _calc_pair(name, dict(over, num_layers=1), monkeypatch)
    # the force path is the default kernel layout (K2's plain version
    # here); the Hessian closure the all-plain variant
    assert tc.cfg.edge_kernel == "pallas-mega"
    assert tc.cfg.remat_blocks is bool(over.get("remat_blocks"))
    assert tc.energy_fn_hessian is not None
    rj, rt = jc.get_forces(cb), tc.get_forces(cb)
    assert abs(rt["energy"] - rj["energy"]) <= RTOL * abs(rj["energy"])
    assert _rel(rt["forces"], rj["forces"]) <= RTOL
    H_j = jc.get_hessian(cb)["hessian"]
    H_t = tc.get_hessian(cb)["hessian"]
    assert _rel(H_t, H_j) <= RTOL
    cols = [4, 11]
    assert _rel(_hvps(tc, cb, cols, False), _hvps(jc, cb, cols, True)) <= RTOL


def test_escn_md_gate_width_factory_matches_jax(monkeypatch):
    """escn-md-gate at full width (lmax 4, mmax 2, C = h = 128), one
    layer, through make_uma_calculator."""
    jc, tc, cb = _calc_pair("escn-md-gate", dict(num_layers=1),
                            monkeypatch)
    assert tc.cfg.edge_act == "gate" and tc.cfg.lmax == 4
    rj, rt = jc.get_forces(cb), tc.get_forces(cb)
    assert abs(rt["energy"] - rj["energy"]) <= RTOL * abs(rj["energy"])
    assert _rel(rt["forces"], rj["forces"]) <= RTOL


# ---------------------------------------------------------------------------
# K3's inputs under a shard
# ---------------------------------------------------------------------------

class _Rank0Of4:
    """Rank 0 of four in one process: the all-gather returns ``rows``,
    the unsharded first layer's rows of all ranks."""
    size, rank = 4, 0

    def __init__(self, rows):
        self.rows = rows

    @staticmethod
    def replicate_in(x):
        return x

    def all_gather_rows(self, t):
        return self.rows.reshape((-1,) + tuple(t.shape[1:]))


def test_sharded_first_layer_k3_inputs():
    """Rank 0's first-layer K3 inputs under a shard: P/4 x K edges whose
    source rows are gathered from all P rows. K3's plain version on them
    gives the unsharded "pallas-full" call's outputs of those edges."""
    cfg = dataclasses.replace(ESCN_CONFIGS["escn-test"], dtype=torch.float64,
                              edge_kernel="pallas-full")
    zs, xyz, n_pad = cluster(13, 16, 5)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    params = init_escn_params(cfg, seed=5)
    params.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0))
    a_full, _, (rows, _, _) = first_layer_kernel_args(sysp.coords, sysp,
                                                      params, cfg)
    a_sh, _, (rows_sh, src, live) = first_layer_kernel_args(
        sysp.coords, sysp, params, cfg, shard=_Rank0Of4(rows))
    E = n_pad // 4 * cfg.max_neighbors
    assert a_sh[1].shape == (rows.shape[1], E) and src.shape == (E,)
    assert rows_sh.shape == rows.shape and int(src.max()) >= n_pad // 4
    assert torch.equal(a_sh[1], rows[src].T)
    y_full = fused_edge_block_plain(*a_full)[:, :E]
    y_sh = fused_edge_block_plain(*a_sh)
    assert _rel(y_sh, y_full) <= 1e-12 and bool(live.any())


# ---------------------------------------------------------------------------
# routes and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,layout,sharded,route", [
    ("escn-md", "pallas-mega", False, "pallas-mega"),
    ("escn-md", "pallas-mega", True, "pallas-full"),
    ("escn-md", "pallas-full", True, "pallas-full"),
    ("escn-md", "pallas", True, "pallas"),
    ("escn-md", "xla", False, "reduced"),
    ("escn-md", "xla", True, "reduced"),
    ("escn-md-gate", "pallas-mega", False, "reduced"),
    ("escn-md-gate", "pallas-mega", True, "reduced"),
    ("escn-s", "pallas-mega", False, "full"),
    ("escn-s", "xla", True, "full")])
def test_edge_route(name, layout, sharded, route):
    cfg = dataclasses.replace(ESCN_CONFIGS[name], edge_kernel=layout)
    assert edge_route(cfg, sharded) == route
    check_edge_kernel(cfg)


@pytest.mark.parametrize("over,match", [
    (dict(edge_grid_scale=3), "edge_grid_scale"),
    (dict(edge_grid_scale=2, edge_kernel="pallas-full"), "edge_grid_scale"),
    (dict(edge_act="relu"), "edge_act")])
def test_unrunnable_configurations_raise(over, match):
    cfg = dataclasses.replace(ESCN_CONFIGS["escn-test"], **over)
    zs, xyz, n_pad = cluster(4, 8, 0)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    params = init_escn_params(ESCN_CONFIGS["escn-test"])
    params.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0))
    with pytest.raises(ValueError, match=match):
        escn_energy(sysp.coords.float(), sysp, params, cfg)
