"""PaiNN-class equivariant MLIP in PyTorch: the ``uma-s-1p1`` family.

Counterpart of ``pdb2reaction_tpu/mlip/model.py``: scalar and
Cartesian-vector node features, charge/spin embeddings added to the
initial scalars, per-element reference energies and a learned readout.
Parameters are a plain dict of tensors with the JAX package's tree layout
(linears ``{"w": [in, out], "b": [out]}``, MLPs lists of linears), so JAX
weights carry across by name (``from_jax.py``). Energies are in eV;
forces are autograd gradients.

Three message-passing layouts compute the same function:

- ``dense``: the [P, P, R+1] radial adjacency contracted with plain
  matmuls over the joint (j, r) axis (the default; exact, no neighbour
  cap);
- ``gather``: the [P, K] nearest-neighbour matrix;
- ``pallas``: every radial contraction through K5 (``radial_contract``),
  which on CUDA never stores the adjacency: O(P) device memory, the
  large-system path. It computes in float32 whatever ``cfg.dtype`` is.

``energy_fn_gather`` and ``energy_fn_pallas`` also run atom-axis sharded
(``shard``, a ``parallel.SpatialGroup``; ``parallel/spatial.py`` builds the
closure): each rank owns P/n rows, the coordinates come in through
``replicate_in``, the node features are all-gathered per stream and
layer, the pallas mode contracts its rows against all columns through K6
(``radial_contract_rect``), and the energy goes out through ``sum_out``.

Every layout takes tensor-parallel parameters (``parallel.
shard_params_model``, ``train.param_shardings``): a weight laid over the
"model" axis is a ``parallel.Shard`` of its columns. The matmul sites
(``_mm``: the MLPs, the vector updates) multiply by this rank's columns
and all-gather the result's, the input's cotangent summed over the ranks
(the column-parallel linear); the embedding rows gather likewise
(``_rows``); the radial filter, which the contractions need whole,
gathers the weight itself (``_whole``), as GSPMD gathers the operands
of a ``pallas_call``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch.nn.functional import silu

from ..core.neighbors import dense_neighbors_rows, neighbor_vectors
from ..core.structure import PaddedSystem
from ..parallel.distributed import Shard
from .escn import tree_to
from .radial import bessel_basis, cosine_envelope
from .radial_contract import (radial_contract, radial_contract_plain,
                              radial_contract_rect,
                              radial_contract_rect_plain, rect_tile_plan,
                              tile_plan_fixed)


@dataclass(frozen=True)
class ModelConfig:
    hidden: int = 128           # scalar channel width
    n_layers: int = 4
    n_radial: int = 20
    cutoff: float = 6.0         # Angstrom
    max_neighbors: int = 32     # gather mode only
    max_z: int = 100
    charge_range: int = 8       # embeddings for charge in [-range, range]
    spin_range: int = 8         # multiplicity 1..range
    dtype: Any = torch.float32
    mp_mode: str = "dense"      # "dense" | "gather" | "pallas"
    # recompute each dense-mode message layer in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations
    remat_layers: bool = False


# "uma-s-1p1" is the flagship surrogate named after the reference's
# default model.
CONFIGS: Dict[str, ModelConfig] = {
    "uma-s-1p1": ModelConfig(hidden=256, n_layers=4, n_radial=24,
                             cutoff=6.0, max_neighbors=32),
    "uma-m-1p1": ModelConfig(hidden=512, n_layers=6, n_radial=32,
                             cutoff=6.0, max_neighbors=48),
    "small": ModelConfig(hidden=64, n_layers=2, n_radial=8,
                         cutoff=5.0, max_neighbors=16),
    # bfloat16 feature math; forces carry ~1e-3 relative noise
    "uma-s-1p1-bf16": ModelConfig(hidden=256, n_layers=4, n_radial=24,
                                  cutoff=6.0, max_neighbors=32,
                                  dtype=torch.bfloat16),
}


# ---------------------------------------------------------------------------
# parameters (seeded surrogate weights)
# ---------------------------------------------------------------------------

def _randn(gen, shape, scale, dt):
    return torch.randn(shape, generator=gen, dtype=torch.float64).mul_(
        scale).to(dt)


def _dense(gen, n_in, n_out, dt):
    return {"w": _randn(gen, (n_in, n_out), 1.0 / np.sqrt(n_in), dt),
            "b": torch.zeros(n_out, dtype=dt)}


def _mlp(gen, dims, dt):
    return [_dense(gen, dims[i], dims[i + 1], dt)
            for i in range(len(dims) - 1)]


def init_params(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded surrogate weights from a ``torch.Generator`` (CPU stream).
    They do not reproduce the JAX package's seeded weights; carry those
    across with ``from_jax.params_from_jax`` where identity matters."""
    gen = torch.Generator().manual_seed(int(seed))
    C, R, dt = cfg.hidden, cfg.n_radial, cfg.dtype
    params: Dict[str, Any] = {
        "embed_z": _randn(gen, (cfg.max_z + 1, C), 0.5, dt),
        "embed_q": _randn(gen, (2 * cfg.charge_range + 1, C), 0.1, dt),
        "embed_s": _randn(gen, (cfg.spin_range + 1, C), 0.1, dt),
        "atom_ref": torch.zeros(cfg.max_z + 1, dtype=torch.float32),
        "readout": _mlp(gen, (C, C // 2, 1), dt),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "phi": _mlp(gen, (C, C, 3 * C), dt),
            "w_radial": _dense(gen, R, 3 * C, dt),
            "upd_vu": _randn(gen, (C, C), 1.0 / np.sqrt(C), dt),
            "upd_vv": _randn(gen, (C, C), 1.0 / np.sqrt(C), dt),
            "upd_mlp": _mlp(gen, (2 * C, C, 3 * C), dt),
        })
    return params


def _mm(x, w):
    """``x @ w``; for a column ``Shard`` this rank's columns, every rank's
    gathered. ``x`` enters through ``replicate_in``: each rank's product
    gives ``x`` the cotangent of its own columns only, summed over the
    ranks in the backward."""
    if isinstance(w, Shard):
        return w.gather(w.group.replicate_in(x) @ w.local)
    return x @ w


def _rows(table, idx):
    """``table[idx]`` of an embedding table, whole or column-sharded."""
    if isinstance(table, Shard):
        return table.gather(table.local[idx])
    return table[idx]


def _whole(w):
    return w.full() if isinstance(w, Shard) else w


def _apply_mlp(layers, x):
    for i, p in enumerate(layers):
        x = _mm(x, p["w"]) + p["b"]
        if i < len(layers) - 1:
            x = silu(x)
    return x


# ---------------------------------------------------------------------------
# shared blocks
# ---------------------------------------------------------------------------

def _embed_z(z, params, cfg, atom_mask):
    """Initial scalar features for (already clipped) element rows ``z``."""
    s = _rows(params["embed_z"], z)
    # clamped indices read on the device: no host read in a force call
    q_idx = torch.clamp(params["charge"].to(z.device, torch.int64)
                        + cfg.charge_range, 0, 2 * cfg.charge_range)
    m_idx = torch.clamp(params["spin"].to(z.device, torch.int64), 0,
                        cfg.spin_range)
    s = s + _rows(params["embed_q"], q_idx.reshape(1)) \
        + _rows(params["embed_s"], m_idx.reshape(1))
    return s * atom_mask[:, None]


def _embed_nodes(system, params, cfg, atom_mask):
    z = torch.clamp(system.numbers, 0, cfg.max_z)
    return z, _embed_z(z, params, cfg, atom_mask)


def _update_block(lp, s, v, atom_mask):
    vu = _mm(v, lp["upd_vu"])                             # [P,3,C]
    vv = _mm(v, lp["upd_vv"])
    vv_norm = torch.sqrt((vv * vv).sum(1) + 1e-8)         # [P,C] invariant
    a = _apply_mlp(lp["upd_mlp"], torch.cat([s, vv_norm], -1))
    a_ss, a_sv, a_vv = a.chunk(3, -1)
    dot_uv = (vu * vv).sum(1)                             # [P,C]
    s = s + (a_ss + a_sv * dot_uv) * atom_mask[:, None]
    v = v + a_vv[:, None, :] * vu * atom_mask[:, None, None]
    return s, v


def _readout(params, s, z, atom_mask, coords_dtype):
    """Sum of per-atom energies in float32 (float64 when the coordinates
    are float64), as ``model.py:_readout`` of the JAX package."""
    e_atom = _apply_mlp(params["readout"], s)[..., 0]     # [P]
    e_ref = params["atom_ref"][z].float()
    e = ((e_atom.float() + e_ref) * atom_mask.float()).sum()
    return e.double() if coords_dtype == torch.float64 else e


def _shard_rows(P, shard):
    """(first row, row count, row slicer, all-gather of rows) of this
    rank; the whole system and identities without a shard."""
    if shard is None:
        return 0, P, (lambda t: t), (lambda t: t)
    if P % shard.size:
        raise ValueError(f"padded atoms {P} not divisible by {shard.size} "
                         "shards")
    n = P // shard.size
    i0 = shard.rank * n
    return i0, n, (lambda t: t[i0:i0 + n]), shard.all_gather_rows


def _radial_weights(lp, dt):
    """[R+1, 3C] radial filter (bias as the env-only channel's row)."""
    return torch.cat([_whole(lp["w_radial"]["w"]),
                      lp["w_radial"]["b"][None, :]], 0).to(dt)


# ---------------------------------------------------------------------------
# the three layouts
# ---------------------------------------------------------------------------

def energy_fn_gather(coords_ang, system, params, cfg,
                     shard=None) -> torch.Tensor:
    """[P, K] neighbour-matrix formulation; with ``shard`` this rank's
    rows gather their neighbours from the all-gathered node features
    (neighbour indices are global)."""
    dt = cfg.dtype
    P = coords_ang.shape[0]
    C = cfg.hidden
    if shard is not None:
        coords_ang = shard.replicate_in(coords_ang)
    i0, n, rows, allg = _shard_rows(P, shard)
    atom_mask = rows(system.atom_mask).to(dt)
    z = torch.clamp(rows(system.numbers), 0, cfg.max_z)
    idx, nbr_mask = dense_neighbors_rows(coords_ang.detach(),
                                         system.atom_mask, cfg.cutoff,
                                         cfg.max_neighbors, i0, n)
    nbr_mask = nbr_mask.to(dt)
    vec, dist = neighbor_vectors(coords_ang, idx, nbr_mask,
                                 origin=rows(coords_ang))
    vec, dist = vec.to(dt), dist.to(dt)
    unit = vec / dist[..., None]                          # [n,K,3]
    env = cosine_envelope(dist, cfg.cutoff) * nbr_mask    # [n,K]
    # the trailing channel carries the env itself, so the filter bias is
    # env-gated too
    rad = torch.cat(
        [bessel_basis(dist, cfg.cutoff, cfg.n_radial) * env[..., None],
         env[..., None]], -1)                             # [n,K,R+1]
    s = _embed_z(z, params, cfg, atom_mask)
    v = torch.zeros(n, 3, C, dtype=dt, device=coords_ang.device)
    for lp in params["layers"]:
        W = _radial_weights(lp, dt)
        phi = _apply_mlp(lp["phi"], s)                    # [n,3C]
        m = allg(phi)[idx] * (rad @ W)                    # [n,K,3C]
        m_s, m_vv, m_vs = m.chunk(3, -1)
        ds = m_s.sum(1)
        dv = (m_vv[:, :, None, :] * allg(v)[idx]).sum(1)
        dv = dv + (m_vs[:, :, None, :] * unit[..., None]).sum(1)
        s = s + ds * atom_mask[:, None]
        v = v + dv * atom_mask[:, None, None]
        s, v = _update_block(lp, s, v, atom_mask)
    e = _readout(params, s, z, atom_mask, coords_ang.dtype)
    return e if shard is None else shard.sum_out(e)


def energy_fn_dense(coords_ang, system, params, cfg) -> torch.Tensor:
    """Dense radial-adjacency formulation: with A[i,j,r] = bessel_r(d_ij)
    env(d_ij) (plus an env-only channel for the filter bias) every message
    stream is ONE matmul over the joint (j, r) axis, [P, P*(R+1)] x
    [P*(R+1), 4C]; the edge-direction stream uses A/d with
    u = (x_i - x_j)/d: sum_j A u_k phi = x_ik (Ad phi) - Ad (x_k phi)."""
    dt = cfg.dtype
    P = coords_ang.shape[0]
    C = cfg.hidden
    dev = coords_ang.device
    atom_mask = system.atom_mask.to(dt)

    x = coords_ang.to(dt)
    diff = x[:, None, :] - x[None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    pair = atom_mask[:, None] * atom_mask[None, :] * (1.0 - eye.to(dt))
    within = (d <= cfg.cutoff) & ~eye
    env = cosine_envelope(d, cfg.cutoff) * pair * within.to(dt)   # [P,P]
    d_safe = torch.where(within, d, torch.ones_like(d))
    A = torch.cat(
        [bessel_basis(d_safe, cfg.cutoff, cfg.n_radial) * env[..., None],
         env[..., None]], -1)                             # [P,P,R+1]
    Ad = A / d_safe[..., None]

    z, s = _embed_nodes(system, params, cfg, atom_mask)
    v = torch.zeros(P, 3, C, dtype=dt, device=dev)
    R1 = cfg.n_radial + 1
    A2 = A.reshape(P, P * R1)                             # [i, (j,r)]
    Ad2 = Ad.reshape(P, P * R1)

    def layer(s, v, lp):
        W_s, W_vv, W_vs = _radial_weights(lp, dt).chunk(3, -1)    # [R+1,C]
        phi_s, phi_vv, phi_vs = _apply_mlp(lp["phi"], s).chunk(3, -1)
        # scalar + vector-1 streams share A: one [P, P*R1] x [P*R1, 4C]
        phiv = (phi_vv[:, None, :] * v).reshape(P, 3 * C)
        rhsA = torch.cat([phi_s[:, None, :] * W_s[None],
                          phiv[:, None, :] * W_vv.repeat(1, 3)[None]],
                         -1).reshape(P * R1, 4 * C)
        outA = A2 @ rhsA                                  # [P, 4C]
        ds = outA[:, :C]
        dv = outA[:, C:].reshape(P, 3, C)
        # vector stream 2 through the A/d split
        featsB = torch.cat([x[:, k:k + 1] * phi_vs for k in range(3)]
                           + [phi_vs], -1)
        rhsB = (featsB[:, None, :] * W_vs.repeat(1, 4)[None]) \
            .reshape(P * R1, 4 * C)
        outB = Ad2 @ rhsB                                 # [P, 4C]
        dv2 = outB[:, 3 * C:][:, None, :] * x[:, :, None] \
            - outB[:, :3 * C].reshape(P, 3, C)
        s = s + ds * atom_mask[:, None]
        v = v + (dv + dv2) * atom_mask[:, None, None]
        return _update_block(lp, s, v, atom_mask)

    for lp in params["layers"]:
        if cfg.remat_layers:
            s, v = torch.utils.checkpoint.checkpoint(layer, s, v, lp,
                                                     use_reentrant=False)
        else:
            s, v = layer(s, v, lp)
    return _readout(params, s, z, atom_mask, coords_ang.dtype)


def energy_fn_pallas(coords_ang, system, params, cfg,
                     shard=None, plain=False) -> torch.Tensor:
    """Every radial contraction through K5 (``radial_contract``): on CUDA
    the adjacency is built tile by tile inside the kernels and never
    stored, on one tile plan that the call builds for all of its
    contractions. Computes in float32 whatever ``cfg.dtype`` is. The
    edge-direction stream uses the u = (x_i - x_j)/d split:
    sum_j A u_k phi = x_ik (B phi) - B (x_k phi), B = A/d. With ``shard``
    this rank's rows contract against the all-gathered streams of every
    atom through K6 (``radial_contract_rect``), whose three kernels run on
    one rect tile plan a call: O(P/n) memory a rank. ``plain`` runs K5's
    plain version (``radial_contract_plain``) on any device instead, or
    under ``shard`` K6's (``radial_contract_rect_plain``): twice
    differentiable, the Hessian closure's route (it stores the
    [P, P, R+1] adjacency, [P/n, P, R+1] a rank under a shard)."""
    dt = torch.float32
    P = coords_ang.shape[0]
    C = cfg.hidden
    params = tree_to(params, dtype=dt)
    if shard is not None:
        coords_ang = shard.replicate_in(coords_ang)
    i0, n, rows, allg = _shard_rows(P, shard)
    x_full = coords_ang.to(dt)
    mask_full = system.atom_mask.to(dt)
    x, atom_mask = rows(x_full), rows(mask_full)
    # one tile plan of this evaluation's coordinates serves every K5 call,
    # one rect plan of this rank's rows every K6 call (never cached across
    # calls: the optimizer moves the atoms)
    plan = None
    if x_full.is_cuda and not plain:
        plan = (tile_plan_fixed(x_full, mask_full, cfg.cutoff)
                if shard is None
                else rect_tile_plan(x, atom_mask, i0, x_full, mask_full,
                                    cfg.cutoff))

    def contract(feats, div_d=False):
        if plain and shard is not None:
            return radial_contract_rect_plain(x, atom_mask, i0, x_full,
                                              mask_full, allg(feats),
                                              cfg.cutoff, cfg.n_radial,
                                              div_d)
        if plain:
            return radial_contract_plain(x_full, mask_full, feats,
                                         cfg.cutoff, cfg.n_radial, div_d)
        if shard is None:
            return radial_contract(x_full, mask_full, feats, cfg.cutoff,
                                   cfg.n_radial, div_d, plan=plan)
        return radial_contract_rect(x, atom_mask, i0, x_full, mask_full,
                                    allg(feats), cfg.cutoff, cfg.n_radial,
                                    div_d, plan=plan)

    z = torch.clamp(rows(system.numbers), 0, cfg.max_z)
    s = _embed_z(z, params, cfg, atom_mask)
    v = torch.zeros(n, 3, C, dtype=dt, device=coords_ang.device)
    for lp in params["layers"]:
        W_s, W_vv, W_vs = _radial_weights(lp, dt).chunk(3, -1)
        phi_s, phi_vv, phi_vs = _apply_mlp(lp["phi"], s).chunk(3, -1)
        # scalar and vector A-streams in one call: F = C + 3C
        feats_v = (phi_vv[:, None, :] * v).reshape(n, 3 * C)
        T_sv = contract(torch.cat([phi_s, feats_v], 1))   # [n,R+1,4C]
        T_s = T_sv[..., :C]
        T_v = T_sv[..., C:].reshape(n, -1, 3, C)
        ds = torch.einsum("irc,rc->ic", T_s, W_s)
        dv = torch.einsum("irkc,rc->ikc", T_v, W_vv)
        featsB = torch.cat([x[:, k:k + 1] * phi_vs for k in range(3)]
                           + [phi_vs], -1)
        Q = contract(featsB, div_d=True)                  # [n,R+1,4C]
        Q1 = Q[..., :3 * C].reshape(n, -1, 3, C)
        Q2 = Q[..., 3 * C:]
        # u = (x_i - x_j)/d, as in the dense mode
        dv2 = torch.einsum("irc,rc->ic", Q2, W_vs)[:, None, :] \
            * x[:, :, None] - torch.einsum("irkc,rc->ikc", Q1, W_vs)
        s = s + ds * atom_mask[:, None]
        v = v + (dv + dv2) * atom_mask[:, None, None]
        s, v = _update_block(lp, s, v, atom_mask)
    e = _readout(params, s, z, atom_mask, coords_ang.dtype)
    return e if shard is None else shard.sum_out(e)


def energy_fn(coords_ang: torch.Tensor, system: PaddedSystem,
              params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """Total potential energy in eV; differentiable in coords."""
    if cfg.mp_mode == "pallas":
        return energy_fn_pallas(coords_ang, system, params, cfg)
    if cfg.mp_mode == "dense":
        return energy_fn_dense(coords_ang, system, params, cfg)
    if cfg.mp_mode == "gather":
        return energy_fn_gather(coords_ang, system, params, cfg)
    raise ValueError(f"mp_mode {cfg.mp_mode!r}: dense, gather or pallas")


def make_energy_fn(cfg: ModelConfig):
    """The Calculator's ``fn(coords, system, params)`` for a config."""
    def fn(coords, system, params):
        return energy_fn(coords, system, params, cfg)
    return fn


def make_hessian_energy_fn(cfg: ModelConfig):
    """The Hessian closure for a config: the pallas mode on K5's plain
    version (the kernels have no double backward), the dense and gather
    modes as they are (plain PyTorch, twice differentiable)."""
    if cfg.mp_mode != "pallas":
        return make_energy_fn(cfg)

    def fn(coords, system, params):
        return energy_fn_pallas(coords, system, params, cfg, plain=True)
    return fn


def make_model(name_or_cfg, *, seed: int = 0, charge: int = 0,
               spin: int = 1):
    """(energy_fn, params, cfg) for a registry name or a config; params
    are the seeded surrogate on the CPU with the charge/spin scalars."""
    cfg = (CONFIGS[name_or_cfg] if isinstance(name_or_cfg, str)
           else name_or_cfg)
    params = init_params(cfg, seed=seed)
    params["charge"] = torch.as_tensor(float(charge))
    params["spin"] = torch.as_tensor(float(spin))
    return make_energy_fn(cfg), params, cfg
