"""eSCN-MoE backbone (UMA-class) in PyTorch.

Counterpart of ``pdb2reaction_tpu/mlip/escn.py``: node features are real
spherical-harmonic coefficients [P, (lmax+1)^2, C]; each edge's message is
computed in an edge-aligned frame where an SO(2) convolution mixes only
+-m pairs with |m| <= mmax; every linear is a mixture of linear experts
(MoLE) whose experts are merged once per system from (task, charge, spin);
a point-wise S2-grid FFN per node; equivariant RMS norms; per-element
reference energies. Parameters are a plain dict of tensors with the JAX
package's tree layout (linears ``{"w": [in, out], "b": [out]}``, MoLE
banks ``w: [experts, in, out]``), so JAX weights carry across by name
(``from_jax.py``).

This slice ports the reduced (mmax < lmax) branch with the separable S2
edge activation, the configuration of every checkpoint-shaped model
(escn-md, escn-uma-s, escn-test). Each message layer is one call of the
K1 kernel (``fused_edge_mega``) and each node FFN one call of K2
(``fused_node_ffn``); both take their CUDA kernels on CUDA tensors and
their plain PyTorch versions on CPU tensors. Forces are autograd
gradients of the energy.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch

from ..core.neighbors import dense_neighbors_rows, neighbor_vectors
from ..core.structure import PaddedSystem
from .escn_edge_kernel import fused_edge_mega, pack_d, _rot_nz
from .escn_ffn_kernel import fused_node_ffn
from .so3 import (_const, edge_rot_mat, num_coeffs, s2_grid_tables,
                  s2_grid_tables_midpoint, wigner_full)

_TODO = "see ROADMAP.md queue 0 item 2 (eSCN full and gate branches)"


@dataclass(frozen=True)
class ESCNConfig:
    lmax: int = 2
    mmax: int = 2
    sphere_channels: int = 64       # C: channels per (l,m) coefficient
    hidden_channels: int = 64       # SO(2) conv hidden width
    edge_channels: int = 32         # invariant edge scalar embedding
    ffn_hidden: int = 128
    num_layers: int = 2
    num_experts: int = 4
    route_dim: int = 16
    num_gauss: int = 32             # Gaussian radial basis size
    cutoff: float = 6.0             # Angstrom
    max_neighbors: int = 32
    max_z: int = 100
    charge_range: int = 8
    spin_range: int = 8
    num_tasks: int = 8
    avg_degree: float = 12.0        # aggregation normalization
    grid_ntheta: int = 0            # node-FFN S2 grid; 0 = 4(lmax+1)
    grid_nphi: int = 0              # 0 = 4 lmax + 7
    remat_blocks: bool = False
    edge_act: str = "s2"            # "s2" (ported) or "gate" (not yet)
    edge_grid_scale: int = 1
    dtype: Any = torch.float32

    @property
    def grid(self):
        nt = self.grid_ntheta or 4 * (self.lmax + 1)
        np_ = self.grid_nphi or 4 * self.lmax + 7
        return nt, np_


@lru_cache(maxsize=None)
def _m_indices(lmax: int, mmax: int):
    """Flat (l,m) coefficient indices grouped by |m| for SO(2) convs."""
    m0 = np.array([l * (l + 1) for l in range(lmax + 1)])
    pos, neg = [], []
    for m in range(1, mmax + 1):
        pos.append(np.array([l * (l + 1) + m for l in range(m, lmax + 1)]))
        neg.append(np.array([l * (l + 1) - m for l in range(m, lmax + 1)]))
    return m0, pos, neg


@lru_cache(maxsize=None)
def _used_indices(lmax: int, mmax: int):
    """Ordered flat indices of the |m| <= mmax coefficients:
    [m0 block, +1, -1, +2, -2, ...] (the reduced basis, U rows)."""
    m0, pos, neg = _m_indices(lmax, mmax)
    parts = [m0]
    for m in range(1, mmax + 1):
        parts += [pos[m - 1], neg[m - 1]]
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# parameter init (seeded surrogate weights)
# ---------------------------------------------------------------------------

def _randn(gen, shape, scale, dt):
    return torch.randn(shape, generator=gen, dtype=torch.float64).mul_(
        scale).to(dt)


def _mole_linear(gen, experts, n_in, n_out, dt):
    return {"w": _randn(gen, (experts, n_in, n_out), 1.0 / np.sqrt(n_in), dt),
            "b": torch.zeros(experts, n_out, dtype=dt)}


def _linear(gen, n_in, n_out, dt):
    return {"w": _randn(gen, (n_in, n_out), 1.0 / np.sqrt(n_in), dt),
            "b": torch.zeros(n_out, dtype=dt)}


def _so2_conv(gen, cfg: ESCNConfig, c_in, c_out, with_edge):
    E, dt, nl0 = cfg.num_experts, cfg.dtype, cfg.lmax + 1
    d_in0 = nl0 * c_in + (cfg.edge_channels if with_edge else 0)
    p = {"fc_m0": _mole_linear(gen, E, d_in0, nl0 * c_out, dt)}
    for m in range(1, cfg.mmax + 1):
        nl = cfg.lmax + 1 - m
        p[f"fc_m{m}_r"] = _mole_linear(gen, E, nl * c_in, nl * c_out, dt)
        p[f"fc_m{m}_i"] = _mole_linear(gen, E, nl * c_in, nl * c_out, dt)
    return p


def init_escn_params(cfg: ESCNConfig, seed: int = 0,
                     device="cpu") -> Dict[str, Any]:
    """Seeded surrogate weights from a ``torch.Generator`` (CPU stream, so
    a seed gives the same weights on every device). They do not reproduce
    the JAX package's seeded weights; carry those across with
    ``from_jax.params_from_jax`` where identity matters."""
    gen = torch.Generator().manual_seed(int(seed))
    C, dt, E = cfg.sphere_channels, cfg.dtype, cfg.num_experts
    Ce, R = cfg.edge_channels, cfg.route_dim
    params: Dict[str, Any] = {
        "sphere_embedding": _randn(gen, (cfg.max_z + 1, C), 0.5, dt),
        "source_embedding": _randn(gen, (cfg.max_z + 1, Ce), 0.5, dt),
        "target_embedding": _randn(gen, (cfg.max_z + 1, Ce), 0.5, dt),
        "charge_embedding": _randn(gen, (2 * cfg.charge_range + 1, R), 0.5,
                                   dt),
        "spin_embedding": _randn(gen, (cfg.spin_range + 1, R), 0.5, dt),
        "task_embedding": _randn(gen, (cfg.num_tasks, R), 0.5, dt),
        "router": [_linear(gen, 3 * R, R, dt), _linear(gen, R, E, dt)],
        "edge_mlp": [_linear(gen, 2 * Ce + cfg.num_gauss, Ce, dt),
                     _linear(gen, Ce, Ce, dt)],
        "edge_degree_proj": _mole_linear(gen, E, Ce, (cfg.lmax + 1) * C, dt),
        "blocks": [],
        "energy_norm": torch.ones(cfg.lmax + 1, C, dtype=dt),
        "energy_head": [_mole_linear(gen, E, C, C, dt),
                        _mole_linear(gen, E, C, 1, dt)],
        "atom_ref": torch.zeros(cfg.max_z + 1, dtype=torch.float32),
    }
    h = cfg.hidden_channels
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "norm_1": torch.ones(cfg.lmax + 1, C, dtype=dt),
            "so2_conv_1": _so2_conv(gen, cfg, 2 * C, h, with_edge=True),
            "so2_conv_2": _so2_conv(gen, cfg, h, C, with_edge=False),
            "norm_2": torch.ones(cfg.lmax + 1, C, dtype=dt),
            "ffn": [_mole_linear(gen, E, C, cfg.ffn_hidden, dt),
                    _mole_linear(gen, E, cfg.ffn_hidden, C, dt)],
        })
    return tree_to(params, device=device)


def tree_to(tree, **kw):
    """Apply ``Tensor.to(**kw)`` to every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, **kw) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(**kw)
    return tree


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_linear_stack(layers, x):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.nn.functional.silu(x)
    return x


def _merged_wb(p, alpha):
    """Merged (W, b) of one MoLE linear (a premerged tree has 2-D w)."""
    if p["w"].ndim == 2:
        return p["w"], p["b"]
    return (torch.einsum("e,eio->io", alpha, p["w"]),
            torch.einsum("e,eo->o", alpha, p["b"]))


def _mole(p, alpha, x):
    W, b = _merged_wb(p, alpha)
    return x @ W + b


def _route_alpha(params, cfg: ESCNConfig):
    """Expert coefficients from the system's (task, charge, spin)."""
    def idx(v, lo, hi):
        return int(min(max(int(v), lo), hi))

    q_idx = idx(params["charge"] + cfg.charge_range, 0, 2 * cfg.charge_range)
    s_idx = idx(params["spin"], 0, cfg.spin_range)
    t_idx = idx(params.get("task", 0), 0, cfg.num_tasks - 1)
    route_in = torch.cat([params["task_embedding"][t_idx],
                          params["charge_embedding"][q_idx],
                          params["spin_embedding"][s_idx]], -1)
    return torch.softmax(_apply_linear_stack(params["router"], route_in), -1)


def premerge_escn_params(params, cfg: ESCNConfig):
    """Merge every MoLE expert bank with the system's routing coefficients
    once, returning a tree of plain 2-D linears (exact: the merge is
    linear)."""
    alpha = _route_alpha(params, cfg)

    def conv(tree):
        if (isinstance(tree, dict) and set(tree) == {"w", "b"}
                and isinstance(tree["w"], torch.Tensor)
                and tree["w"].ndim == 3):
            return {"w": torch.einsum("e,eio->io", alpha, tree["w"]),
                    "b": torch.einsum("e,eo->o", alpha, tree["b"])}
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v) for v in tree]
        return tree

    return conv(params)


def _pack_conv_weights(blk, alpha, cfg: ESCNConfig):
    """K1's 12-tuple of merged conv1 + conv2 weights. Each +-m pair packs
    its effective biases: yp carries (br - bi), yn carries (br + bi)."""
    c1, c2 = blk["so2_conv_1"], blk["so2_conv_2"]
    W0, b0 = _merged_wb(c1["fc_m0"], alpha)
    V0, c0 = _merged_wb(c2["fc_m0"], alpha)
    Wrs, Wis, brs, bis = [], [], [], []
    Vrs, Vis, crs, cis = [], [], [], []
    for mm in range(1, cfg.mmax + 1):
        wr, br = _merged_wb(c1[f"fc_m{mm}_r"], alpha)
        wi, bi = _merged_wb(c1[f"fc_m{mm}_i"], alpha)
        Wrs.append(wr), Wis.append(wi)
        brs.append(br - bi), bis.append(br + bi)
        vr, cr = _merged_wb(c2[f"fc_m{mm}_r"], alpha)
        vi, ci = _merged_wb(c2[f"fc_m{mm}_i"], alpha)
        Vrs.append(vr), Vis.append(vi)
        crs.append(cr - ci), cis.append(cr + ci)
    return (W0, tuple(Wrs), tuple(Wis), b0, tuple(brs), tuple(bis),
            V0, tuple(Vrs), tuple(Vis), c0, tuple(crs), tuple(cis))


@lru_cache(maxsize=None)
def _l_of_m(lmax: int):
    return np.concatenate([np.full(2 * l + 1, l) for l in range(lmax + 1)])


def _equi_rms_norm(x, gamma, cfg: ESCNConfig, eps=1e-6):
    """Per-l RMS norm over (m, C) with learned per-(l, C) scales;
    x [..., M, C], gamma [lmax+1, C]. Vectorised: one segment sum."""
    C = x.shape[-1]
    L = cfg.lmax + 1
    l_of_m = _const(("l_of_m", cfg.lmax), lambda: _l_of_m(cfg.lmax),
                    torch.long, x.device)
    counts = _const(("counts", L, C), lambda: (2 * np.arange(L) + 1) * C,
                    x.dtype, x.device)
    sq = (x * x).sum(-1)                                    # [..., M]
    sums = sq.new_zeros(sq.shape[:-1] + (L,)).index_add(-1, l_of_m, sq)
    rms = torch.sqrt(sums / counts + eps)                   # [..., L]
    inv_m = (1.0 / rms)[..., l_of_m]                        # [..., M]
    return x * inv_m[..., None] * gamma[l_of_m]


def _gauss_basis(d, cfg: ESCNConfig):
    """Fixed Gaussian radial basis on [0, cutoff]."""
    offsets = torch.linspace(0.0, cfg.cutoff, cfg.num_gauss,
                             dtype=torch.float64, device=d.device).to(d.dtype)
    width = cfg.cutoff / (cfg.num_gauss - 1)
    return torch.exp(-0.5 * ((d[..., None] - offsets) / width) ** 2)


def _envelope(d, cfg: ESCNConfig):
    """Smooth polynomial cutoff envelope (1 at 0, 0 with zero slope at rc)."""
    u = torch.clamp(d / cfg.cutoff, 0.0, 1.0)
    return 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5


@lru_cache(maxsize=None)
def _edge_grid_tables(lmax: int, mmax: int, scale: int = 1):
    """(to_grid [G, U], from_grid [U, G]) of the per-edge S2 activation on
    the |m| <= mmax subspace: 2(lmax+1) midpoint theta x (2 mmax + 1) phi
    nodes (fairchem SO3_Grid(lmax, mmax))."""
    tg, fg = s2_grid_tables_midpoint(lmax, scale * 2 * (lmax + 1),
                                     2 * scale * mmax + 1)
    used = _used_indices(lmax, mmax)
    return tg[:, used], fg[used, :]


def _setup(coords_ang, system: PaddedSystem, params, cfg: ESCNConfig):
    """Everything before the message-passing blocks: routing, radius
    graph, edge frames, edge scalars, initial node features and the
    per-edge inputs every layer's K1 call shares."""
    if cfg.mmax >= cfg.lmax:
        raise NotImplementedError(f"full eSCN branch (mmax == lmax); {_TODO}")
    if cfg.edge_act != "s2":
        raise NotImplementedError(f"edge_act={cfg.edge_act!r}; {_TODO}")
    if cfg.remat_blocks or cfg.edge_grid_scale != 1:
        raise NotImplementedError(
            f"remat_blocks / edge_grid_scale; {_TODO}")
    dt = cfg.dtype
    dev = coords_ang.device
    P = coords_ang.shape[0]
    C = cfg.sphere_channels
    M = num_coeffs(cfg.lmax)
    K = cfg.max_neighbors
    E = P * K
    nl0 = cfg.lmax + 1
    atom_mask = system.atom_mask.to(dt)
    z = torch.clamp(system.numbers, 0, cfg.max_z)

    premerged = params["energy_head"][0]["w"].ndim == 2
    alpha = None if premerged else _route_alpha(params, cfg)

    # ---- radius graph (nearest-K within cutoff; no gradient) --------------
    idx, nbr_mask = dense_neighbors_rows(coords_ang.detach(),
                                         system.atom_mask, cfg.cutoff, K,
                                         0, P)
    nbr_mask = nbr_mask.to(dt)
    vec, dist = neighbor_vectors(coords_ang, idx, nbr_mask)
    vec = vec.to(dt)
    dist = dist.to(dt)

    # edge frame; masked slots rotate a safe vector. Rotate directly into
    # the reduced |m| <= mmax basis (rows _used_indices).
    rot = edge_rot_mat(vec + (1.0 - nbr_mask[..., None]))
    used = _const(("used", cfg.lmax, cfg.mmax),
                  lambda: _used_indices(cfg.lmax, cfg.mmax), torch.long, dev)
    D_sel = wigner_full(rot, cfg.lmax)[..., used, :]         # [P,K,U,M]

    # ---- invariant edge scalars -------------------------------------------
    gauss = _gauss_basis(dist, cfg)
    esrc = params["source_embedding"][z[idx]]                 # [P,K,Ce]
    etgt = params["target_embedding"][z][:, None, :].expand_as(esrc)
    edge_scalar = _apply_linear_stack(params["edge_mlp"],
                                      torch.cat([esrc, etgt, gauss], -1))
    env = (_envelope(dist, cfg) * nbr_mask)[..., None]        # [P,K,1]

    # ---- initial node features ---------------------------------------------
    x = torch.cat([params["sphere_embedding"][z][:, None, :],
                   torch.zeros(P, M - 1, C, dtype=dt, device=dev)], 1)
    deg = _mole(params["edge_degree_proj"], alpha,
                edge_scalar).reshape(P, K, nl0, C)
    deg_back = torch.einsum("pkum,pkuc->pkmc", D_sel[..., :nl0, :], deg)
    x = x + (deg_back * env[..., None]).sum(1) / cfg.avg_degree
    x = x * atom_mask[:, None, None]

    # ---- per-edge kernel inputs (shared by every layer) --------------------
    nnz = len(_rot_nz(cfg.lmax, cfg.mmax)[0])
    Dp_pk = pack_d(cfg, D_sel)                                # [P,K,nnz]
    Dp_t = Dp_pk.permute(2, 0, 1).reshape(nnz, E)
    Dpe_t = (Dp_pk * env).permute(2, 0, 1).reshape(nnz, E)
    es_t = edge_scalar.reshape(E, cfg.edge_channels).T
    src = idx.reshape(E)
    edge_tabs = tuple(
        _const(("edge", cfg.lmax, cfg.mmax, i),
               lambda i=i: _edge_grid_tables(cfg.lmax, cfg.mmax)[i], dt, dev)
        for i in range(2))
    node_tabs = tuple(
        _const(("node", cfg.lmax, cfg.grid, i),
               lambda i=i: s2_grid_tables(cfg.lmax, *cfg.grid)[i], dt, dev)
        for i in range(2))
    return dict(alpha=alpha, x=x, z=z, atom_mask=atom_mask, src=src,
                es_t=es_t, Dp_t=Dp_t, Dpe_t=Dpe_t, edge_tabs=edge_tabs,
                node_tabs=node_tabs)


def _block_edge_args(s, blk, cfg: ESCNConfig, x):
    """Arguments of one layer's K1 call."""
    P, M, C = x.shape
    xn = _equi_rms_norm(x, blk["norm_1"], cfg)
    return (cfg, xn.permute(1, 2, 0).reshape(M * C, P), s["src"], s["es_t"],
            s["Dp_t"], s["Dpe_t"], _pack_conv_weights(blk, s["alpha"], cfg),
            s["edge_tabs"])


def _block_ffn_args(s, blk, cfg: ESCNConfig, x):
    """Arguments of one layer's K2 call."""
    xn2 = _equi_rms_norm(x, blk["norm_2"], cfg)
    W1, b1 = _merged_wb(blk["ffn"][0], s["alpha"])
    W2, b2 = _merged_wb(blk["ffn"][1], s["alpha"])
    return (cfg, xn2, (W1, b1, W2, b2), s["node_tabs"])


def _block(s, blk, cfg: ESCNConfig, x):
    P, M, C = x.shape
    mask = s["atom_mask"][:, None, None]
    msum_t = fused_edge_mega(*_block_edge_args(s, blk, cfg, x))
    x = (x + msum_t.reshape(M, C, P).permute(2, 0, 1) / cfg.avg_degree) * mask
    return (x + fused_node_ffn(*_block_ffn_args(s, blk, cfg, x))) * mask


def first_layer_kernel_args(coords_ang, system, params, cfg: ESCNConfig):
    """(K1 args, K2 args) of the first message layer, exactly as the
    force call builds them — the inputs a kernel check runs at."""
    s = _setup(coords_ang, system, params, cfg)
    blk = params["blocks"][0]
    P, M, C = s["x"].shape
    edge_args = _block_edge_args(s, blk, cfg, s["x"])
    msum_t = fused_edge_mega(*edge_args)
    x = (s["x"] + msum_t.reshape(M, C, P).permute(2, 0, 1)
         / cfg.avg_degree) * s["atom_mask"][:, None, None]
    return edge_args, _block_ffn_args(s, blk, cfg, x)


def escn_energy(coords_ang, system: PaddedSystem, params, cfg: ESCNConfig):
    """Total potential energy in eV of one padded system; coords [P, 3]."""
    s = _setup(coords_ang, system, params, cfg)
    x = s["x"]
    for blk in params["blocks"]:
        x = _block(s, blk, cfg, x)
    alpha, z, atom_mask = s["alpha"], s["z"], s["atom_mask"]
    dt = cfg.dtype

    # ---- energy head --------------------------------------------------------
    xn = _equi_rms_norm(x, params["energy_norm"], cfg)
    e = torch.nn.functional.silu(_mole(params["energy_head"][0], alpha,
                                       xn[:, 0, :]))
    e_atom = _mole(params["energy_head"][1], alpha, e)[..., 0]
    e_ref = params["atom_ref"].to(dt)[z]
    return ((e_atom + e_ref) * atom_mask).sum()


# named configs (same entries as the JAX package's registry)
ESCN_CONFIGS: Dict[str, ESCNConfig] = {
    "escn-s": ESCNConfig(),
    "escn-md": ESCNConfig(lmax=4, mmax=2, sphere_channels=128,
                          hidden_channels=128, edge_channels=64,
                          ffn_hidden=256, num_layers=4, num_experts=8),
    "escn-md-gate": ESCNConfig(lmax=4, mmax=2, sphere_channels=128,
                               hidden_channels=128, edge_channels=64,
                               ffn_hidden=256, num_layers=4, num_experts=8,
                               edge_act="gate"),
    "escn-uma-s": ESCNConfig(lmax=4, mmax=2, sphere_channels=128,
                             hidden_channels=256, edge_channels=128,
                             ffn_hidden=512, num_layers=8, num_experts=8,
                             max_neighbors=64),
    "escn-test": ESCNConfig(lmax=2, mmax=1, sphere_channels=8,
                            hidden_channels=8, edge_channels=8,
                            ffn_hidden=16, num_layers=2, num_experts=2,
                            route_dim=4, num_gauss=8, max_neighbors=16),
    "escn-test-gate": ESCNConfig(lmax=2, mmax=1, sphere_channels=8,
                                 hidden_channels=8, edge_channels=8,
                                 ffn_hidden=16, num_layers=2,
                                 num_experts=2, route_dim=4, num_gauss=8,
                                 max_neighbors=16, edge_act="gate"),
}


def escn_energy_fn(cfg: ESCNConfig):
    """Calculator-protocol closure (coords, system, params) -> eV."""
    def fn(coords, system, params):
        return escn_energy(coords, system, params, cfg)
    return fn
