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

Every branch of the JAX package's ``escn_energy`` runs: the reduced
(mmax < lmax) and full (mmax == lmax) layouts, the separable S2 and gate
edge activations, ``remat_blocks``, ``edge_grid_scale`` and atom-axis
sharding (``shard``). ``ESCNConfig.edge_kernel`` picks the layout of
each message layer of the reduced S2 configurations (escn-md,
escn-uma-s, escn-test, every checkpoint-shaped model), with the JAX
package's names: "pallas-mega" (the default) is one call of K1
(``fused_edge_mega``); "pallas-full" gathers per-edge rows, calls K3
(``fused_edge_block``) and K-sums its per-edge output; "pallas" rotates
the pair rows with einsums, calls K4 (``fused_edge_chain``) and rotates
back, envelope and K-sum in one contraction. Under a shard K1, which
reads one row set for sources and targets, gives way to K3 on the source
rows gathered from the all-gathered features, as in the JAX package.
The full layout and the gate activation take the JAX package's plain
edge paths on every layout: K1, K3 and K4 bake in the S2 activation, and
the JAX package has no kernel for them (``edge_route``). Each node FFN
is one call of K2 (``fused_node_ffn``) on every kernel layout, as the
JAX package's ``use_pallas_ffn`` rule gives. Every kernel takes its CUDA
version on CUDA tensors and its plain PyTorch version on CPU tensors.
Forces are autograd gradients of the energy. ``escn_energy_images``
takes B images of one system in one pass, stacked along the atom axis,
so each kernel launches once a layer for all of them (the Calculator's
chunks of images and FD displacements).

Parameters laid over a mesh axis (``parallel.Shard``) run too: a tree
of ``parallel.shard_params_model`` (feature columns over "model") is
gathered whole for the call, as GSPMD gathers the operands of the JAX
package's kernels; the MoLE banks of the expert-parallel train step
(``train.escn_param_shardings``: experts over "expert") merge their own
experts and sum the merge over the axis (``_merged_wb``). Every kernel
gives its weights' cotangents (a replay of its plain version), so
dE/dW runs on every layout.

"xla" is the all-plain variant, the JAX package's name for it: the JAX
package's plain reduced edge path (gathering with plain ``x[src]``) and
the plain node FFN (``ffn_plain``) on any device. Nothing there launches
a kernel, so the path is twice differentiable: the Hessian closures of
``mlip/uma.py`` run it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.neighbors import (dense_neighbors_images, dense_neighbors_rows,
                              neighbor_vectors)
from ..core.structure import PaddedSystem
from ..parallel.distributed import Shard
from ..parallel.mesh import map_tree
from .escn_edge_kernel import (conv_plain, fused_edge_block,
                               fused_edge_chain, fused_edge_mega,
                               gather_src, pack_d, s2_act_plain, _rot_nz)
from .escn_ffn_kernel import ffn_plain, fused_node_ffn
from .so3 import (_const, edge_rot_mat, num_coeffs, s2_grid_tables,
                  s2_grid_tables_midpoint, wigner_blocks, wigner_full)

EDGE_KERNELS = ("pallas-mega", "pallas-full", "pallas")
# every edge layout the port runs: the kernel layouts and the all-plain one
EDGE_LAYOUTS = EDGE_KERNELS + ("xla",)
EDGE_ACTS = ("s2", "gate")


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
    # recompute each message block in the backward (torch.utils.checkpoint,
    # as jax.checkpoint in the JAX package): the [P, K, U, 2C] edge tensors
    # of a layer are not held through the backward; every kernel's forward
    # launches twice a layer
    remat_blocks: bool = False
    edge_act: str = "s2"            # one of EDGE_ACTS
    # per-edge S2 grid oversampling, "xla" only (the kernels bake in
    # fairchem's SO3_Grid(lmax, mmax) nodes; checkpoints need 1)
    edge_grid_scale: int = 1
    edge_kernel: str = "pallas-mega"    # one of EDGE_LAYOUTS
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
        blk = {
            "norm_1": torch.ones(cfg.lmax + 1, C, dtype=dt),
            "so2_conv_1": _so2_conv(gen, cfg, 2 * C, h, with_edge=True),
            "so2_conv_2": _so2_conv(gen, cfg, h, C, with_edge=False),
            "norm_2": torch.ones(cfg.lmax + 1, C, dtype=dt),
            "ffn": [_mole_linear(gen, E, C, cfg.ffn_hidden, dt),
                    _mole_linear(gen, E, cfg.ffn_hidden, C, dt)],
        }
        if cfg.edge_act == "gate":
            # the gate's MoLE bank over the hidden scalars
            blk["gate"] = _mole_linear(gen, E, h, h, dt)
        params["blocks"].append(blk)
    return tree_to(params, device=device)


def tree_to(tree, **kw):
    """Apply ``Tensor.to(**kw)`` to every tensor of a parameter tree (to
    a ``Shard``'s block)."""
    if isinstance(tree, Shard):
        return tree.with_local(tree.local.to(**kw))
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
    """Merged (W, b) of one MoLE linear (a premerged tree has 2-D w). A
    bank laid over the "expert" axis (``Shard``) merges its own experts
    and sums the merge over the axis (``sum_out``: the psum XLA inserts
    for the JAX package's einsum over a sharded axis); ``alpha`` has
    then come in through the axis's ``replicate_in`` (``_setup``)."""
    w, b = p["w"], p["b"]
    if isinstance(w, Shard):
        g, n = w.group, w.local.shape[0]
        a = alpha[g.rank * n:(g.rank + 1) * n]
        return (g.sum_out(torch.einsum("e,eio->io", a, w.local)),
                g.sum_out(torch.einsum("e,eo->o", a, b.local)))
    if w.ndim == 2:
        return w, b
    return (torch.einsum("e,eio->io", alpha, w),
            torch.einsum("e,eo->o", alpha, b))


def _whole_model(tree):
    """``tree`` with every weight laid over the "model" axis
    (``parallel.shard_params_model``) gathered whole: the eSCN backbone
    multiplies by whole weights, as GSPMD gathers the operands of its
    kernels; the expert banks stay laid out."""
    return map_tree(tree, lambda _, x: x.full() if isinstance(x, Shard)
                    and x.axis == "model" else x)


def _mole(p, alpha, x):
    W, b = _merged_wb(p, alpha)
    return x @ W + b


def _route_alpha(params, cfg: ESCNConfig):
    """Expert coefficients from the system's (task, charge, spin)."""
    dev = params["task_embedding"].device

    def idx(v, lo, hi):
        # clamped, read on the device: no host read in a force call
        v = torch.as_tensor(v).to(dev)
        return torch.clamp(v.to(torch.int64), lo, hi).reshape(1)

    q_idx = idx(params["charge"] + cfg.charge_range, 0, 2 * cfg.charge_range)
    s_idx = idx(params["spin"], 0, cfg.spin_range)
    t_idx = idx(params.get("task", 0), 0, cfg.num_tasks - 1)
    route_in = torch.cat([params["task_embedding"][t_idx],
                          params["charge_embedding"][q_idx],
                          params["spin_embedding"][s_idx]], -1)[0]
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
    x [..., M, C], gamma [lmax+1, C]. Vectorised: the per-l sums and the
    broadcast back to m are products with the [M, L] indicator (as in the
    JAX package), not ``index_add``, whose CUDA atomics would make forces
    differ from call to call."""
    C = x.shape[-1]
    L = cfg.lmax + 1
    l_of_m = _const(("l_of_m", cfg.lmax), lambda: _l_of_m(cfg.lmax),
                    torch.long, x.device)
    ind = _const(("l_indicator", cfg.lmax),
                 lambda: np.eye(L)[_l_of_m(cfg.lmax)], x.dtype, x.device)
    counts = _const(("counts", L, C), lambda: (2 * np.arange(L) + 1) * C,
                    x.dtype, x.device)
    sq = (x * x).sum(-1)                                    # [..., M]
    rms = torch.sqrt(sq @ ind / counts + eps)               # [..., L]
    inv_m = (1.0 / rms) @ ind.T                             # [..., M]
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


def check_edge_kernel(cfg: ESCNConfig):
    """Raise for a configuration the port does not run: an unknown edge
    layout or edge activation, mmax > lmax, or
    ``edge_grid_scale`` > 1 off the "xla" layout (the kernels bake in
    the fairchem grid; the JAX package asserts the same). The gate
    activation and the full layout run on every layout, through the JAX
    package's plain edge paths (``edge_route``)."""
    if cfg.edge_kernel not in EDGE_LAYOUTS:
        raise ValueError(f"edge_kernel={cfg.edge_kernel!r}: one of "
                         f"{EDGE_LAYOUTS}")
    if cfg.edge_act not in EDGE_ACTS:
        raise ValueError(f"edge_act={cfg.edge_act!r}: one of {EDGE_ACTS}")
    if cfg.mmax > cfg.lmax:
        raise ValueError(f"mmax={cfg.mmax} > lmax={cfg.lmax}")
    if cfg.edge_grid_scale != 1 and cfg.edge_kernel != "xla":
        raise ValueError(
            f"edge_grid_scale={cfg.edge_grid_scale} runs on the \"xla\" "
            f"layout only, not {cfg.edge_kernel!r}: the kernels bake in "
            "fairchem's grid")


def edge_route(cfg: ESCNConfig, sharded: bool = False) -> str:
    """The edge path of every message layer, as the JAX package's
    ``escn_energy`` branches: "full" (the plain full-layout path,
    mmax == lmax), "reduced" (the plain reduced path, which "xla" takes)
    or an edge kernel layout. The full layout and the gate activation
    take the plain paths whatever ``edge_kernel`` says: K1, K3 and K4
    bake in the S2 activation and the reduced layout, and the JAX package
    has no kernel for either. Under a shard "pallas-mega" takes the
    "pallas-full" layout (K1 reads one row set for sources and
    targets)."""
    if cfg.mmax >= cfg.lmax:
        return "full"
    if cfg.edge_act == "gate" or cfg.edge_kernel == "xla":
        return "reduced"
    if sharded and cfg.edge_kernel == "pallas-mega":
        return "pallas-full"
    return cfg.edge_kernel


@lru_cache(maxsize=None)
def _place_map(rows, M):
    """Source row of each of M flat rows: ``rows.index(m)``, or
    ``len(rows)`` (a zero row) for the rows not listed."""
    out = np.full(M, len(rows))
    out[list(rows)] = np.arange(len(rows))
    return out


def _place_rows(y, rows, M):
    """[..., R, c] -> [..., M, c]: y's row j at flat row ``rows[j]``,
    zeros elsewhere (the JAX package's ``.at[..., rows, :].set`` on
    zeros, as a gather)."""
    rows = tuple(int(r) for r in rows)
    idx = _const(("place", rows, M), lambda: _place_map(rows, M),
                 torch.long, y.device)
    if len(rows) < M:
        y = torch.cat([y, y.new_zeros(y.shape[:-2] + (1, y.shape[-1]))], -2)
    return y.index_select(-2, idx)


def _block_diag_rotate(D, x, transpose=False):
    """Rotate [..., M, C] coefficients by the edge-frame Wigner rotation:
    ``D`` is the full block-diagonal [..., M, M] matrix or the per-l block
    list (lmax < 3, as the JAX package picks)."""
    if isinstance(D, (list, tuple)):
        outs = []
        for l, Dl in enumerate(D):  # noqa: E741
            blk = x[..., l * l:(l + 1) ** 2, :]
            Dm = Dl.transpose(-1, -2) if transpose else Dl
            outs.append(torch.einsum("...mn,...nc->...mc", Dm, blk))
        return torch.cat(outs, -2)
    Df = D.transpose(-1, -2) if transpose else D
    return torch.einsum("...mn,...nc->...mc", Df, x)


def _gate_act(p, alpha, x):
    """Equivariant gate on reduced-layout rows [..., U, h]: SiLU on the
    l=0 scalars (row 0); every other row gated channel-wise by
    sigmoid(MoLE(scalars))."""
    s = x[..., 0, :]
    gates = torch.sigmoid(_mole(p, alpha, s))
    return torch.cat([torch.nn.functional.silu(s)[..., None, :],
                      x[..., 1:, :] * gates[..., None, :]], -2)


def _setup(coords_ang, system: PaddedSystem, params, cfg: ESCNConfig,
           shard=None):
    """Everything before the message-passing blocks: routing, radius
    graph, edge frames, edge scalars, initial node features and the
    per-edge inputs every layer's edge path shares. Under ``shard`` (a
    ``parallel.SpatialGroup``) the coordinates come in replicated and
    everything per atom or per edge is this rank's rows only; neighbour
    indices are global. Coordinates [B, P, 3] stack B images of the
    system along the atom axis: B*P rows, each image's radius graph its
    own, its neighbour indices offset by b*P."""
    check_edge_kernel(cfg)
    route = edge_route(cfg, shard is not None)
    dt = cfg.dtype
    dev = coords_ang.device
    K = cfg.max_neighbors
    mask_all, numbers = system.atom_mask, system.numbers
    stacked = coords_ang.dim() == 3
    if stacked:
        if shard is not None:
            raise ValueError("stacked images run unsharded")
        B, Pi = coords_ang.shape[:2]
        idx, nbr_mask = dense_neighbors_images(coords_ang.detach(),
                                               mask_all, cfg.cutoff, K)
        coords_ang = coords_ang.reshape(B * Pi, 3)
        mask_all, numbers = mask_all.repeat(B), numbers.repeat(B)
    P = coords_ang.shape[0]
    i0, n = 0, P
    if shard is not None:
        if P % shard.size:
            raise ValueError(f"padded atoms {P} not divisible by "
                             f"{shard.size} shards")
        coords_ang = shard.replicate_in(coords_ang)
        n = P // shard.size
        i0 = shard.rank * n
    if not stacked:
        # ---- radius graph (nearest-K within cutoff; no gradient) ----------
        idx, nbr_mask = dense_neighbors_rows(coords_ang.detach(), mask_all,
                                             cfg.cutoff, K, i0, n)
    C = cfg.sphere_channels
    M = num_coeffs(cfg.lmax)
    E = n * K
    nl0 = cfg.lmax + 1
    atom_mask = mask_all[i0:i0 + n].to(dt)
    z_all = torch.clamp(numbers, 0, cfg.max_z)            # idx is global
    z = z_all[i0:i0 + n]

    head = params["energy_head"][0]["w"]
    alpha = None if head.ndim == 2 else _route_alpha(params, cfg)
    if isinstance(head, Shard):
        # every rank of the "expert" axis reads its own experts' share
        # of alpha: the cotangents of alpha sum over the axis
        alpha = head.group.replicate_in(alpha)

    nbr_mask = nbr_mask.to(dt)
    vec, dist = neighbor_vectors(
        coords_ang, idx, nbr_mask,
        origin=None if shard is None else coords_ang[i0:i0 + n])
    vec = vec.to(dt)
    dist = dist.to(dt)

    # edge frame; masked slots rotate a safe vector. The reduced routes
    # rotate directly into the |m| <= mmax basis (rows _used_indices);
    # the full layout keeps the block-diagonal matrix (per-l blocks below
    # lmax 3, as the JAX package picks)
    rot = edge_rot_mat(vec + (1.0 - nbr_mask[..., None]))
    used = _used_indices(cfg.lmax, cfg.mmax)
    if route == "full":
        D = (wigner_full(rot, cfg.lmax) if cfg.lmax >= 3
             else wigner_blocks(rot, cfg.lmax))
    else:
        D = wigner_full(rot, cfg.lmax)[
            ..., _const(("used", cfg.lmax, cfg.mmax), lambda: used,
                        torch.long, dev), :]                 # [n,K,U,M]

    # ---- invariant edge scalars -------------------------------------------
    gauss = _gauss_basis(dist, cfg)
    esrc = params["source_embedding"][z_all[idx]]             # [n,K,Ce]
    etgt = params["target_embedding"][z][:, None, :].expand_as(esrc)
    edge_scalar = _apply_linear_stack(params["edge_mlp"],
                                      torch.cat([esrc, etgt, gauss], -1))
    env = (_envelope(dist, cfg) * nbr_mask)[..., None]        # [n,K,1]

    # ---- initial node features ---------------------------------------------
    x = torch.cat([params["sphere_embedding"][z][:, None, :],
                   torch.zeros(n, M - 1, C, dtype=dt, device=dev)], 1)
    deg = _mole(params["edge_degree_proj"], alpha,
                edge_scalar).reshape(n, K, nl0, C)
    if route == "full":
        deg_back = _block_diag_rotate(
            D, _place_rows(deg, used[:nl0], M), transpose=True)
    else:
        deg_back = torch.einsum("pkum,pkuc->pkmc", D[..., :nl0, :], deg)
    x = x + (deg_back * env[..., None]).sum(1) / cfg.avg_degree
    x = x * atom_mask[:, None, None]

    src = idx.reshape(E)
    s = dict(route=route, shard=shard, alpha=alpha, x=x, z=z,
             atom_mask=atom_mask, src=src, live=env.reshape(E) > 0, D=D,
             env=env[..., 0], edge_scalar=edge_scalar,
             es_t=edge_scalar.reshape(E, cfg.edge_channels).T)
    # grid tables: the per-edge activation's (oversampled by
    # edge_grid_scale on "xla") and the node FFN's
    s["edge_tabs"] = tuple(
        _const(("edge", cfg.lmax, cfg.mmax, cfg.edge_grid_scale, i),
               lambda i=i: _edge_grid_tables(cfg.lmax, cfg.mmax,
                                             cfg.edge_grid_scale)[i],
               dt, dev)
        for i in range(2))
    s["node_tabs"] = tuple(
        _const(("node", cfg.lmax, cfg.grid, i),
               lambda i=i: s2_grid_tables(cfg.lmax, *cfg.grid)[i], dt, dev)
        for i in range(2))
    if route in EDGE_KERNELS:
        # the edge kernels' packed Wigner nonzeros, envelope folded into
        # the back-rotation's copy
        nnz = len(_rot_nz(cfg.lmax, cfg.mmax)[0])
        Dp_pk = pack_d(cfg, D)                                # [n,K,nnz]
        s["Dp_t"] = Dp_pk.permute(2, 0, 1).reshape(nnz, E)
        s["Dpe_t"] = (Dp_pk * env).permute(2, 0, 1).reshape(nnz, E)
    return s


def _source_rows(s, cfg: ESCNConfig, xn):
    """Every source row of this rank's edges [E, M*C], gathered from the
    node rows of all ranks (the all-gathered features under a shard). The
    kernel layouts gather with ``gather_src`` (a deterministic CSR
    backward on the card), "xla" with plain indexing (twice
    differentiable: the Hessian closures)."""
    rows = xn if s["shard"] is None else s["shard"].all_gather_rows(xn)
    rows = rows.reshape(rows.shape[0], -1)
    if cfg.edge_kernel == "xla":
        return rows[s["src"]]
    return gather_src(rows, s["src"], s["live"])


_EDGE_FN = {"pallas-mega": fused_edge_mega, "pallas-full": fused_edge_block,
            "pallas": fused_edge_chain}


def _edge_args(s, blk, cfg: ESCNConfig, xn):
    """Arguments of one layer's edge-kernel call (``_EDGE_FN`` of the
    route) from the normalised node features xn [n, M, C]."""
    n, M, C = xn.shape
    K = cfg.max_neighbors
    E = n * K
    route = s["route"]
    w = _pack_conv_weights(blk, s["alpha"], cfg)
    if route == "pallas-mega":
        return (cfg, xn.permute(1, 2, 0).reshape(M * C, n), s["src"],
                s["es_t"], s["Dp_t"], s["Dpe_t"], w, s["edge_tabs"])
    xs = _source_rows(s, cfg, xn)                             # [E, M*C]
    if route == "pallas-full":
        # target rows per edge; the expand's backward is the K-sum
        xt = xn.reshape(n, 1, M * C).expand(n, K, M * C).reshape(E, M * C)
        return (cfg, xs.T, xt.T, s["es_t"], s["Dp_t"], s["Dpe_t"], w,
                s["edge_tabs"])
    # "pallas": rotated pair rows [U*2C, E], u-major, source channels then
    # target channels (escn.py:743-748 of the JAX package), held
    # edge-major so the kernel reads them without a copy
    D = s["D"]
    rot_s = torch.einsum("pkum,pkmc->pkuc", D, xs.reshape(n, K, M, C))
    rot_t = torch.einsum("pkum,pmc->pkuc", D, xn)
    pr = torch.cat([rot_s, rot_t], -1).reshape(E, -1)
    return (cfg, pr.T, s["es_t"], w, s["edge_tabs"])


def _kernel_message(s, cfg: ESCNConfig, args):
    """The K-summed message [n, M, C] of one layer from its edge-kernel
    call (not yet divided by avg_degree)."""
    route = s["route"]
    out = _EDGE_FN[route](*args)
    n, K = s["env"].shape
    if route == "pallas-mega":
        return out.reshape(-1, cfg.sphere_channels, n).permute(2, 0, 1)
    if route == "pallas-full":
        return out.reshape(-1, cfg.sphere_channels, n, K).sum(-1) \
            .permute(2, 0, 1)
    # rotate back x envelope x K-sum in one contraction
    U = s["D"].shape[2]
    out4 = out.reshape(U, cfg.sphere_channels, n, K) * s["env"][None, None]
    return torch.einsum("pkum,ucpk->pmc", s["D"], out4)


def _plain_message(s, blk, cfg: ESCNConfig, xn):
    """The K-summed message [n, M, C] of one layer on the JAX package's
    plain edge paths (``escn.py:761-782``): rotate the (source, target)
    pair into the edge frame, SO(2) conv -> edge activation -> SO(2)
    conv, rotate back, envelope, sum over K. The convs and the
    activation run on the reduced layout (``conv_plain`` and
    ``s2_act_plain``, the kernels' plain chain); the full layout gathers
    its ``_used_indices`` rows for them and places the result back, the
    rows the JAX package's full-layout functions read and write."""
    n, M, C = xn.shape
    K = cfg.max_neighbors
    E = n * K
    D = s["D"]
    x_s = _source_rows(s, cfg, xn).reshape(n, K, M, C)
    # source and target rows rotate apart: the target's [n, M, C] rows
    # broadcast over K instead of a [n, K, M, 2C] pair
    if s["route"] == "full":
        used = _used_indices(cfg.lmax, cfg.mmax)
        ui = _const(("used", cfg.lmax, cfg.mmax), lambda: used, torch.long,
                    xn.device)
        rot_s = _block_diag_rotate(D, x_s).index_select(-2, ui)
        rot_t = _block_diag_rotate(D, xn[:, None]).index_select(-2, ui)
    else:
        rot_s = torch.einsum("nkum,nkmc->nkuc", D, x_s)
        rot_t = torch.einsum("nkum,nmc->nkuc", D, xn)
    pair_u = torch.cat([rot_s, rot_t.expand_as(rot_s)], -1)
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = \
        _pack_conv_weights(blk, s["alpha"], cfg)
    nl0 = cfg.lmax + 1
    nls = [cfg.lmax + 1 - m for m in range(1, cfg.mmax + 1)]
    msg = conv_plain(pair_u.reshape(E, -1, 2 * C),
                     s["edge_scalar"].reshape(E, -1), W0, Wrs, Wis, b0, brs,
                     bis, nl0, nls)
    if cfg.edge_act == "gate":
        msg = _gate_act(blk["gate"], s["alpha"], msg)
    else:
        msg = s2_act_plain(msg, *s["edge_tabs"])
    msg = conv_plain(msg, None, V0, Vrs, Vis, c0, crs, cis, nl0,
                     nls).reshape(n, K, -1, C)
    if s["route"] == "full":
        msg = _block_diag_rotate(D, _place_rows(msg, used, M),
                                 transpose=True)
        return (msg * s["env"][..., None, None]).sum(1)
    # rotate back, envelope and K-sum in one contraction
    return torch.einsum("nkum,nkuc->nmc", D * s["env"][..., None, None],
                        msg)


def _edge_message(s, blk, cfg: ESCNConfig, xn):
    # the gate activation and the full layout take the JAX package's own
    # plain branches on every layout, "pallas-mega" included: K1, K3 and
    # K4 bake in the S2 activation on the reduced layout, and the JAX
    # package has no kernel for either (its Pallas branches require
    # both), so this is its path, not a fallback
    if s["route"] in ("full", "reduced"):
        return _plain_message(s, blk, cfg, xn)
    return _kernel_message(s, cfg, _edge_args(s, blk, cfg, xn))


def _block_ffn_args(s, blk, cfg: ESCNConfig, x):
    """Arguments of one layer's K2 call."""
    xn2 = _equi_rms_norm(x, blk["norm_2"], cfg)
    W1, b1 = _merged_wb(blk["ffn"][0], s["alpha"])
    W2, b2 = _merged_wb(blk["ffn"][1], s["alpha"])
    return (cfg, xn2, (W1, b1, W2, b2), s["node_tabs"])


def _block(s, blk, cfg: ESCNConfig, x):
    mask = s["atom_mask"][:, None, None]
    xn = _equi_rms_norm(x, blk["norm_1"], cfg)
    x = (x + _edge_message(s, blk, cfg, xn) / cfg.avg_degree) * mask
    cfg_, xn2, weights, tables = _block_ffn_args(s, blk, cfg, x)
    ffn = (ffn_plain(xn2, weights, tables) if cfg.edge_kernel == "xla"
           else fused_node_ffn(cfg_, xn2, weights, tables))
    return (x + ffn) * mask


def first_layer_kernel_args(coords_ang, system, params, cfg: ESCNConfig,
                            shard=None):
    """(edge-kernel args, K2 args, source gather) of the first message
    layer, exactly as the force call builds them for ``cfg.edge_kernel``
    (an S2 reduced configuration) on this rank of ``shard`` — the inputs
    a kernel check runs at. The source gather is (the node rows of all
    ranks [P, M*C], each edge's source, each edge's live flag): the
    inputs of ``gather_src`` on the layouts that gather."""
    s = _setup(coords_ang, system, params, cfg, shard)
    if s["route"] not in EDGE_KERNELS:
        raise ValueError(f"the {s['route']} edge path calls no edge kernel")
    blk = params["blocks"][0]
    xn = _equi_rms_norm(s["x"], blk["norm_1"], cfg)
    edge_args = _edge_args(s, blk, cfg, xn)
    msg = _kernel_message(s, cfg, edge_args)
    x = (s["x"] + msg / cfg.avg_degree) * s["atom_mask"][:, None, None]
    rows = xn if shard is None else shard.all_gather_rows(xn)
    return (edge_args, _block_ffn_args(s, blk, cfg, x),
            (rows.reshape(rows.shape[0], -1), s["src"], s["live"]))


def _atom_energies(coords_ang, system, params, cfg: ESCNConfig, shard):
    """Every row's energy in eV [n] (padding rows zero): the blocks and
    the energy head over ``_setup``'s rows."""
    params = _whole_model(params)
    s = _setup(coords_ang, system, params, cfg, shard)
    x = s["x"]
    for blk in params["blocks"]:
        if cfg.remat_blocks:
            x = torch.utils.checkpoint.checkpoint(_block, s, blk, cfg, x,
                                                  use_reentrant=False)
        else:
            x = _block(s, blk, cfg, x)
    alpha, z, atom_mask = s["alpha"], s["z"], s["atom_mask"]
    xn = _equi_rms_norm(x, params["energy_norm"], cfg)
    e = torch.nn.functional.silu(_mole(params["energy_head"][0], alpha,
                                       xn[:, 0, :]))
    e_atom = _mole(params["energy_head"][1], alpha, e)[..., 0]
    e_ref = params["atom_ref"].to(cfg.dtype)[z]
    return (e_atom + e_ref) * atom_mask


def escn_energy(coords_ang, system: PaddedSystem, params, cfg: ESCNConfig,
                shard=None):
    """Total potential energy in eV of one padded system; coords [P, 3].

    With ``shard`` (a ``parallel.SpatialGroup``) this runs spatially
    partitioned, as the JAX package's ``escn_energy`` inside a
    ``shard_map``: each rank owns P/n atom rows (its neighbour slab, edge
    frames, messages and node features), all-gathers the normalised node
    features once a layer and returns the energy summed over ranks, the
    same on every rank."""
    e = _atom_energies(coords_ang, system, params, cfg, shard).sum()
    return e if shard is None else shard.sum_out(e)


def escn_energy_images(coords_ang, system: PaddedSystem, params,
                       cfg: ESCNConfig):
    """The energies in eV [B] of B images of one system, coords [B, P, 3],
    in one pass: the images stacked along the atom axis (B*P rows, B*P*K
    edges, each image's radius graph its own), so every layer launches
    each kernel of the route once for all of them, and the energies are
    the per-image sums of the atom energies. The counterpart of the JAX
    calculator's ``lax.map(batch_size=B)``, which vmaps each
    ``pallas_call`` over a grid axis. A call holds at most
    ``stack_limit(cfg, P)`` images."""
    B, P = coords_ang.shape[:2]
    if B > stack_limit(cfg, P):
        raise ValueError(f"{B} stacked images of {P} atoms: at most "
                         f"{stack_limit(cfg, P)} (32-bit kernel offsets)")
    return _atom_energies(coords_ang, system, params, cfg,
                          None).reshape(B, P).sum(1)


_INT32_ELEMS = 2 ** 31 - 1


def stack_limit(cfg: ESCNConfig, n_pad: int) -> int:
    """Most images of ``n_pad`` atoms one stacked call may hold: the edge
    and node-FFN kernels address their buffers with 32-bit offsets, so no
    buffer of a launch may reach 2^31 elements. Per image the largest are
    the edge rows [P*K, U*2C + Ce] and [P*K, U*max(H, C)], the gathered
    [P*K, M*C] rows and K2's (node, grid point) rows [G*P, max(F, C)]."""
    M = num_coeffs(cfg.lmax)
    U = len(_used_indices(cfg.lmax, cfg.mmax))
    C, H = cfg.sphere_channels, cfg.hidden_channels
    E = n_pad * cfg.max_neighbors
    nt, nph = cfg.grid
    per = max(E * (U * 2 * C + cfg.edge_channels), E * U * max(H, C),
              E * M * C, nt * nph * n_pad * max(cfg.ffn_hidden, C))
    return max(1, _INT32_ELEMS // per)


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


def escn_energy_images_fn(cfg: ESCNConfig):
    """The Calculator's stacked-images closure (coords [B, P, 3], system,
    params) -> eV [B]; ``fn.max_images(P)`` is ``stack_limit``."""
    def fn(coords, system, params):
        return escn_energy_images(coords, system, params, cfg)
    fn.max_images = lambda n_pad: stack_limit(cfg, n_pad)
    return fn
