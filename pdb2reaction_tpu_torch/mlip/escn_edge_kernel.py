"""K1: the eSCN node-resident edge-message layer (``fused_edge_mega``).

Counterpart of ``pdb2reaction_tpu/mlip/escn_edge_kernel.py``
``fused_edge_mega`` with the same public layout:

    fused_edge_mega(cfg, x_t [M*C, P], src [E], es [Ce, E], Dp [nnz, E],
                    Dpe [nnz, E], weights (12-tuple), (tg, fg)) -> [M*C, P]

Edges are target-major (``E = P*K``, edge ``p*K + k``). For each edge it
gathers the source and target node rows, rotates them into the reduced
|m| <= mmax edge-frame basis with the packed Wigner nonzeros ``Dp``, runs
SO(2) conv 1 -> separable S2 activation -> SO(2) conv 2, rotates back with
``Dpe`` (envelope folded in) and sums the K edges of each target atom.

The device picks the implementation: CPU tensors take the plain PyTorch
version (``fused_edge_mega_plain``, differentiable by autograd), CUDA
tensors the hand-written kernel (``csrc/escn_edge.cu``) behind
``torch.autograd.Function`` with a kernel backward too. The kernel runs
f32 and raises on anything else, and it computes input cotangents only:
it raises if a weight requires grad (weight gradients belong to the
training port).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .so3 import _const

# launches of the CUDA kernels, counted where each is launched
launches = {"fused_edge_mega_fwd": 0, "fused_edge_mega_bwd": 0}


def _dims(cfg):
    nl0 = cfg.lmax + 1
    nls = [cfg.lmax + 1 - m for m in range(1, cfg.mmax + 1)]
    U = nl0 + 2 * sum(nls)
    G = 2 * (cfg.lmax + 1) * (2 * cfg.mmax + 1)
    return nl0, nls, U, G


@lru_cache(maxsize=None)
def _rot_nz(lmax, mmax):
    """Static sparsity of the reduced Wigner selection D_sel [U, M]:
    (u_list, m_list) of its nonzero entries in packed order, plus the
    packed indices grouped by u and by m."""
    u_l = list(range(lmax + 1))                       # m0 rows
    for m in range(1, mmax + 1):
        u_l += list(range(m, lmax + 1))               # +m rows
        u_l += list(range(m, lmax + 1))               # -m rows
    u_list, m_list = [], []
    for u, l in enumerate(u_l):                       # noqa: E741
        for mf in range(l * l, (l + 1) ** 2):
            u_list.append(u)
            m_list.append(mf)
    by_u, by_m = {}, {}
    for j, (u, mf) in enumerate(zip(u_list, m_list)):
        by_u.setdefault(u, []).append(j)
        by_m.setdefault(mf, []).append(j)
    return tuple(u_list), tuple(m_list), \
        tuple(tuple(by_u[u]) for u in sorted(by_u)), \
        tuple(tuple(by_m.get(mf, ())) for mf in range((lmax + 1) ** 2))


def _packed_flat(cfg, device):
    """Flat u*M + m index of each packed nonzero of D_sel [U, M]."""
    M = (cfg.lmax + 1) ** 2
    u_list, m_list, _, _ = _rot_nz(cfg.lmax, cfg.mmax)
    return _const(("packed", cfg.lmax, cfg.mmax),
                  lambda: np.asarray(u_list) * M + np.asarray(m_list),
                  torch.long, device)


def pack_d(cfg, D_sel):
    """[..., U, M] -> packed nonzeros [..., nnz]."""
    return D_sel.flatten(-2)[..., _packed_flat(cfg, D_sel.device)]


def _unpack_d(cfg, Dp):
    """Packed [nnz, E] -> dense [E, U, M] (differentiable)."""
    nl0, nls, U, G = _dims(cfg)
    M = (cfg.lmax + 1) ** 2
    flat = _packed_flat(cfg, Dp.device)
    E = Dp.shape[1]
    return Dp.new_zeros(E, U * M).index_copy(1, flat, Dp.T).reshape(E, U, M)


def _silu(x):
    return torch.nn.functional.silu(x)


def conv_plain(x, es, W0, Ws_r, Ws_i, b0, bs_p, bs_n, nl0, nls):
    """SO(2) conv on the reduced layout x [E, U, c_in] with the packed
    (+-m effective-bias) weights; es [E, Ce] joins the m0 block."""
    E = x.shape[0]
    c_in = x.shape[-1]
    x0 = x[:, :nl0].reshape(E, nl0 * c_in)
    if es is not None:
        x0 = torch.cat([x0, es], dim=-1)
    c_out = W0.shape[1] // nl0
    outs = [(x0 @ W0 + b0).reshape(E, nl0, c_out)]
    off = nl0
    for Wr, Wi, bp, bn, nl in zip(Ws_r, Ws_i, bs_p, bs_n, nls):
        xp = x[:, off:off + nl].reshape(E, nl * c_in)
        xn = x[:, off + nl:off + 2 * nl].reshape(E, nl * c_in)
        outs.append((xp @ Wr - xn @ Wi + bp).reshape(E, nl, c_out))
        outs.append((xp @ Wi + xn @ Wr + bn).reshape(E, nl, c_out))
        off += 2 * nl
    return torch.cat(outs, dim=1)


def s2_act_plain(msg, tg, fg):
    """Separable S2 activation on [E, U, h]: SiLU on the grid, projected
    back; row 0 takes SiLU of the l=0 scalars."""
    grid = torch.einsum("gu,euc->egc", tg, msg)
    back = torch.einsum("ug,egc->euc", fg, _silu(grid))
    return torch.cat([_silu(msg[:, :1]), back[:, 1:]], dim=1)


def fused_edge_mega_plain(cfg, x_t, src, es, Dp, Dpe, weights, tables):
    """Plain PyTorch K1 (any dtype, any device, autograd-differentiable)."""
    nl0, nls, U, G = _dims(cfg)
    M = (cfg.lmax + 1) ** 2
    C = cfg.sphere_channels
    K = cfg.max_neighbors
    P = x_t.shape[1]
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = weights
    tg, fg = tables
    xn = x_t.reshape(M, C, P).permute(2, 0, 1)               # [P, M, C]
    Dd = _unpack_d(cfg, Dp)
    Dde = _unpack_d(cfg, Dpe)
    xs = xn[src]                                             # [E, M, C]
    xt = xn.repeat_interleave(K, dim=0)
    pr = torch.cat([torch.einsum("eum,emc->euc", Dd, xs),
                    torch.einsum("eum,emc->euc", Dd, xt)], dim=-1)
    msg = conv_plain(pr, es.T, W0, Wrs, Wis, b0, brs, bis, nl0, nls)
    act = s2_act_plain(msg, tg, fg)
    out = conv_plain(act, None, V0, Vrs, Vis, c0, crs, cis, nl0, nls)
    back = torch.einsum("eum,euc->emc", Dde, out)            # [E, M, C]
    y = back.reshape(P, K, M, C).sum(1)
    return y.permute(1, 2, 0).reshape(M * C, P)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/escn_edge.cu)
# ---------------------------------------------------------------------------

def _merge(A, B):
    """[[A, B], [-B, A]]: one m>0 real/imag pair as one row-vector block."""
    return torch.cat([torch.cat([A, B], 1), torch.cat([-B, A], 1)], 0)


def _pack_weights(weights):
    """Packed row-vector [in, out] blocks and biases for conv 1 and conv 2,
    plus the transposed packs the backward multiplies by."""
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = weights
    w1 = [W0] + [_merge(a, b) for a, b in zip(Wrs, Wis)]
    w2 = [V0] + [_merge(a, b) for a, b in zip(Vrs, Vis)]
    bb1 = [b0] + [torch.cat([p, n]) for p, n in zip(brs, bis)]
    bb2 = [c0] + [torch.cat([p, n]) for p, n in zip(crs, cis)]

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts]).float().contiguous()

    return (flat(w1), flat(bb1), flat(w2), flat(bb2),
            flat([w.T for w in w1]), flat([w.T for w in w2]))


@lru_cache(maxsize=None)
def _tables_np(lmax, mmax):
    u_list, m_list, by_u, by_m = _rot_nz(lmax, mmax)

    def csr(groups):
        ptr = np.cumsum([0] + [len(g) for g in groups])
        return ptr, np.concatenate([np.asarray(g, int) for g in groups])

    byu_ptr, byu_idx = csr(by_u)
    bym_ptr, bym_idx = csr(by_m)
    return np.concatenate([u_list, m_list, byu_ptr, byu_idx, bym_ptr,
                           bym_idx]).astype(np.int32)


def _tables_dev(cfg, device):
    return _const(("rot_tables", cfg.lmax, cfg.mmax),
                  lambda: _tables_np(cfg.lmax, cfg.mmax), torch.int32, device)


def _check_cuda(name, *ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be on the same CUDA "
                             "device")
        if t.dtype not in (torch.float32, torch.int64):
            raise TypeError(f"{name}: the CUDA kernel runs float32; got "
                            f"{t.dtype}")


class _MegaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, x_t, src, es, Dp, Dpe, packed, tg, fg):
        from .cuda_build import call, load, ptr, stream_ptr
        nl0, nls, U, G = _dims(cfg)
        M = (cfg.lmax + 1) ** 2
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        K = cfg.max_neighbors
        P = x_t.shape[1]
        E = P * K
        nnz = Dp.shape[0]
        assert src.shape[0] == E, (src.shape, P, K)
        w1, b1, w2, b2, w1t, w2t = packed
        x_node = x_t.T.contiguous()
        src = src.contiguous()
        es_e = es.T.contiguous()
        dp_e = Dp.T.contiguous()
        dpe_e = Dpe.T.contiguous()
        tg = tg.contiguous()
        fg = fg.contiguous()
        tabs = _tables_dev(cfg, x_t.device)
        dev = dict(device=x_t.device, dtype=torch.float32)
        abuf = torch.empty(E, U * 2 * C + Ce, **dev)
        msg = torch.empty(E, U * H, **dev)
        act = torch.empty(E, U * H, **dev)
        outsv = torch.empty(E, U * C, **dev)
        y = torch.empty(P, M * C, **dev)
        call(load("escn_edge"), "k1_fwd", P, K, C, H, Ce, cfg.lmax,
             cfg.mmax, nnz, G, ptr(x_node), ptr(src), ptr(es_e), ptr(dp_e),
             ptr(dpe_e), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(tg),
             ptr(fg), ptr(tabs), ptr(abuf), ptr(msg), ptr(act), ptr(outsv),
             ptr(y), stream_ptr())
        launches["fused_edge_mega_fwd"] += 1
        ctx.cfg = cfg
        ctx.save_for_backward(x_node, src, dp_e, dpe_e, msg, outsv, w1t,
                              w2t, tg, fg)
        return y.T

    @staticmethod
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        cfg = ctx.cfg
        x_node, src, dp_e, dpe_e, msg, outsv, w1t, w2t, tg, fg = \
            ctx.saved_tensors
        nl0, nls, U, G = _dims(cfg)
        M = (cfg.lmax + 1) ** 2
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        K = cfg.max_neighbors
        P = x_node.shape[0]
        E = P * K
        nnz = dp_e.shape[1]
        g_node = g.T.contiguous().float()
        # source-sorted edge permutation (CSR) for the deterministic
        # source scatter. Edges whose Dpe row is all zero (masked slots,
        # which all point at atom 0) contribute exactly nothing: they go
        # to a bucket past the last atom, so atom 0's block does not walk
        # every masked edge of the system.
        key = torch.where(dpe_e.abs().amax(1) > 0, src,
                          torch.full_like(src, P))
        order = torch.argsort(key, stable=True)
        src_ptr = torch.searchsorted(
            key[order], torch.arange(P + 1, device=src.device)
        ).to(torch.int32)          # (bincount would wait on the host)
        perm = order.to(torch.int32)
        tabs = _tables_dev(cfg, x_node.device)
        dev = dict(device=x_node.device, dtype=torch.float32)
        gout = torch.empty(E, U * C, **dev)
        gact = torch.empty(E, U * H, **dev)
        gpr = torch.empty(E, U * 2 * C + Ce, **dev)
        gx = torch.empty(P, M * C, **dev)
        gdp = torch.empty(E, nnz, **dev)
        gdpe = torch.empty(E, nnz, **dev)
        call(load("escn_edge"), "k1_bwd", P, K, C, H, Ce, cfg.lmax,
             cfg.mmax, nnz, G, ptr(x_node), ptr(g_node), ptr(src),
             ptr(src_ptr), ptr(perm), ptr(dp_e), ptr(dpe_e), ptr(msg),
             ptr(outsv), ptr(w1t), ptr(w2t), ptr(tg), ptr(fg), ptr(tabs),
             ptr(gout), ptr(gact), ptr(gpr), ptr(gx), ptr(gdp), ptr(gdpe),
             stream_ptr())
        launches["fused_edge_mega_bwd"] += 1
        ges = gpr[:, nl0 * 2 * C:nl0 * 2 * C + Ce].T
        return None, gx.T, None, ges, gdp.T, gdpe.T, None, None, None


def _flat_weights(weights):
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = weights
    return [W0, *Wrs, *Wis, b0, *brs, *bis, V0, *Vrs, *Vis, c0, *crs, *cis]


def fused_edge_mega(cfg, x_t, src, es, Dp, Dpe, weights, tables):
    """K1: K-summed node message update [M*C, P] (the caller divides by
    avg_degree). ``src`` [E] is the integer source atom of each edge."""
    if not x_t.is_cuda:
        return fused_edge_mega_plain(cfg, x_t, src, es, Dp, Dpe, weights,
                                     tables)
    flat = _flat_weights(weights)
    if any(w.requires_grad for w in flat):
        raise NotImplementedError(
            "fused_edge_mega's CUDA kernel computes input cotangents only; "
            "weight gradients (training) are a later port item")
    tg, fg = tables
    _check_cuda("fused_edge_mega", x_t, src, es, Dp, Dpe, tg, fg, *flat)
    if src.dtype != torch.int64:
        raise TypeError("fused_edge_mega: src must be int64 atom indices")
    nl0, nls, U, G = _dims(cfg)
    if U > 32 or cfg.mmax > 4:
        raise ValueError("fused_edge_mega's CUDA kernel takes U <= 32 "
                         "reduced rows and mmax <= 4")
    return _MegaFn.apply(cfg, x_t, src, es, Dp, Dpe, _pack_weights(weights),
                         tg, fg)
