"""The eSCN edge-message kernels K1, K3 and K4.

Counterparts of ``pdb2reaction_tpu/mlip/escn_edge_kernel.py`` with the
same public layouts (features x edges, edges target-major: ``E = P*K``,
edge ``p*K + k``):

    fused_edge_mega(cfg, x_t [M*C, P], src [E], es [Ce, E], Dp [nnz, E],
                    Dpe [nnz, E], weights (12-tuple), (tg, fg)) -> [M*C, P]
    fused_edge_block(cfg, xs_t [M*C, E], xt_t [M*C, E], es, Dp, Dpe,
                     weights, tables) -> [M*C, E]
    fused_edge_chain(cfg, pr [U*2C, E], es, weights, tables) -> [U*C, E]

K1 (``edge_kernel="pallas-mega"``) gathers the source and target node
rows of each edge, rotates them into the reduced |m| <= mmax edge-frame
basis with the packed Wigner nonzeros ``Dp``, runs SO(2) conv 1 ->
separable S2 activation -> SO(2) conv 2, rotates back with ``Dpe``
(envelope folded in) and sums the K edges of each target atom. K3
(``"pallas-full"``) runs the same chain on per-edge source and target
rows the caller gathered and returns the back-rotated message per edge
(the caller K-sums it). K4 (``"pallas"``) runs only conv 1 -> S2
activation -> conv 2 on pair rows the caller rotated.

The device picks the implementation: CPU tensors take the plain PyTorch
versions (``*_plain``, differentiable by autograd), CUDA tensors the
hand-written kernels (``csrc/escn_edge.cu``) behind
``torch.autograd.Function`` with a kernel backward too. The kernels run
f32 and raise on anything else. Their backwards compute the input
cotangents; where a weight requires grad, its cotangent comes from a
replay of the plain version under autograd inside the backward (the JAX
package's ``custom_vjp`` rules replay the chain in XLA for it), and
nothing is replayed when none does. The backwards are first order only
(``cuda_build.first_order``). ``gather_src`` is the callers' source
gather on the K3/K4 paths, with a deterministic backward on CUDA.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .cuda_build import first_order
from .so3 import _const

# launches of the CUDA kernels, counted where each is launched
launches = {"fused_edge_mega_fwd": 0, "fused_edge_mega_bwd": 0,
            "fused_edge_block_fwd": 0, "fused_edge_block_bwd": 0,
            "fused_edge_chain_fwd": 0, "fused_edge_chain_bwd": 0}


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
    """Separable S2 activation on [..., U, h]: SiLU on the grid, projected
    back; row 0 takes SiLU of the l=0 scalars."""
    grid = torch.einsum("gu,...uc->...gc", tg, msg)
    back = torch.einsum("ug,...gc->...uc", fg, _silu(grid))
    return torch.cat([_silu(msg[..., :1, :]), back[..., 1:, :]], dim=-2)


def _chain_plain(pr, es_e, weights, tables, nl0, nls):
    """conv 1 -> S2 act -> conv 2: pr [E, U, 2C], es_e [E, Ce] -> [E, U, C]."""
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = weights
    tg, fg = tables
    msg = conv_plain(pr, es_e, W0, Wrs, Wis, b0, brs, bis, nl0, nls)
    act = s2_act_plain(msg, tg, fg)
    return conv_plain(act, None, V0, Vrs, Vis, c0, crs, cis, nl0, nls)


def _block_plain(cfg, xs, xt, es, Dp, Dpe, weights, tables):
    """Rotate per-edge rows xs, xt [E, M, C], run the chain and rotate
    back: [E, M, C]."""
    nl0, nls, U, G = _dims(cfg)
    Dd = _unpack_d(cfg, Dp)
    pr = torch.cat([torch.einsum("eum,emc->euc", Dd, xs),
                    torch.einsum("eum,emc->euc", Dd, xt)], dim=-1)
    out = _chain_plain(pr, es.T, weights, tables, nl0, nls)
    return torch.einsum("eum,euc->emc", _unpack_d(cfg, Dpe), out)


def fused_edge_mega_plain(cfg, x_t, src, es, Dp, Dpe, weights, tables):
    """Plain PyTorch K1 (any dtype, any device, autograd-differentiable)."""
    M = (cfg.lmax + 1) ** 2
    C = cfg.sphere_channels
    K = cfg.max_neighbors
    P = x_t.shape[1]
    xn = x_t.reshape(M, C, P).permute(2, 0, 1)               # [P, M, C]
    back = _block_plain(cfg, xn[src], xn.repeat_interleave(K, dim=0), es,
                        Dp, Dpe, weights, tables)            # [E, M, C]
    y = back.reshape(P, K, M, C).sum(1)
    return y.permute(1, 2, 0).reshape(M * C, P)


def fused_edge_block_plain(cfg, xs_t, xt_t, es, Dp, Dpe, weights, tables):
    """Plain PyTorch K3: per-edge back-rotated messages [M*C, E]."""
    M = (cfg.lmax + 1) ** 2
    C = cfg.sphere_channels
    E = xs_t.shape[1]
    back = _block_plain(cfg, xs_t.reshape(M, C, E).permute(2, 0, 1),
                        xt_t.reshape(M, C, E).permute(2, 0, 1), es, Dp, Dpe,
                        weights, tables)
    return back.permute(1, 2, 0).reshape(M * C, E)


def fused_edge_chain_plain(cfg, pr, es, weights, tables):
    """Plain PyTorch K4: pr [U*2C, E] (u-major rotated pair rows, source
    channels then target channels) -> [U*C, E]."""
    nl0, nls, U, G = _dims(cfg)
    E = pr.shape[1]
    out = _chain_plain(pr.reshape(U, -1, E).permute(2, 0, 1), es.T, weights,
                       tables, nl0, nls)                     # [E, U, C]
    return out.permute(1, 2, 0).reshape(-1, E)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/escn_edge.cu)
# ---------------------------------------------------------------------------

def _merge(A, B):
    """[[A, B], [-B, A]]: one m>0 real/imag pair as one row-vector block."""
    return torch.cat([torch.cat([A, B], 1), torch.cat([-B, A], 1)], 0)


def _pack_weights(weights):
    """Packed row-vector [in, out] blocks and biases for conv 1 and conv 2,
    plus the transposed [out, in] packs. The kernels' conv products read
    both operands k-contiguous: the forward multiplies by the transposed
    packs, the backward by the untransposed ones."""
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
        if not t.is_cuda or t.device != ts[0].device:
            raise ValueError(f"{name}: all inputs must be on the same CUDA "
                             "device")
        if t.dtype not in (torch.float32, torch.int64):
            raise TypeError(f"{name}: the CUDA kernel runs float32; got "
                            f"{t.dtype}")


def _src_csr(src, live, P):
    """Source-sorted edge permutation (CSR) for a deterministic source
    scatter: (ptr [P+1], perm) int32, the edges of atom p in
    perm[ptr[p]:ptr[p+1]] in edge order. Edges with ``live`` False go to
    a bucket past the last atom: masked slots all point at atom 0 and
    carry exactly zero cotangent, so atom 0 does not walk them."""
    key = torch.where(live, src, torch.full_like(src, P))
    order = torch.argsort(key, stable=True)
    ptr = torch.searchsorted(
        key[order], torch.arange(P + 1, device=src.device)
    ).to(torch.int32)              # (bincount would wait on the host)
    return ptr, order.to(torch.int32)


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, live):
        ctx.save_for_backward(src, live)
        ctx.P = x.shape[0]
        return x.index_select(0, src)

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        src, live = ctx.saved_tensors
        g = g.contiguous()
        src_ptr, perm = _src_csr(src, live, ctx.P)
        gx = g.new_empty(ctx.P, g.shape[1])
        call(load("escn_edge"), "src_scatter", ctx.P, g.shape[1],
             ptr(src_ptr), ptr(perm), ptr(g), ptr(gx), stream_ptr())
        return gx, None, None


def gather_src(x, src, live):
    """Rows ``x[src]`` [E, F] of node rows x [P, F]. On CUDA the backward
    sums each atom's edge cotangents in edge order over a source-sorted
    CSR (``src_scatter``; no atomics, so forces repeat bit for bit) and
    leaves out the edges with ``live`` False, whose cotangents must be
    exactly zero (masked slots). On the CPU it is plain ``x[src]``."""
    if not x.is_cuda:
        return x[src]
    _check_cuda("gather_src", x, src)
    if live.device != x.device or src.shape != live.shape:
        raise ValueError("gather_src: live must be one flag per edge on "
                         "the device of x")
    return _GatherFn.apply(x, src, live)


def _flat_weights(weights):
    (W0, Wrs, Wis, b0, brs, bis, V0, Vrs, Vis, c0, crs, cis) = weights
    return [W0, *Wrs, *Wis, b0, *brs, *bis, V0, *Vrs, *Vis, c0, *crs, *cis]


def _unflat_weights(flat):
    """The 12-tuple of ``_flat_weights``' list."""
    nm = (len(flat) - 4) // 8                 # mmax
    it = iter(flat)

    def take(k):
        return tuple(next(it) for _ in range(k))

    out = []
    for _ in range(2):                        # conv 1, conv 2
        W0, Wrs, Wis = next(it), take(nm), take(nm)
        b0, brs, bis = next(it), take(nm), take(nm)
        out += [W0, Wrs, Wis, b0, brs, bis]
    return tuple(out)


def _save(ctx, kernel_saved, replay):
    """Save the kernel backward's tensors and, when a weight (the last
    ``ctx.n_w`` arguments) requires grad, the inputs and weights of the
    plain replay too."""
    ctx.n_kernel = len(kernel_saved)
    ctx.need_w = any(ctx.needs_input_grad[-ctx.n_w:])
    ctx.save_for_backward(*kernel_saved, *(replay if ctx.need_w else ()))


def _weight_cotangents(ctx, plain, g):
    """The cotangents of the flat weights (None where none is needed):
    the plain version replayed on the saved inputs under autograd, and
    differentiated with respect to the weights alone."""
    needs = ctx.needs_input_grad[-ctx.n_w:]
    if not ctx.need_w:
        return (None,) * ctx.n_w
    replay = [t.detach() for t in ctx.saved_tensors[ctx.n_kernel:]]
    args, tables = replay[:-ctx.n_w - 2], replay[-ctx.n_w - 2:-ctx.n_w]
    ws = [w.requires_grad_(n) for w, n in zip(replay[-ctx.n_w:], needs)]
    with torch.enable_grad():
        y = plain(ctx.cfg, *args, _unflat_weights(ws), tables)
        gw = iter(torch.autograd.grad(y, [w for w in ws if w.requires_grad],
                                      g))
    return tuple(next(gw) if n else None for n in needs)


class _MegaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, x_t, src, es, Dp, Dpe, tg, fg, *flat):
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
        w1, b1, w2, b2, w1t, w2t = _pack_weights(_unflat_weights(flat))
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
             ptr(dpe_e), ptr(w1t), ptr(b1), ptr(w2t), ptr(b2), ptr(tg),
             ptr(fg), ptr(tabs), ptr(abuf), ptr(msg), ptr(act), ptr(outsv),
             ptr(y), stream_ptr())
        launches["fused_edge_mega_fwd"] += 1
        ctx.cfg, ctx.n_w = cfg, len(flat)
        _save(ctx, (x_node, src, dp_e, dpe_e, msg, outsv, w1, w2, tg, fg),
              (x_t, src, es, Dp, Dpe, tg, fg, *flat))
        return y.T

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        cfg = ctx.cfg
        x_node, src, dp_e, dpe_e, msg, outsv, w1, w2, tg, fg = \
            ctx.saved_tensors[:ctx.n_kernel]
        nl0, nls, U, G = _dims(cfg)
        M = (cfg.lmax + 1) ** 2
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        K = cfg.max_neighbors
        P = x_node.shape[0]
        E = P * K
        nnz = dp_e.shape[1]
        g_node = g.T.contiguous().float()
        # edges whose Dpe row is all zero (masked slots) contribute
        # exactly nothing to the source scatter
        src_ptr, perm = _src_csr(src, dpe_e.abs().amax(1) > 0, P)
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
             ptr(outsv), ptr(w1), ptr(w2), ptr(tg), ptr(fg), ptr(tabs),
             ptr(gout), ptr(gact), ptr(gpr), ptr(gx), ptr(gdp), ptr(gdpe),
             stream_ptr())
        launches["fused_edge_mega_bwd"] += 1
        ges = gpr[:, nl0 * 2 * C:nl0 * 2 * C + Ce].T
        return (None, gx.T, None, ges, gdp.T, gdpe.T, None, None,
                *_weight_cotangents(ctx, fused_edge_mega_plain, g))


class _BlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, xs_t, xt_t, es, Dp, Dpe, tg, fg, *flat):
        from .cuda_build import call, load, ptr, stream_ptr
        nl0, nls, U, G = _dims(cfg)
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        MC, E = xs_t.shape
        nnz = Dp.shape[0]
        w1, b1, w2, b2, w1t, w2t = _pack_weights(_unflat_weights(flat))
        # edge-major rows; no copy when the caller built [E, M*C] rows
        xs, xt = xs_t.T.contiguous(), xt_t.T.contiguous()
        es_e, dp_e, dpe_e = (t.T.contiguous() for t in (es, Dp, Dpe))
        tg, fg = tg.contiguous(), fg.contiguous()
        dev = dict(device=xs.device, dtype=torch.float32)
        abuf = torch.empty(E, U * 2 * C + Ce, **dev)
        msg = torch.empty(E, U * H, **dev)
        act = torch.empty(E, U * H, **dev)
        outsv = torch.empty(E, U * C, **dev)
        y = torch.empty(E, MC, **dev)
        call(load("escn_edge"), "k3_fwd", E, C, H, Ce, cfg.lmax, cfg.mmax,
             nnz, G, ptr(xs), ptr(xt), ptr(es_e), ptr(dp_e), ptr(dpe_e),
             ptr(w1t), ptr(b1), ptr(w2t), ptr(b2), ptr(tg), ptr(fg),
             ptr(_tables_dev(cfg, xs.device)), ptr(abuf), ptr(msg), ptr(act),
             ptr(outsv), ptr(y), stream_ptr())
        launches["fused_edge_block_fwd"] += 1
        ctx.cfg, ctx.n_w = cfg, len(flat)
        _save(ctx, (xs, xt, dp_e, dpe_e, msg, outsv, w1, w2, tg, fg),
              (xs_t, xt_t, es, Dp, Dpe, tg, fg, *flat))
        return y.T

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        cfg = ctx.cfg
        xs, xt, dp_e, dpe_e, msg, outsv, w1, w2, tg, fg = \
            ctx.saved_tensors[:ctx.n_kernel]
        nl0, nls, U, G = _dims(cfg)
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        E, MC = xs.shape
        nnz = dp_e.shape[1]
        gy = g.T.contiguous().float()
        dev = dict(device=xs.device, dtype=torch.float32)
        gout = torch.empty(E, U * C, **dev)
        gact = torch.empty(E, U * H, **dev)
        gpr = torch.empty(E, U * 2 * C + Ce, **dev)
        gxs = torch.empty(E, MC, **dev)
        gxt = torch.empty(E, MC, **dev)
        gdp = torch.empty(E, nnz, **dev)
        gdpe = torch.empty(E, nnz, **dev)
        call(load("escn_edge"), "k3_bwd", E, C, H, Ce, cfg.lmax, cfg.mmax,
             nnz, G, ptr(xs), ptr(xt), ptr(gy), ptr(dp_e), ptr(dpe_e),
             ptr(msg), ptr(outsv), ptr(w1), ptr(w2), ptr(tg), ptr(fg),
             ptr(_tables_dev(cfg, xs.device)), ptr(gout), ptr(gact),
             ptr(gpr), ptr(gxs), ptr(gxt), ptr(gdp), ptr(gdpe), stream_ptr())
        launches["fused_edge_block_bwd"] += 1
        ges = gpr[:, nl0 * 2 * C:nl0 * 2 * C + Ce].T
        return (None, gxs.T, gxt.T, ges, gdp.T, gdpe.T, None, None,
                *_weight_cotangents(ctx, fused_edge_block_plain, g))


class _ChainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, pr, es, tg, fg, *flat):
        from .cuda_build import call, load, ptr, stream_ptr
        nl0, nls, U, G = _dims(cfg)
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        E = pr.shape[1]
        w1, b1, w2, b2, w1t, w2t = _pack_weights(_unflat_weights(flat))
        pr_e, es_e = pr.T.contiguous(), es.T.contiguous()
        tg, fg = tg.contiguous(), fg.contiguous()
        dev = dict(device=pr.device, dtype=torch.float32)
        x0 = torch.empty(E, nl0 * 2 * C + Ce, **dev)
        msg = torch.empty(E, U * H, **dev)
        act = torch.empty(E, U * H, **dev)
        out = torch.empty(E, U * C, **dev)
        call(load("escn_edge"), "k4_fwd", E, C, H, Ce, cfg.lmax, cfg.mmax, G,
             ptr(pr_e), ptr(es_e), ptr(w1t), ptr(b1), ptr(w2t), ptr(b2),
             ptr(tg), ptr(fg), ptr(x0), ptr(msg), ptr(act), ptr(out),
             stream_ptr())
        launches["fused_edge_chain_fwd"] += 1
        ctx.cfg, ctx.n_w = cfg, len(flat)
        _save(ctx, (msg, w1, w2, tg, fg), (pr, es, tg, fg, *flat))
        return out.T

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        cfg = ctx.cfg
        msg, w1, w2, tg, fg = ctx.saved_tensors[:ctx.n_kernel]
        nl0, nls, U, G = _dims(cfg)
        C, H, Ce = (cfg.sphere_channels, cfg.hidden_channels,
                    cfg.edge_channels)
        E = msg.shape[0]
        gout = g.T.contiguous().float()
        dev = dict(device=msg.device, dtype=torch.float32)
        gact = torch.empty(E, U * H, **dev)
        g0 = torch.empty(E, nl0 * 2 * C + Ce, **dev)
        gpr = torch.empty(E, U * 2 * C, **dev)
        ges = torch.empty(E, Ce, **dev)
        call(load("escn_edge"), "k4_bwd", E, C, H, Ce, cfg.lmax, cfg.mmax, G,
             ptr(msg), ptr(gout), ptr(w1), ptr(w2), ptr(tg), ptr(fg),
             ptr(gact), ptr(g0), ptr(gpr), ptr(ges), stream_ptr())
        launches["fused_edge_chain_bwd"] += 1
        return (None, gpr.T, ges.T, None, None,
                *_weight_cotangents(ctx, fused_edge_chain_plain, g))


def _kernel_guard(name, cfg, weights, tables, *ts):
    """The CUDA kernels' limits: float32 on one card, U <= 32 reduced rows,
    mmax <= 4, C, H and Ce multiples of 4 (the conv products copy 16-byte
    chunks at column offsets of those widths), and constant grid
    tables."""
    if any(t.requires_grad for t in tables):
        raise ValueError(f"{name}: the S2 grid tables are constants")
    _check_cuda(name, *ts, *tables, *_flat_weights(weights))
    nl0, nls, U, G = _dims(cfg)
    if U > 32 or cfg.mmax > 4:
        raise ValueError(f"{name}'s CUDA kernel takes U <= 32 reduced rows "
                         "and mmax <= 4")
    widths = (cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels)
    if any(w % 4 for w in widths):
        raise ValueError(f"{name}'s CUDA kernel takes sphere, hidden and "
                         f"edge channels that are multiples of 4; got "
                         f"{widths}")


def _check_shapes(name, **shapes):
    """Raise unless each named (tensor, shape) pair matches: the kernels
    take their sizes from the configuration and read out of bounds on
    anything else."""
    for arg, (t, want) in shapes.items():
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")


def fused_edge_mega(cfg, x_t, src, es, Dp, Dpe, weights, tables):
    """K1: K-summed node message update [M*C, P] (the caller divides by
    avg_degree). ``src`` [E] is the integer source atom of each edge."""
    if not x_t.is_cuda:
        return fused_edge_mega_plain(cfg, x_t, src, es, Dp, Dpe, weights,
                                     tables)
    _kernel_guard("fused_edge_mega", cfg, weights, tables, x_t, src, es, Dp,
                  Dpe)
    if src.dtype != torch.int64:
        raise TypeError("fused_edge_mega: src must be int64 atom indices")
    return _MegaFn.apply(cfg, x_t, src, es, Dp, Dpe, *tables,
                         *_flat_weights(weights))


def fused_edge_block(cfg, xs_t, xt_t, es, Dp, Dpe, weights, tables):
    """K3: per-edge back-rotated, envelope-weighted messages [M*C, E] from
    the gathered source rows xs_t and the repeated target rows xt_t
    [M*C, E] (the caller K-sums them)."""
    if not xs_t.is_cuda:
        return fused_edge_block_plain(cfg, xs_t, xt_t, es, Dp, Dpe, weights,
                                      tables)
    _kernel_guard("fused_edge_block", cfg, weights, tables, xs_t, xt_t, es,
                  Dp, Dpe)
    E = xs_t.shape[1]
    MC = (cfg.lmax + 1) ** 2 * cfg.sphere_channels
    nnz = len(_rot_nz(cfg.lmax, cfg.mmax)[0])
    _check_shapes("fused_edge_block", xs_t=(xs_t, (MC, E)),
                  xt_t=(xt_t, (MC, E)), es=(es, (cfg.edge_channels, E)),
                  Dp=(Dp, (nnz, E)), Dpe=(Dpe, (nnz, E)))
    return _BlockFn.apply(cfg, xs_t, xt_t, es, Dp, Dpe, *tables,
                          *_flat_weights(weights))


def fused_edge_chain(cfg, pr, es, weights, tables):
    """K4: conv 1 -> S2 activation -> conv 2 on rotated pair rows
    pr [U*2C, E] and edge scalars es [Ce, E] -> [U*C, E]."""
    if not pr.is_cuda:
        return fused_edge_chain_plain(cfg, pr, es, weights, tables)
    _kernel_guard("fused_edge_chain", cfg, weights, tables, pr, es)
    nl0, nls, U, G = _dims(cfg)
    E = pr.shape[1]
    _check_shapes("fused_edge_chain",
                  pr=(pr, (U * 2 * cfg.sphere_channels, E)),
                  es=(es, (cfg.edge_channels, E)))
    return _ChainFn.apply(cfg, pr, es, *tables, *_flat_weights(weights))
