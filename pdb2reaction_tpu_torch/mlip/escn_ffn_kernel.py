"""K2: the eSCN per-node S2-grid feed-forward network (``fused_node_ffn``).

Counterpart of ``pdb2reaction_tpu/mlip/escn_ffn_kernel.py`` with the same
public layout: x [P, M, C] node coefficients, weights = merged MoLE
(W1 [C, H], b1 [H], W2 [H, C], b2 [C]), tables = (tg [G, M], fg [M, G]):

    grid = tg @ x_i;  h = silu(grid @ W1 + b1);  y = h @ W2 + b2;
    out_i = fg @ y

CPU tensors take the plain PyTorch version (``ffn_plain``); CUDA tensors
the hand-written kernels (``csrc/escn_ffn.cu``) behind
``torch.autograd.Function``, with a kernel backward that recomputes from
the saved x. The kernels run each step as one 3xTF32 tensor-core GEMM with
the (node, grid point) rows in (g, p) order, and a deterministic sum over
the grid back to the nodes (``grid_sum``); ``ffn_route_plain`` and
``ffn_route_vjp_plain`` are the same launches in plain PyTorch, on the
operands ``route_operands`` builds for the kernels (the tests hold them to
``ffn_plain``). The kernels run f32 and raise if C or H is not a
multiple of 4 or M passes 32. The backward kernel computes the input
cotangent; where W1, b1, W2 or b2 requires grad, its cotangent comes
from a replay of ``ffn_plain`` under autograd inside the backward (the
JAX package's VJP replays the FFN in XLA for it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_build import first_order

# launches of the CUDA kernels, counted where each is launched
launches = {"fused_node_ffn_fwd": 0, "fused_node_ffn_bwd": 0}
# the epilogues of the kernels' GEMM (enum Epi of csrc/tf32_gemm.cuh)
EPI = {"bias": 0, "silu": 1, "dsilu": 2, "mul": 3}
MAX_M = 32                  # grid_sum keeps one accumulator per m


def ffn_plain(x, weights, tables):
    """Plain PyTorch K2 (any dtype, any device, autograd-differentiable)."""
    W1, b1, W2, b2 = weights
    tg, fg = tables
    grid = torch.einsum("gm,pmc->pgc", tg, x)
    y = torch.nn.functional.silu(grid @ W1 + b1) @ W2 + b2
    return torch.einsum("mg,pgc->pmc", fg, y)


def _pad_m(t, Mp):
    """t [..., M] -> [..., Mp], zeros in the columns M..Mp."""
    out = t.new_zeros(*t.shape[:-1], Mp)
    out[..., :t.shape[-1]] = t
    return out


def node_cols(x, Mp):
    """x [P, M, C] -> [P*C, Mp]: x[p, m, c] at row p*C + c, column m (the
    right operand of the table products, k = m contiguous)."""
    P, M, C = x.shape
    return _pad_m(x.transpose(1, 2), Mp).reshape(P * C, Mp)


class RouteOps(NamedTuple):
    """The operands the kernels read besides x and its cotangent."""
    tgp: torch.Tensor       # [G, Mp]  tg, zero columns M..Mp
    fgtp: torch.Tensor      # [G, Mp]  fg^T, likewise
    w1t: torch.Tensor       # [H, C]   W1^T (forward products)
    w2t: torch.Tensor       # [C, H]   W2^T
    w1: torch.Tensor        # [C, H]   as stored (backward products)
    w2: torch.Tensor        # [H, C]
    b1: torch.Tensor
    b2: torch.Tensor


def route_operands(weights, tables):
    """The kernels' operands, contiguous, with M padded to a multiple of 4
    (the GEMM's 16-byte copies, grid_sum's float4 rows of the tables)."""
    W1, b1, W2, b2 = (t.contiguous() for t in weights)
    tg, fg = tables
    Mp = (tg.shape[1] + 3) // 4 * 4
    return RouteOps(_pad_m(tg, Mp), _pad_m(fg.T, Mp), W1.T.contiguous(),
                    W2.T.contiguous(), W1, W2, b1, b2)


def gemm_plain(a, b, bias=None, epi="bias", c=None):
    """One GEMM of the route: f(a [rows, k] b [n, k]^T + bias), f the
    epilogue; "mul" multiplies into ``c`` (the kernel's old C)."""
    v = a @ b.T
    if bias is not None:
        v = v + bias
    if epi == "silu":
        return torch.nn.functional.silu(v)
    if epi == "dsilu":
        s = torch.sigmoid(v)
        return s * (1 + v * (1 - s))
    if epi == "mul":
        return v * c
    return v


def grid_sum_plain(T, Y, P, C, M):
    """out [P, M, C], out[p, m, c] = sum_g T[g, m] Y[g, p*C + c], for a
    table T [G, Mp] (tgp or fgtp; the columns past M unread) and grid
    rows Y [G, P*C]."""
    return (T[:, :M].T @ Y).reshape(M, P, C).transpose(0, 1)


def ffn_route_plain(x, o: RouteOps):
    """K2's forward launch by launch (``k2_fwd``), in plain PyTorch."""
    P, M, C = x.shape
    G, Mp = o.tgp.shape
    grid = gemm_plain(o.tgp, node_cols(x, Mp))                # [G, P*C]
    h = gemm_plain(grid.reshape(G * P, C), o.w1t, o.b1, "silu")
    y = gemm_plain(h, o.w2t, o.b2)                            # [G*P, C]
    return grid_sum_plain(o.fgtp, y.reshape(G, P * C), P, C, M)


def ffn_route_vjp_plain(x, g, o: RouteOps):
    """K2's backward (the cotangent of x) launch by launch (``k2_bwd``),
    in plain PyTorch."""
    P, M, C = x.shape
    G, Mp = o.tgp.shape
    grid = gemm_plain(o.tgp, node_cols(x, Mp)).reshape(G * P, C)
    s = gemm_plain(grid, o.w1t, o.b1, "dsilu")                # [G*P, H]
    dy = gemm_plain(o.fgtp, node_cols(g, Mp)).reshape(G * P, C)
    s = gemm_plain(dy, o.w2, epi="mul", c=s)                  # dpre
    dgrid = gemm_plain(s, o.w1)                               # [G*P, C]
    return grid_sum_plain(o.tgp, dgrid.reshape(G, P * C), P, C, M)


def _weight_cotangents(ctx, g):
    """The cotangents of W1, b1, W2 and b2 (None where none is needed):
    ``ffn_plain`` replayed on the saved x under autograd."""
    needs = ctx.needs_input_grad[1:5]
    if not ctx.need_w:
        return (None,) * 4
    x, *ws, tg, fg = (t.detach() for t in
                      ctx.saved_tensors[1 + len(RouteOps._fields):])
    ws = [w.requires_grad_(n) for w, n in zip(ws, needs)]
    with torch.enable_grad():
        y = ffn_plain(x, ws, (tg, fg))
        gw = iter(torch.autograd.grad(y, [w for w in ws if w.requires_grad],
                                      g))
    return tuple(next(gw) if n else None for n in needs)


class _FfnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W1, b1, W2, b2, tg, fg):
        from .cuda_build import call, load, ptr, stream_ptr
        P, M, C = x.shape
        H = W1.shape[1]
        G = tg.shape[0]
        o = route_operands((W1, b1, W2, b2), (tg, fg))
        Mp = o.tgp.shape[1]
        xc = node_cols(x, Mp)
        grid = x.new_empty(G * P * C)
        hid = x.new_empty(G * P * H)
        out = x.new_empty(P, M, C)
        call(load("escn_ffn"), "k2_fwd", P, M, Mp, C, H, G, ptr(xc),
             ptr(o.tgp), ptr(o.fgtp), ptr(o.w1t), ptr(o.b1), ptr(o.w2t),
             ptr(o.b2), ptr(grid), ptr(hid), ptr(out), stream_ptr())
        launches["fused_node_ffn_fwd"] += 1
        ctx.need_w = any(ctx.needs_input_grad[1:5])
        ctx.save_for_backward(xc, *o, *((x, W1, b1, W2, b2, tg, fg)
                                        if ctx.need_w else ()))
        ctx.dims = (P, M, C, H, G)
        return out

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        xc, *ops = ctx.saved_tensors[:1 + len(RouteOps._fields)]
        o = RouteOps(*ops)
        P, M, C, H, G = ctx.dims
        Mp = o.tgp.shape[1]
        gc = node_cols(g.float(), Mp)
        grid = xc.new_empty(G * P * C)
        s = xc.new_empty(G * P * H)
        dx = xc.new_empty(P, M, C)
        call(load("escn_ffn"), "k2_bwd", P, M, Mp, C, H, G, ptr(xc),
             ptr(gc), ptr(o.tgp), ptr(o.fgtp), ptr(o.w1t), ptr(o.b1),
             ptr(o.w1), ptr(o.w2), ptr(grid), ptr(s), ptr(dx), stream_ptr())
        launches["fused_node_ffn_bwd"] += 1
        return (dx, *_weight_cotangents(ctx, g), None, None)


def fused_node_ffn(cfg, x, weights, tables):
    """K2 on x [P, M, C]; returns [P, M, C]."""
    if not x.is_cuda:
        return ffn_plain(x, weights, tables)
    ts = (x, *weights, *tables)
    if any(t.requires_grad for t in tables):
        raise ValueError("fused_node_ffn: the S2 grid tables are constants")
    for t in ts:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError("fused_node_ffn's CUDA kernel takes float32 "
                            "tensors on one CUDA device")
    P, M, C = x.shape
    H = weights[0].shape[1]
    if C % 4 or H % 4:
        raise ValueError(f"fused_node_ffn's CUDA kernel needs C = {C} and "
                         f"H = {H} to be multiples of 4 (16-byte copies)")
    if M > MAX_M:
        raise ValueError(f"fused_node_ffn's CUDA kernel takes M <= {MAX_M} "
                         f"coefficients per node, not {M}")
    return _FfnFn.apply(x, *weights, *tables)


def gemm_tf32(a, b, bias=None, epi="bias", c=None):
    """One GEMM of K2's route on the card (``k2_gemm``, the kernel that
    ``k2_fwd`` / ``k2_bwd`` launch, alone): f(a b^T + bias) into ``c``
    (which "mul" multiplies into). For tests and timing: counts no
    launch."""
    from .cuda_build import call, load, ptr, stream_ptr
    rows, k = a.shape
    n = b.shape[0]
    if c is None:
        c = a.new_empty(rows, n)
    call(load("escn_ffn"), "k2_gemm", EPI[epi], rows, n, k, ptr(a), ptr(b),
         ptr(bias), ptr(c), c.stride(0), stream_ptr())
    return c


def grid_sum_cuda(T, Y, P, C, M, out=None):
    """``grid_sum`` alone on the card (``grid_sum_plain``'s function on a
    contiguous padded table T [G, Mp]): for tests and timing, counts no
    launch."""
    from .cuda_build import call, load, ptr, stream_ptr
    G, Mp = T.shape
    if out is None:
        out = Y.new_empty(P, M, C)
    call(load("escn_ffn"), "k2_grid_sum", M, Mp, G, P, C, ptr(T), ptr(Y),
         ptr(out), stream_ptr())
    return out
