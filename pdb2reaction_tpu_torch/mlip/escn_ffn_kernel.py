"""K2: the eSCN per-node S2-grid feed-forward network (``fused_node_ffn``).

Counterpart of ``pdb2reaction_tpu/mlip/escn_ffn_kernel.py`` with the same
public layout: x [P, M, C] node coefficients, weights = merged MoLE
(W1 [C, H], b1 [H], W2 [H, C], b2 [C]), tables = (tg [G, M], fg [M, G]):

    grid = tg @ x_i;  h = silu(grid @ W1 + b1);  y = h @ W2 + b2;
    out_i = fg @ y

CPU tensors take the plain PyTorch version (``ffn_plain``); CUDA tensors
the hand-written kernel (``csrc/escn_ffn.cu``), whose [G, H] hidden
activations stay in shared memory, behind ``torch.autograd.Function`` with
a kernel backward that recomputes from the saved x. The kernel runs f32,
computes the input cotangent only, and raises if a weight requires grad.
"""

from __future__ import annotations

import torch

# launches of the CUDA kernels, counted where each is launched
launches = {"fused_node_ffn_fwd": 0, "fused_node_ffn_bwd": 0}


def ffn_plain(x, weights, tables):
    """Plain PyTorch K2 (any dtype, any device, autograd-differentiable)."""
    W1, b1, W2, b2 = weights
    tg, fg = tables
    grid = torch.einsum("gm,pmc->pgc", tg, x)
    y = torch.nn.functional.silu(grid @ W1 + b1) @ W2 + b2
    return torch.einsum("mg,pgc->pmc", fg, y)


class _FfnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W1, b1, W2, b2, tg, fg):
        from .cuda_build import call, load, ptr, stream_ptr
        P, M, C = x.shape
        H = W1.shape[1]
        G = tg.shape[0]
        x = x.contiguous()
        W1, b1, W2, b2, tg, fg = (t.contiguous() for t in
                                  (W1, b1, W2, b2, tg, fg))
        out = torch.empty_like(x)
        call(load("escn_ffn"), "k2_fwd", P, M, C, H, G, ptr(x), ptr(W1),
             ptr(b1), ptr(W2), ptr(b2), ptr(tg), ptr(fg), ptr(out),
             stream_ptr())
        launches["fused_node_ffn_fwd"] += 1
        ctx.save_for_backward(x, W1, b1, W2, tg, fg)
        return out

    @staticmethod
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        x, W1, b1, W2, tg, fg = ctx.saved_tensors
        P, M, C = x.shape
        H = W1.shape[1]
        G = tg.shape[0]
        g = g.contiguous().float()
        W1t = W1.T.contiguous()
        W2t = W2.T.contiguous()
        dx = torch.empty_like(x)
        call(load("escn_ffn"), "k2_bwd", P, M, C, H, G, ptr(x), ptr(g),
             ptr(W1), ptr(b1), ptr(W1t), ptr(W2t), ptr(tg), ptr(fg),
             ptr(dx), stream_ptr())
        launches["fused_node_ffn_bwd"] += 1
        return dx, None, None, None, None, None, None


def fused_node_ffn(cfg, x, weights, tables):
    """K2 on x [P, M, C]; returns [P, M, C]."""
    if not x.is_cuda:
        return ffn_plain(x, weights, tables)
    ts = (x, *weights, *tables)
    if any(w.requires_grad for w in (*weights, *tables)):
        raise NotImplementedError(
            "fused_node_ffn's CUDA kernel computes the input cotangent "
            "only; weight gradients (training) are a later port item")
    for t in ts:
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError("fused_node_ffn's CUDA kernel takes float32 "
                            "tensors on one CUDA device")
    return _FfnFn.apply(x, *weights, *tables)
