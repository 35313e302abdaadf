"""K5: the radial contraction of the PaiNN-class model's pallas mode.

Counterpart of ``radial_contract`` in ``pdb2reaction_tpu/mlip/pallas_ops.py``
with the same public layout:

    T[i, r, f] = sum_j A[i, j, r] feats[j, f]
    A[i, j, r] = sqrt(2/rc) sin((r+1) pi d/rc) / d * env(d) * mask   r < R
    A[i, j, R] = env(d) * mask

coords [P, 3] (Angstrom), mask [P], feats [P, F] -> T [P, R+1, F]. With
``div_d`` every channel is divided by d once more (the edge-direction
stream of the model). Self-pairs are excluded by index, padding atoms by
the mask.

CPU tensors take the plain PyTorch version (``radial_contract_plain``,
which builds the [P, P, R+1] adjacency and is differentiated by
autograd); CUDA tensors the hand-written kernels of
``csrc/radial_contract.cu`` behind a ``torch.autograd.Function``: the
forward, the feats gradient (the transposed contraction; A is symmetric)
and the fused coordinate gradient, none of which stores the adjacency.
The kernels take float32 only.
"""

from __future__ import annotations

import numpy as np
import torch

from .radial import cosine_envelope

# launches of the CUDA kernels, counted where each is launched
launches = {"radial_contract_fwd": 0, "radial_contract_bwd_feats": 0,
            "radial_contract_bwd_coords": 0}


def radial_contract_plain(coords, mask, feats, cutoff, n_radial,
                          div_d=False):
    """Plain PyTorch K5 (any dtype, any device, autograd-differentiable):
    the port of ``radial_contract_reference``."""
    P = coords.shape[0]
    diff = coords[:, None, :] - coords[None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    eye = torch.eye(P, dtype=torch.bool, device=coords.device)
    within = ((d <= cutoff) & ~eye & (mask[:, None] > 0)
              & (mask[None, :] > 0))
    d_safe = torch.where(within, d, torch.ones_like(d))
    env = torch.where(within, cosine_envelope(d, cutoff),
                      torch.zeros_like(d))
    inv = 1.0 / d_safe
    scale = env * inv * np.sqrt(2.0 / cutoff)
    env_ch = env
    if div_d:
        scale = scale * inv
        env_ch = env * inv
    freqs = torch.arange(1, n_radial + 1, dtype=coords.dtype,
                         device=coords.device) * (np.pi / cutoff)
    A = torch.cat([torch.sin(d_safe[..., None] * freqs) * scale[..., None],
                   env_ch[..., None]], -1)
    return torch.einsum("ijr,jf->irf", A, feats.to(A.dtype))


def _aligned(t):
    """Contiguous and 16-byte aligned (the kernels load float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _RadialContractFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, mask, feats, cutoff, n_radial, div_d):
        from .cuda_build import call, load, ptr, stream_ptr
        coords, mask, feats = (_aligned(t) for t in (coords, mask, feats))
        P, F = feats.shape
        out = torch.empty(P, n_radial + 1, F, device=feats.device,
                          dtype=torch.float32)
        call(load("radial_contract"), "rc_fwd_launch", P, F, n_radial,
             int(div_d), float(cutoff), ptr(coords), ptr(mask), ptr(feats),
             ptr(out), stream_ptr())
        launches["radial_contract_fwd"] += 1
        ctx.save_for_backward(coords, mask, feats)
        ctx.args = (float(cutoff), int(n_radial), bool(div_d))
        return out

    @staticmethod
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        coords, mask, feats = ctx.saved_tensors
        cutoff, n_radial, div_d = ctx.args
        P, F = feats.shape
        g = _aligned(g.float())
        lib = load("radial_contract")
        dcoords = dfeats = None
        if ctx.needs_input_grad[2]:
            dfeats = torch.empty_like(feats)
            call(lib, "rc_bwd_feats_launch", P, F, n_radial, int(div_d),
                 cutoff, ptr(coords), ptr(mask), ptr(g), ptr(dfeats),
                 stream_ptr())
            launches["radial_contract_bwd_feats"] += 1
        if ctx.needs_input_grad[0]:
            dcoords = torch.empty_like(coords)
            call(lib, "rc_bwd_coords_launch", P, F, n_radial, int(div_d),
                 cutoff, ptr(coords), ptr(mask), ptr(feats), ptr(g),
                 ptr(dcoords), stream_ptr())
            launches["radial_contract_bwd_coords"] += 1
        return dcoords, None, dfeats, None, None, None


def radial_contract(coords, mask, feats, cutoff, n_radial, div_d=False):
    """K5 on coords [P, 3], mask [P], feats [P, F]; returns [P, R+1, F]."""
    if not coords.is_cuda:
        return radial_contract_plain(coords, mask, feats, cutoff, n_radial,
                                     div_d)
    for t in (coords, mask, feats):
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError("radial_contract's CUDA kernels take float32 "
                            "tensors on one CUDA device")
    if feats.shape[1] % 8:
        raise ValueError(f"radial_contract's CUDA kernels need F % 8 == 0, "
                         f"got F = {feats.shape[1]}")
    if n_radial + 1 > 63:
        # the coordinate gradient's 16-column tile fills the 227 KB of
        # shared memory a block may have at R + 1 = 64
        raise ValueError(f"radial_contract's CUDA kernels take at most 63 "
                         f"radial channels, got {n_radial + 1}")
    return _RadialContractFn.apply(coords, mask, feats, cutoff, n_radial,
                                   div_d)
