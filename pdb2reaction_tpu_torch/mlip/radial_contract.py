"""K5 and K6: the radial contraction of the PaiNN-class model's pallas mode.

Counterpart of ``radial_contract`` (K5) and ``radial_contract_rect`` (K6)
in ``pdb2reaction_tpu/mlip/pallas_ops.py`` with the same public layouts:

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
The kernels take float32 only. All three run on one tile plan of the
call's coordinates: atoms in a spatial order, cut into tiles of 32, and
the tile pairs whose boxes lie within the cutoff; every other tile pair
holds no pair inside it and is skipped. The calls build
``tile_plan_fixed``: its buffers' sizes depend on the tile count alone
and its pair count stays on the device (the coordinate kernel's blocks
past it exit), so a force call reads nothing on the host and a CUDA graph
can hold it; ``tile_plan`` is its reference, the same pairs in the same
slots through ``nonzero``. A caller that contracts several streams over
the same coordinates builds the plan once and passes it to every call
(``plan=``; the PaiNN pallas mode does so once per energy evaluation);
without one, each call builds its own.

K6 (``radial_contract_rect``) is the same contraction for one block of
rows against all columns, the form atom-axis sharding runs: rows
coords_rows [Pr, 3] with global indices ``row_offset`` .. and columns
coords_cols [Pc, 3], feats [Pc, F] -> [Pr, R+1, F]; self-pairs are
excluded by global index. Its three kernels run on one ``rect_tile_plan``
(rows and columns each in the spatial order, the listed (row tile, column
tile) pairs as a CSR by row tile and one by column tile): the forward
walks each row tile's column list, the feats gradient each column tile's
row list, and the coordinate kernel gives the gradients of the rows and of
the columns from one S product per listed pair, in one launch. The PaiNN
pallas mode's sharded branch builds one such plan per energy evaluation
and passes it to every call; without one, each call builds its own and
keeps it for its backward.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import first_order
from .radial import cosine_envelope

# launches of the CUDA kernels, counted where each is launched: K5's and
# K6's
launches = {"radial_contract_fwd": 0, "radial_contract_bwd_feats": 0,
            "radial_contract_bwd_coords": 0}
rect_launches = {"radial_contract_rect_fwd": 0,
                 "radial_contract_rect_bwd_feats": 0,
                 "radial_contract_rect_bwd_coords": 0}
# tile plans built (``tile_plan`` and ``rect_tile_plan`` calls)
plans = {"built": 0, "rect_built": 0}

TILE = 32            # atoms per plan tile: the kernels' row and column tiles
REACH_SLACK = 1e-3   # Angstrom: covers f32 rounding of d in the kernels


class TilePlan(NamedTuple):
    """A spatial tiling of one call's atoms (``tile_plan``).

    perm     int32 [P]: the original index of the atom at each plan position
    xm       float32 [P, 4]: coordinates and mask in plan order
    lo, hi   float32 [T, 3]: per-tile boxes over real atoms (empty: +inf, -inf)
    row_ptr  int32 [T + 1], cols int32 [>= nnz]: the reach relation as rows
             of column tiles, ascending; ``cols[row_ptr[I]:row_ptr[I+1]]``
    pairs    int32 [n_upper, 4]: (I, J, e_IJ, e_JI) for each listed tile
             pair with I <= J, row-major; e_IJ is the position of J in I's
             row of ``cols`` (the slot of its partial sums)
    """
    perm: torch.Tensor
    xm: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    row_ptr: torch.Tensor
    cols: torch.Tensor
    pairs: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.lo.shape[0]

    def stats(self, R1=None, F=None) -> dict:
        """Tiles, listed tile pairs (ordered, and I <= J), their share of
        all T^2, and with R1 and F the FLOP the plan's kernels compute per
        launch: the forward and the feats gradient 2 (R+1) F per pair of
        every listed ordered tile pair, the coordinate gradient two S
        products per listed I <= J tile pair. Synchronises with the
        device."""
        return _stats(self, self.pairs.shape[0], R1, F)


def _stats(plan, n_upper, R1, F) -> dict:
    """``TilePlan.stats`` of a plan with ``n_upper`` listed I <= J pairs."""
    T = plan.n_tiles
    listed = int(plan.row_ptr[-1])
    out = {"tiles": T, "listed": listed, "listed_upper": int(n_upper),
           "share": listed / max(T * T, 1)}
    if R1 is not None:
        per = 2 * TILE * TILE * R1 * F
        out["fwd_flop"] = per * listed
        out["coords_flop"] = 2 * per * out["listed_upper"]
    return out


_LEVELS: dict = {}


def _bisect_levels(P, device):
    """Segment ids of each level of the recursive bisection of P atoms:
    every segment longer than a tile splits at a tile boundary, the lower
    part holding half its tiles (rounded down). The segments depend on P
    alone, so they are made once per (P, device)."""
    key = (P, str(device))
    if key not in _LEVELS:
        levels, segs = [], [P]
        while any(n > TILE for n in segs):
            sid = torch.repeat_interleave(torch.arange(len(segs)),
                                          torch.tensor(segs))
            levels.append((sid.to(device), len(segs)))
            nxt = []
            for n in segs:
                if n > TILE:
                    left = (-(-n // TILE) // 2) * TILE
                    nxt += [left, n - left]
                else:
                    nxt.append(n)
            segs = nxt
        _LEVELS[key] = levels
    return _LEVELS[key]


def _plan_tiles(coords, mask):
    """The spatial order of one side of a plan and its tiles' boxes:
    (order, xs, real, lo, hi), xs and real in plan order, lo and hi
    float32 [T, 3] over each tile's real atoms (empty: +inf, -inf).

    Order: recursive bisection, each segment sorted along the longest axis
    of its real atoms' box and split at a tile boundary; masked atoms sort
    last in every segment, so they end up last overall. Every sort is
    stable, so the order (and the kernels' sums) repeat bit for bit."""
    P, dev = coords.shape[0], coords.device
    inf = float("inf")
    x = coords.detach().to(torch.float32)
    real = mask.detach() > 0
    order = torch.argsort((~real).to(torch.int32), stable=True)
    for sid, n_seg in _bisect_levels(P, dev):
        xs, rs = x[order], real[order]
        idx = sid[:, None].expand(-1, 3)
        lo = torch.full((n_seg, 3), inf, device=dev).scatter_reduce(
            0, idx, torch.where(rs[:, None], xs, inf), "amin")
        hi = torch.full((n_seg, 3), -inf, device=dev).scatter_reduce(
            0, idx, torch.where(rs[:, None], xs, -inf), "amax")
        axis = (hi - lo).argmax(1)
        key = torch.where(rs, xs.gather(1, axis[sid][:, None])[:, 0], inf)
        k1 = torch.argsort(key, stable=True)
        order = order[k1[torch.argsort(sid[k1], stable=True)]]
    xs, rs = x[order], real[order]
    T = -(-P // TILE)
    pad = T * TILE - P
    lo = torch.cat([torch.where(rs[:, None], xs, inf),
                    torch.full((pad, 3), inf, device=dev)])
    hi = torch.cat([torch.where(rs[:, None], xs, -inf),
                    torch.full((pad, 3), -inf, device=dev)])
    return (order, xs, rs, lo.view(T, TILE, 3).amin(1),
            hi.view(T, TILE, 3).amax(1))


def _reach(lo_a, hi_a, lo_b, hi_b, cutoff):
    """bool [Ta, Tb]: the tile pairs whose boxes lie within ``cutoff +
    REACH_SLACK`` (f32), so that every pair the kernels' own f32 test puts
    inside the cutoff lies in a listed tile pair."""
    # per-axis gaps between boxes; an empty box gives +inf, never NaN
    gap = torch.clamp(torch.maximum(lo_b[None] - hi_a[:, None],
                                    lo_a[:, None] - hi_b[None]), min=0.0)
    return (gap * gap).sum(-1) <= (float(cutoff) + REACH_SLACK) ** 2


def _xm(xs, rs):
    return torch.cat([xs, rs[:, None].to(torch.float32)], 1).contiguous()


def tile_plan(coords, mask, cutoff) -> TilePlan:
    """The tile plan of K5's forward and coordinate gradient, in tiles of
    ``TILE`` atoms (the kernels' tile; they take no other): the order and
    boxes of ``_plan_tiles``, the reach relation of ``_reach``, the listed
    pairs by ``nonzero`` (a host synchronisation). Plain PyTorch on the
    coordinates' device. The calls build ``tile_plan_fixed``, which lists
    the same pairs in the same slots with no host read; this is its
    reference.
    """
    plans["built"] += 1
    dev = coords.device
    order, xs, rs, lo, hi = _plan_tiles(coords, mask)
    T = lo.shape[0]
    reach = _reach(lo, hi, lo, hi, cutoff)
    cnt = reach.sum(1, dtype=torch.int32)
    row_ptr = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(cnt, 0)
    rank = torch.cumsum(reach, 1, dtype=torch.int32) - reach.int()
    up = torch.triu(reach).nonzero()          # host synchronisation
    pI, pJ = up[:, 0], up[:, 1]
    e_ij = row_ptr[pI] + rank[pI, pJ]
    e_ji = row_ptr[pJ] + rank[pJ, pI]
    # reach is symmetric: every listed (I, J) is e_IJ or e_JI of one pair
    cols = torch.zeros(max(2 * up.shape[0], 1), dtype=torch.int32,
                       device=dev)
    cols[e_ij.long()] = pJ.int()
    cols[e_ji.long()] = pI.int()
    pairs = torch.stack([pI, pJ, e_ij, e_ji], 1).to(torch.int32)
    return TilePlan(order.to(torch.int32), _xm(xs, rs), lo, hi, row_ptr,
                    cols, pairs.contiguous())


class FixedTilePlan(NamedTuple):
    """``tile_plan``'s plan at a capacity fixed by the tile count alone,
    built with no host read (``tile_plan_fixed``): what a captured CUDA
    graph can hold, and what every call builds. The fields are
    ``TilePlan``'s, with

    cols     int32 [T * T]: the listed ordered pairs first, as in ``TilePlan``
    pairs    int32 [T (T + 1) / 2, 4]: the listed I <= J pairs first, in
             ``TilePlan``'s order; the empty slots after them hold -1
    n_upper  int32 [1]: the listed I <= J pairs, on the device; the
             coordinate kernel's blocks past it exit at once
    """
    perm: torch.Tensor
    xm: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    row_ptr: torch.Tensor
    cols: torch.Tensor
    pairs: torch.Tensor
    n_upper: torch.Tensor

    @property
    def n_tiles(self) -> int:
        return self.lo.shape[0]

    def stats(self, R1=None, F=None) -> dict:
        """``TilePlan.stats`` of the listed pairs. Synchronises with the
        device."""
        return _stats(self, self.n_upper[0], R1, F)


_UPPER: dict = {}


def tile_plan_fixed(coords, mask, cutoff) -> FixedTilePlan:
    """``tile_plan`` with no host read, the plan every call builds (a
    captured CUDA graph can hold it): the same order, boxes, reach
    relation and listed pairs in the same order (the kernels sum the same
    terms in the same order, bit for bit), in buffers whose sizes depend
    on the tile count T alone: every I <= J tile pair is ranked among the
    listed ones by a prefix sum instead of ``nonzero``, and the count
    stays on the device."""
    plans["built"] += 1
    dev = coords.device
    order, xs, rs, lo, hi = _plan_tiles(coords, mask)
    T = lo.shape[0]
    key = (T, str(dev))
    if key not in _UPPER:
        _UPPER[key] = torch.triu_indices(T, T).to(dev)
    uI, uJ = _UPPER[key]
    cap = uI.shape[0]
    reach = _reach(lo, hi, lo, hi, cutoff)
    cnt = reach.sum(1, dtype=torch.int32)
    row_ptr = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(cnt, 0)
    rank = torch.cumsum(reach, 1, dtype=torch.int32) - reach.int()
    listed = reach[uI, uJ]
    e_ij = row_ptr[uI] + rank[uI, uJ]
    e_ji = row_ptr[uJ] + rank[uJ, uI]
    # unlisted pairs write to one scratch slot past the end, then dropped
    cols = torch.zeros(T * T + 1, dtype=torch.int32, device=dev)
    cols.scatter_(0, torch.where(listed, e_ij, T * T).long(), uJ.int())
    cols.scatter_(0, torch.where(listed, e_ji, T * T).long(), uI.int())
    slot = torch.where(listed, torch.cumsum(listed, 0) - 1, cap)
    pairs = torch.full((cap + 1, 4), -1, dtype=torch.int32, device=dev)
    pairs.index_copy_(0, slot, torch.stack([uI, uJ, e_ij, e_ji],
                                           1).to(torch.int32))
    n_upper = listed.sum(dtype=torch.int32).reshape(1)
    return FixedTilePlan(order.to(torch.int32), _xm(xs, rs), lo, hi,
                         row_ptr, cols[:T * T].contiguous(),
                         pairs[:cap].contiguous(), n_upper)


class RectTilePlan(NamedTuple):
    """The tile plan of K6's three kernels (``rect_tile_plan``): one
    block of rows (global indices ``off`` ..) and all columns, each side in
    its own spatial order and tiles of ``TILE``.

    off              int: the global index of row 0
    perm_r, perm_c   int32 [Pr], [Pc]: the local row / column at each plan
                     position
    xm_r, xm_c       float32 [Pr, 4], [Pc, 4]: coordinates and mask in plan
                     order
    row_ptr, cols    int32 [Tr + 1], [n]: each row tile's listed column
                     tiles, ascending
    col_ptr, rows    int32 [Tc + 1], [n]: each column tile's listed row
                     tiles, ascending
    pairs            int32 [n, 4]: (I, J, e_row, e_col) per listed tile
                     pair, row-major; e_row is J's position in ``cols``, e_col
                     I's in ``rows``: the slots of the two sides' partial sums
    """
    off: int
    perm_r: torch.Tensor
    perm_c: torch.Tensor
    xm_r: torch.Tensor
    xm_c: torch.Tensor
    row_ptr: torch.Tensor
    cols: torch.Tensor
    col_ptr: torch.Tensor
    rows: torch.Tensor
    pairs: torch.Tensor

    def stats(self, R1=None, F=None) -> dict:
        """Row and column tiles, listed tile pairs and their share of all
        Tr Tc, and with R1 and F the FLOP each of the three kernels
        computes per launch: 2 (R+1) F per pair of every listed tile pair
        (the forward and the feats gradient contract it, the coordinate
        kernel forms one S product on it). Synchronises with the
        device."""
        Tr, Tc = self.row_ptr.shape[0] - 1, self.col_ptr.shape[0] - 1
        listed = int(self.pairs.shape[0])
        out = {"row_tiles": Tr, "col_tiles": Tc, "listed": listed,
               "share": listed / max(Tr * Tc, 1)}
        if R1 is not None:
            out["flop"] = 2 * TILE * TILE * R1 * F * listed
        return out


def _stage_clock(stages, device):
    """``mark(name)``: records in ``stages`` the ms since the previous mark
    (host clock, the device synchronised at each mark); without
    ``stages`` a no-op."""
    if stages is None:
        return lambda name: None
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    last = [time.perf_counter()]

    def mark(name):
        sync()
        now = time.perf_counter()
        stages[name] = (now - last[0]) * 1e3
        last[0] = now
    return mark


def rect_tile_plan(coords_rows, mask_rows, row_offset, coords_cols,
                   mask_cols, cutoff, stages=None) -> RectTilePlan:
    """The tile plan of K6's three kernels: rows and columns each
    ordered and tiled by ``_plan_tiles``, and the (row tile, column tile)
    pairs whose boxes lie within the cutoff (``_reach``), as CSRs by row
    tile and by column tile and as one list of pairs with both sides'
    slots. Plain PyTorch on the coordinates' device; the ``nonzero`` is
    the one host synchronisation. ``stages``, a dict, receives each
    stage's ms (measurement only: it synchronises the device)."""
    plans["rect_built"] += 1
    dev = coords_rows.device
    mark = _stage_clock(stages, dev)
    perm_r, xr, real_r, lo_r, hi_r = _plan_tiles(coords_rows, mask_rows)
    mark("rows' order")
    perm_c, xc, real_c, lo_c, hi_c = _plan_tiles(coords_cols, mask_cols)
    mark("columns' order")
    reach = _reach(lo_r, hi_r, lo_c, hi_c, cutoff)          # [Tr, Tc]
    mark("reach")
    ptr = []
    for dim in (1, 0):
        p = torch.zeros(reach.shape[1 - dim] + 1, dtype=torch.int32,
                        device=dev)
        p[1:] = torch.cumsum(reach.sum(dim, dtype=torch.int32), 0)
        ptr.append(p)
    row_ptr, col_ptr = ptr
    mark("CSR pointers")
    nz = reach.nonzero()                      # host synchronisation
    mark("nonzero")
    pI, pJ = nz[:, 0], nz[:, 1]
    # row-major: the pairs are the row lists in order, so e_row = 0 .. n-1
    e_row = torch.arange(nz.shape[0], device=dev)
    e_col = col_ptr[pJ] + (torch.cumsum(reach, 0, dtype=torch.int32)
                           - reach.int())[pI, pJ]
    rows = torch.empty(nz.shape[0], dtype=torch.int32, device=dev)
    rows[e_col.long()] = pI.int()
    pairs = torch.stack([pI, pJ, e_row, e_col], 1).to(torch.int32)
    plan = RectTilePlan(int(row_offset), perm_r.to(torch.int32),
                        perm_c.to(torch.int32), _xm(xr, real_r),
                        _xm(xc, real_c), row_ptr, pJ.to(torch.int32),
                        col_ptr, rows, pairs.contiguous())
    mark("column lists and pairs")
    return plan


def radial_contract_plain(coords, mask, feats, cutoff, n_radial,
                          div_d=False):
    """Plain PyTorch K5 (any dtype, any device, autograd-differentiable):
    the port of ``radial_contract_reference``."""
    return radial_contract_rect_plain(coords, mask, 0, coords, mask, feats,
                                      cutoff, n_radial, div_d)


def radial_contract_rect_plain(coords_rows, mask_rows, row_offset,
                               coords_cols, mask_cols, feats, cutoff,
                               n_radial, div_d=False):
    """Plain PyTorch K6 (any dtype, any device, autograd-differentiable):
    the port of ``radial_contract_rect_reference``; K5 is its square case
    (the same rows and columns, offset 0)."""
    dev, dt = coords_rows.device, coords_rows.dtype
    diff = coords_rows[:, None, :] - coords_cols[None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    gi = torch.arange(coords_rows.shape[0], device=dev) + int(row_offset)
    gj = torch.arange(coords_cols.shape[0], device=dev)
    within = ((d <= cutoff) & (gi[:, None] != gj[None, :])
              & (mask_rows[:, None] > 0) & (mask_cols[None, :] > 0))
    d_safe = torch.where(within, d, torch.ones_like(d))
    env = torch.where(within, cosine_envelope(d, cutoff),
                      torch.zeros_like(d))
    inv = 1.0 / d_safe
    scale = env * inv * np.sqrt(2.0 / cutoff)
    env_ch = env
    if div_d:
        scale = scale * inv
        env_ch = env * inv
    freqs = torch.arange(1, n_radial + 1, dtype=dt, device=dev) \
        * (np.pi / cutoff)
    A = torch.cat([torch.sin(d_safe[..., None] * freqs) * scale[..., None],
                   env_ch[..., None]], -1)
    return torch.einsum("ijr,jf->irf", A, feats.to(A.dtype))


def _aligned(t):
    """Contiguous and 16-byte aligned (the kernels load float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def contract_on_plan(plan, feats, cutoff, n_radial, div_d=False):
    """K5's forward kernel on a ``tile_plan`` of the coordinates: feats
    [P, F] (float32, contiguous, 16-byte aligned, on the card) ->
    [P, R+1, F]. Every row is written: rows of a tile with no reach get
    zeros."""
    from .cuda_build import call, load, ptr, stream_ptr
    P, F = feats.shape
    out = torch.empty(P, n_radial + 1, F, device=feats.device,
                      dtype=torch.float32)
    call(load("radial_contract"), "rc_fwd_launch", P, F, n_radial,
         int(div_d), float(cutoff), ptr(plan.xm), ptr(plan.perm),
         ptr(plan.row_ptr), ptr(plan.cols), ptr(feats), ptr(out),
         stream_ptr())
    launches["radial_contract_fwd"] += 1
    return out


class _RadialContractFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, mask, feats, cutoff, n_radial, div_d, plan):
        feats = _aligned(feats)
        if plan is None:
            plan = tile_plan_fixed(coords, mask, cutoff)
        out = contract_on_plan(plan, feats, cutoff, n_radial, div_d)
        # the backward reads the coordinates and mask from the plan
        ctx.save_for_backward(feats)
        ctx.plan = plan
        ctx.args = (float(cutoff), int(n_radial), bool(div_d))
        return out

    @staticmethod
    @first_order
    def backward(ctx, g):
        from .cuda_build import call, load, ptr, stream_ptr
        (feats,) = ctx.saved_tensors
        plan = ctx.plan
        cutoff, n_radial, div_d = ctx.args
        P, F = feats.shape
        g = _aligned(g.float())
        lib = load("radial_contract")
        dcoords = dfeats = None
        if ctx.needs_input_grad[2]:
            dfeats = torch.empty_like(feats)
            call(lib, "rc_bwd_feats_launch", P, F, n_radial, int(div_d),
                 cutoff, ptr(plan.xm), ptr(plan.perm), ptr(plan.row_ptr),
                 ptr(plan.cols), ptr(g), ptr(dfeats), stream_ptr())
            launches["radial_contract_bwd_feats"] += 1
        if ctx.needs_input_grad[0]:
            dcoords = torch.empty(P, 3, device=g.device, dtype=torch.float32)
            # one [TILE, 3] slot of partial sums per listed ordered pair
            part = torch.empty(plan.cols.shape[0], TILE, 3,
                               device=g.device, dtype=torch.float32)
            call(lib, "rc_bwd_coords_launch", P, F, n_radial, int(div_d),
                 cutoff, plan.pairs.shape[0],
                 ptr(getattr(plan, "n_upper", None)), ptr(plan.xm),
                 ptr(plan.perm), ptr(plan.row_ptr), ptr(plan.pairs),
                 ptr(feats), ptr(g), ptr(part), ptr(dcoords), stream_ptr())
            launches["radial_contract_bwd_coords"] += 1
        return dcoords, None, dfeats, None, None, None, None


def _check(name, tensors, F, n_radial):
    """What the CUDA kernels take: float32 on one card, F % 8 == 0, at
    most 63 radial channels."""
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"{name}'s CUDA kernels take float32 tensors on "
                            "one CUDA device")
    if F % 8:
        raise ValueError(f"{name}'s CUDA kernels need F % 8 == 0, got "
                         f"F = {F}")
    if n_radial + 1 > 63:
        # the coordinate gradients' narrow tiles fill the 227 KB of shared
        # memory a block may have at R + 1 = 64
        raise ValueError(f"{name}'s CUDA kernels take at most 63 radial "
                         f"channels, got {n_radial + 1}")


def radial_contract(coords, mask, feats, cutoff, n_radial, div_d=False,
                    plan=None):
    """K5 on coords [P, 3], mask [P], feats [P, F]; returns [P, R+1, F].
    On CUDA tensors ``plan``, a ``tile_plan_fixed`` (or ``tile_plan``) of
    these coordinates, mask and cutoff, serves all three kernels (None:
    the call builds its own ``tile_plan_fixed``); on the CPU it is
    ignored."""
    if not coords.is_cuda:
        return radial_contract_plain(coords, mask, feats, cutoff, n_radial,
                                     div_d)
    _check("radial_contract", (coords, mask, feats), feats.shape[1],
           n_radial)
    if plan is not None and (plan.xm.shape[0] != coords.shape[0]
                             or plan.xm.device != coords.device):
        raise ValueError(f"radial_contract: a tile plan of "
                         f"{plan.xm.shape[0]} atoms on {plan.xm.device} for "
                         f"{coords.shape[0]} atoms on {coords.device}")
    return _RadialContractFn.apply(coords, mask, feats, cutoff, n_radial,
                                   div_d, plan)


def rect_coords_on_plan(plan, feats, g, cutoff, n_radial, div_d=False):
    """K6's coordinate kernel on a ``rect_tile_plan``: feats [Pc, F] and g
    [Pr, R+1, F] (float32, contiguous, 16-byte aligned, on the card) ->
    (dx_rows [Pr, 3], dx_cols [Pc, 3]) from one S product per listed tile
    pair. Every row and column is written: atoms of a tile with no reach
    get zeros."""
    from .cuda_build import call, load, ptr, stream_ptr
    Pr, Pc, F = g.shape[0], feats.shape[0], feats.shape[1]
    dev = feats.device
    n = plan.pairs.shape[0]
    dxr = torch.empty(Pr, 3, device=dev, dtype=torch.float32)
    dxc = torch.empty(Pc, 3, device=dev, dtype=torch.float32)
    # one [TILE, 3] slot of partial sums per listed pair and side
    part = torch.empty(2, n, TILE, 3, device=dev, dtype=torch.float32)
    call(load("radial_contract"), "rc_rect_bwd_coords_launch", Pr, Pc,
         plan.off, F, n_radial, int(div_d), float(cutoff), n,
         ptr(plan.xm_r), ptr(plan.xm_c), ptr(plan.perm_r), ptr(plan.perm_c),
         ptr(plan.row_ptr), ptr(plan.col_ptr), ptr(plan.pairs), ptr(feats),
         ptr(g), ptr(part[0]), ptr(part[1]), ptr(dxr), ptr(dxc),
         stream_ptr())
    rect_launches["radial_contract_rect_bwd_coords"] += 1
    return dxr, dxc


def rect_contract_on_plan(plan, feats, cutoff, n_radial, div_d=False):
    """K6's forward kernel on a ``rect_tile_plan``: feats [Pc, F]
    (float32, contiguous, 16-byte aligned, on the card) -> [Pr, R+1, F].
    A block of rows walks its row tile's column list. Every row is
    written: rows of a tile that lists nothing get zeros."""
    from .cuda_build import call, load, ptr, stream_ptr
    Pr, (Pc, F) = plan.xm_r.shape[0], feats.shape
    out = torch.empty(Pr, n_radial + 1, F, device=feats.device,
                      dtype=torch.float32)
    call(load("radial_contract"), "rc_rect_plan_fwd_launch", Pr, Pc,
         plan.off, F, n_radial, int(div_d), float(cutoff), ptr(plan.xm_r),
         ptr(plan.xm_c), ptr(plan.perm_r), ptr(plan.perm_c),
         ptr(plan.row_ptr), ptr(plan.cols), ptr(feats), ptr(out),
         stream_ptr())
    rect_launches["radial_contract_rect_fwd"] += 1
    return out


def rect_feats_on_plan(plan, g, cutoff, n_radial, div_d=False):
    """K6's feats-gradient kernel on a ``rect_tile_plan``: g [Pr, R+1, F]
    (float32, contiguous, 16-byte aligned, on the card) -> dfeats [Pc, F].
    A block of columns walks its column tile's row list. Every column is
    written: columns of a tile that lists nothing get zeros."""
    from .cuda_build import call, load, ptr, stream_ptr
    Pr, Pc, F = g.shape[0], plan.xm_c.shape[0], g.shape[2]
    dfeats = torch.empty(Pc, F, device=g.device, dtype=torch.float32)
    call(load("radial_contract"), "rc_rect_plan_feats_launch", Pr, Pc,
         plan.off, F, n_radial, int(div_d), float(cutoff), ptr(plan.xm_r),
         ptr(plan.xm_c), ptr(plan.perm_r), ptr(plan.perm_c),
         ptr(plan.col_ptr), ptr(plan.rows), ptr(g), ptr(dfeats),
         stream_ptr())
    rect_launches["radial_contract_rect_bwd_feats"] += 1
    return dfeats


class _RadialContractRectFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cr, mr, row_offset, cc, mc, feats, cutoff, n_radial,
                div_d, plan):
        feats = _aligned(feats)
        if plan is None:
            plan = rect_tile_plan(cr, mr, row_offset, cc, mc, cutoff)
        out = rect_contract_on_plan(plan, feats, cutoff, n_radial, div_d)
        # the backward reads the coordinates and masks from the plan
        ctx.save_for_backward(feats)
        ctx.plan = plan
        ctx.args = (float(cutoff), int(n_radial), bool(div_d))
        return out

    @staticmethod
    @first_order
    def backward(ctx, g):
        (feats,) = ctx.saved_tensors
        plan = ctx.plan
        cutoff, n_radial, div_d = ctx.args
        g = _aligned(g.float())
        dcr = dcc = dfeats = None
        if ctx.needs_input_grad[5]:
            dfeats = rect_feats_on_plan(plan, g, cutoff, n_radial, div_d)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[3]:
            # one launch serves both coordinate gradients
            dxr, dxc = rect_coords_on_plan(plan, feats, g, cutoff, n_radial,
                                           div_d)
            dcr = dxr if ctx.needs_input_grad[0] else None
            dcc = dxc if ctx.needs_input_grad[3] else None
        return dcr, None, None, dcc, None, dfeats, None, None, None, None


def radial_contract_rect(coords_rows, mask_rows, row_offset, coords_cols,
                         mask_cols, feats, cutoff, n_radial, div_d=False,
                         plan=None):
    """K6 on rows [Pr, 3] (global indices ``row_offset`` ..), mask_rows
    [Pr], columns [Pc, 3], mask_cols [Pc], feats [Pc, F]; returns
    [Pr, R+1, F]. ``row_offset`` is a Python int. On CUDA tensors ``plan``,
    a ``rect_tile_plan`` of these rows, columns, offset and cutoff, serves
    all three kernels (None: the call builds its own); on the CPU it is
    ignored."""
    if not coords_rows.is_cuda:
        return radial_contract_rect_plain(coords_rows, mask_rows, row_offset,
                                          coords_cols, mask_cols, feats,
                                          cutoff, n_radial, div_d)
    _check("radial_contract_rect",
           (coords_rows, mask_rows, coords_cols, mask_cols, feats),
           feats.shape[1], n_radial)
    if coords_cols.shape[0] != feats.shape[0] \
            or mask_cols.shape[0] != feats.shape[0] \
            or mask_rows.shape[0] != coords_rows.shape[0]:
        raise ValueError("radial_contract_rect: rows and their mask, and "
                         "columns, their mask and feats, must agree in "
                         "length")
    if plan is not None and (
            plan.xm_r.shape[0] != coords_rows.shape[0]
            or plan.xm_c.shape[0] != coords_cols.shape[0]
            or plan.off != int(row_offset)
            or plan.xm_r.device != coords_rows.device):
        raise ValueError(
            f"radial_contract_rect: a rect tile plan of {plan.xm_r.shape[0]}"
            f" rows from {plan.off} and {plan.xm_c.shape[0]} columns on "
            f"{plan.xm_r.device} for {coords_rows.shape[0]} rows from "
            f"{int(row_offset)} and {coords_cols.shape[0]} columns on "
            f"{coords_rows.device}")
    return _RadialContractRectFn.apply(coords_rows, mask_rows,
                                       int(row_offset), coords_cols,
                                       mask_cols, feats, cutoff, n_radial,
                                       div_d, plan)
