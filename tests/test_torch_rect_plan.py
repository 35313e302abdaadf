"""K6's rect tile plan (``radial_contract.rect_tile_plan``): rows and
columns each in the spatial order, and the (row tile, column tile) pairs
K6's coordinate kernel runs on, on the CPU.

Completeness is the property that matters: every (row, column) pair that
the kernel's own f32 test puts inside the cutoff (d = sqrt(max(d^2,
1e-12)) <= rc, both atoms real, off + i != j by global index) must lie in
a listed tile pair, or it is dropped silently. Checked brute force on
random systems, the 4096-atom smoke cluster in lattice order and
shuffled (the first and the last row block), two blobs that leave empty
tiles, masked atoms at the origin, ragged row and column counts and a pair
at exactly the cutoff. Also: determinism, both CSRs against ``pairs``,
and K5's ``tile_plan`` bit for bit what it was before its ordering was
factored out for both plans.
"""

import numpy as np
import pytest
import torch

from chip_smoke import cluster
from pdb2reaction_tpu_torch.mlip.radial_contract import (REACH_SLACK, TILE,
                                                         _bisect_levels,
                                                         rect_tile_plan,
                                                         tile_plan)


def _pairs_inside(xr, mr, off, xc, mc, rc, chunk=256):
    """(i, j) of every (local row, column) pair the kernel's f32 predicate
    keeps."""
    xr, xc = xr.to(torch.float32), xc.to(torch.float32)
    out = []
    for a in range(0, xr.shape[0], chunk):
        d = torch.sqrt(torch.clamp(
            ((xr[a:a + chunk, None, :] - xc[None, :, :]) ** 2).sum(-1),
            min=1e-12))
        w = (d <= rc) & (mr[a:a + chunk, None] > 0) & (mc[None, :] > 0)
        i, j = w.nonzero().T
        keep = off + a + i != j
        out.append(torch.stack([i[keep] + a, j[keep]], 1))
    return torch.cat(out)


def _reach(plan):
    Tr, Tc = plan.row_ptr.shape[0] - 1, plan.col_ptr.shape[0] - 1
    reach = torch.zeros(Tr, Tc, dtype=torch.bool)
    pr = plan.pairs.long()
    reach[pr[:, 0], pr[:, 1]] = True
    return reach


def _check(xr, mr, off, xc, mc, rc):
    """The plan of (rows, columns): complete and consistent; returns it
    and the pairs inside the cutoff."""
    xr, mr, xc, mc = (torch.as_tensor(a, dtype=torch.float32)
                      for a in (xr, mr, xc, mc))
    plan = rect_tile_plan(xr, mr, off, xc, mc, rc)
    ij = _pairs_inside(xr, mr, off, xc, mc, rc)
    pos_r = torch.empty(xr.shape[0], dtype=torch.long)
    pos_r[plan.perm_r.long()] = torch.arange(xr.shape[0])
    pos_c = torch.empty(xc.shape[0], dtype=torch.long)
    pos_c[plan.perm_c.long()] = torch.arange(xc.shape[0])
    reach = _reach(plan)
    missed = int((~reach[pos_r[ij[:, 0]] // TILE,
                         pos_c[ij[:, 1]] // TILE]).sum())
    assert missed == 0, f"{missed} pairs inside the cutoff in unlisted tiles"
    _check_consistent(plan, xr, mr, xc, mc, reach)
    return plan, ij


def _check_consistent(plan, xr, mr, xc, mc, reach):
    Pr, Pc = xr.shape[0], xc.shape[0]
    Tr, Tc = -(-Pr // TILE), -(-Pc // TILE)
    assert reach.shape == (Tr, Tc)
    for perm, x, m, xm in ((plan.perm_r, xr, mr, plan.xm_r),
                           (plan.perm_c, xc, mc, plan.xm_c)):
        p = perm.long()
        assert torch.equal(torch.sort(p).values, torch.arange(x.shape[0]))
        real = (m > 0)[p]
        n_real = int(real.sum())          # masked atoms go last
        assert bool(real[:n_real].all()) and not bool(real[n_real:].any())
        assert torch.equal(xm[:, :3], x[p])
        assert torch.equal(xm[:, 3], real.float())
    # both CSRs list the pairs' tiles in ascending order
    pr = plan.pairs.long()
    I, J, e_row, e_col = pr.T
    n = pr.shape[0]
    assert torch.equal(plan.row_ptr[1:] - plan.row_ptr[:-1],
                       reach.sum(1).int())
    assert torch.equal(plan.col_ptr[1:] - plan.col_ptr[:-1],
                       reach.sum(0).int())
    assert int(plan.row_ptr[-1]) == int(plan.col_ptr[-1]) == n
    assert torch.equal(plan.cols[e_row].long(), J)
    assert torch.equal(plan.rows[e_col].long(), I)
    assert torch.equal(torch.sort(e_row).values, torch.arange(n))
    assert torch.equal(torch.sort(e_col).values, torch.arange(n))
    rp, cp = plan.row_ptr.long(), plan.col_ptr.long()
    assert bool(((rp[I] <= e_row) & (e_row < rp[I + 1])).all())
    assert bool(((cp[J] <= e_col) & (e_col < cp[J + 1])).all())
    for a in range(Tr):
        row = plan.cols[rp[a]:rp[a + 1]].long()
        assert torch.equal(row, reach[a].nonzero()[:, 0])
    for b in range(Tc):
        col = plan.rows[cp[b]:cp[b + 1]].long()
        assert torch.equal(col, reach[:, b].nonzero()[:, 0])


def _system(P, seed, box=18.0, masked=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, box, (P, 3))
    m = (rng.uniform(size=P) > masked).astype(np.float32)
    return x, m


@pytest.mark.parametrize("seed,off,Pr", [(0, 0, 96), (1, 70, 45),
                                         (2, 130, 77)])
def test_complete_random(seed, off, Pr):
    x, m = _system(260, seed)
    plan, ij = _check(x[off:off + Pr], m[off:off + Pr], off, x, m, 5.0)
    assert ij.shape[0] > 0


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("off", [0, 3072])
def test_complete_smoke_cluster(shuffled, off):
    """The sharded slice's row blocks of 1024 (the first and the last) of
    the 4096-atom smoke cluster; shuffled, a block's rows spread over the
    whole box and its tiles grow, but the plan stays complete."""
    _, x = cluster(4096, seed=0)
    if shuffled:
        x = x[np.random.default_rng(3).permutation(len(x))]
    m = np.ones(len(x), np.float32)
    plan, ij = _check(x[off:off + 1024], m[off:off + 1024], off, x, m, 6.0)
    s = plan.stats(25, 1024)
    assert (s["row_tiles"], s["col_tiles"]) == (32, 128)
    # lattice order: about a sixth of the tile pairs (each of the sharded
    # slice's K6 kernels computes ~37.6 GFLOP a launch); shuffled: more
    assert s["share"] <= (0.35 if shuffled else 0.2), s
    assert s["flop"] == 2 * 32 * 32 * 25 * 1024 * s["listed"]


def test_complete_two_blobs_leave_empty_tiles():
    rng = np.random.default_rng(4)
    a = rng.normal(scale=2.0, size=(150, 3))
    b = rng.normal(scale=2.0, size=(150, 3)) + [60.0, 0.0, 0.0]
    x = np.concatenate([a, b])[rng.permutation(300)]
    m = np.ones(300, np.float32)
    plan, _ = _check(x[100:200], m[100:200], 100, x, m, 6.0)
    assert not bool(_reach(plan).all())   # the blobs' tiles never meet


def test_complete_masked_atoms_at_origin():
    rng = np.random.default_rng(5)
    P = 200
    x = rng.uniform(-10.0, 10.0, (P, 3))
    m = np.ones(P, np.float32)
    m[rng.choice(P, 70, replace=False)] = 0.0
    x[m == 0] = 0.0
    plan, _ = _check(x[40:160], m[40:160], 40, x, m, 4.0)
    # the 130 real columns fill the first tiles; the last column tile holds
    # only masked atoms and is listed with no row tile
    assert not bool(_reach(plan)[:, -1].any())


@pytest.mark.parametrize("P,off,Pr", [(45, 13, 20), (20, 0, 20), (70, 69, 1),
                                      (33, 1, 32)])
def test_complete_ragged_and_small(P, off, Pr):
    x, m = _system(P, P + Pr, box=8.0, masked=0.0)
    plan, _ = _check(x[off:off + Pr], m[off:off + Pr], off, x, m, 4.0)
    assert plan.perm_r.shape == (Pr,) and plan.perm_c.shape == (P,)


def test_complete_pair_at_exactly_the_cutoff():
    """A row atom and a column atom exactly 6 A apart in f32, in different
    tiles: the kernel keeps the pair (d <= rc), so their tiles must be
    listed."""
    x = np.zeros((64, 3), np.float32)
    x[:31, 0] = -50.0 - np.arange(31)
    x[31] = [0.0, 0.0, 0.0]
    x[32] = [6.0, 0.0, 0.0]
    x[33:, 0] = 56.0 + np.arange(31)
    m = np.ones(64, np.float32)
    plan, ij = _check(x[:32], m[:32], 0, x, m, 6.0)
    assert any(int(i) == 31 and int(j) == 32 for i, j in ij)
    pos_c = torch.empty(64, dtype=torch.long)
    pos_c[plan.perm_c.long()] = torch.arange(64)
    assert pos_c[31] // TILE != pos_c[32] // TILE


def test_complete_last_row_block_of_a_system():
    """The last of five row blocks of 1000 atoms (200 rows from 800), the
    block ragged against the tile, masked atoms among the rows."""
    _, x = cluster(1000, seed=1)
    m = np.ones(1000, np.float32)
    m[::17] = 0.0
    x[m == 0] = 0.0
    _check(x[800:], m[800:], 800, x, m, 6.0)


def test_plan_is_deterministic():
    _, x = cluster(1000, seed=2)
    x = torch.tensor(x[np.random.default_rng(6).permutation(1000)],
                     dtype=torch.float32)
    m = torch.ones(1000)
    a = rect_tile_plan(x[250:500], m[250:500], 250, x, m, 6.0)
    b = rect_tile_plan(x[250:500].clone(), m[250:500].clone(), 250,
                       x.clone(), m.clone(), 6.0)
    assert a.off == b.off == 250
    for u, v in zip(a[1:], b[1:]):
        assert torch.equal(u, v)


def _k5_plan_before(coords, mask, cutoff):
    """K5's ``tile_plan`` as it was before its ordering and reach test were
    factored out (``_plan_tiles``, ``_reach``): the reference its output
    must keep bit for bit."""
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
    lo = lo.view(T, TILE, 3).amin(1)
    hi = hi.view(T, TILE, 3).amax(1)
    gap = torch.clamp(torch.maximum(lo[None] - hi[:, None],
                                    lo[:, None] - hi[None]), min=0.0)
    reach = (gap * gap).sum(-1) <= (float(cutoff) + REACH_SLACK) ** 2
    cnt = reach.sum(1, dtype=torch.int32)
    row_ptr = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(cnt, 0)
    rank = torch.cumsum(reach, 1, dtype=torch.int32) - reach.int()
    up = torch.triu(reach).nonzero()
    pI, pJ = up[:, 0], up[:, 1]
    e_ij = row_ptr[pI] + rank[pI, pJ]
    e_ji = row_ptr[pJ] + rank[pJ, pI]
    cols = torch.zeros(max(2 * up.shape[0], 1), dtype=torch.int32,
                       device=dev)
    cols[e_ij.long()] = pJ.int()
    cols[e_ji.long()] = pI.int()
    xm = torch.cat([xs, rs[:, None].to(torch.float32)], 1).contiguous()
    pairs = torch.stack([pI, pJ, e_ij, e_ji], 1).to(torch.int32)
    return (order.to(torch.int32), xm, lo, hi, row_ptr, cols,
            pairs.contiguous())


@pytest.mark.parametrize("system", ["random", "cluster", "masked", "small"])
def test_k5_plan_unchanged_by_the_refactor(system):
    rng = np.random.default_rng(9)
    if system == "random":
        x, m = _system(300, 9)
    elif system == "cluster":
        x = cluster(2000, seed=3)[1][rng.permutation(2000)]
        m = np.ones(2000, np.float32)
    elif system == "masked":
        x, m = _system(150, 10, box=12.0, masked=0.4)
        x[m == 0] = 0.0
    else:
        x, m = _system(20, 11, box=5.0)
    x, m = torch.tensor(x, dtype=torch.float32), torch.tensor(m)
    for u, v in zip(tile_plan(x, m, 5.0), _k5_plan_before(x, m, 5.0)):
        assert u.dtype == v.dtype and torch.equal(u, v)
