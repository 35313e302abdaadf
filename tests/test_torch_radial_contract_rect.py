"""Port K6 (radial_contract_rect) plain version against the JAX package's
``radial_contract_rect_reference``, the way the JAX package's own test
reaches K6 on the CPU (tests/test_spatial.py): forward and the VJP (rows,
columns and feats, ``jax.vjp`` against autograd) in f64 to 1e-10, both
``div_d`` values, offsets 0/8/16/32, masked atoms, Pr not a multiple of 8.
Also: rect rows equal the plain K5 rows; the row and column
coordinate-gradient formulas the CUDA kernel uses (one S = g_I feats_J^T
product, then the radial-derivative ladder once per pair), written out in
numpy and held against autograd; a numpy mirror of the kernel's walk over
the rect tile plan (one S per listed (row tile, column tile) pair, both
sides' partial sums in per-pair slots, each side reduced in its own list
order through its permutation) held against the JAX reference's VJP, and
faulty twins of it that must fail; numpy mirrors of the forward kernel's
walk (each row tile over its column list) and of the feats-gradient
kernel's walk (each column tile over its row list, in chunks of 4 row
atoms) on the same plan, held against the JAX reference's forward and
its VJP in feats, and faulty twins of them that must fail; the CPU
wrapper takes the plain version, ignores ``plan=`` and launches
nothing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.mlip.pallas_ops import radial_contract_rect_reference
from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
from pdb2reaction_tpu_torch.mlip.radial_contract import TILE, rect_tile_plan

TOL = 1e-10          # f64: the same math, sums reordered
Pc, F = 45, 10


def _inputs(seed, P=Pc):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, 6.0, (P, 3))
    mask = (rng.uniform(size=P) > 0.25).astype(np.float64)
    coords[mask == 0] = 0.0              # padding atoms sit at the origin
    feats = rng.normal(size=(P, F))
    return coords, mask, feats, rng


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0), \
        np.abs(a - b).max()


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("off,Pr", [(0, 8), (8, 13), (16, 8), (32, 13)])
def test_plain_rect_matches_jax_reference(div_d, off, Pr):
    R, cutoff = 5, 4.5
    coords, mask, feats, rng = _inputs(seed=off + Pr)
    rows = slice(off, off + Pr)
    g = rng.normal(size=(Pr, R + 1, F))
    T_j, vjp = jax.vjp(
        lambda cr, cc, f: radial_contract_rect_reference(
            cr, jnp.asarray(mask[rows]), off, cc, jnp.asarray(mask), f,
            cutoff, R, div_d),
        jnp.asarray(coords[rows]), jnp.asarray(coords), jnp.asarray(feats))
    dcr_j, dcc_j, df_j = vjp(jnp.asarray(g))

    cr = torch.tensor(coords[rows], requires_grad=True)
    cc = torch.tensor(coords, requires_grad=True)
    f = torch.tensor(feats, requires_grad=True)
    T_t = rcm.radial_contract_rect_plain(cr, torch.tensor(mask[rows]), off,
                                         cc, torch.tensor(mask), f, cutoff,
                                         R, div_d)
    dcr_t, dcc_t, df_t = torch.autograd.grad(T_t, [cr, cc, f],
                                             torch.tensor(g))
    for a, b in ((T_t.detach(), T_j), (dcr_t, dcr_j), (dcc_t, dcc_j),
                 (df_t, df_j)):
        _close(a, b)
    # masked rows contribute nothing; the self-pair is excluded by the
    # global index (a zero distance would give an infinite A/d)
    assert np.all(T_t.detach().numpy()[mask[rows] == 0] == 0.0)
    assert np.all(np.isfinite(T_t.detach().numpy()))


@pytest.mark.parametrize("div_d", [False, True])
def test_rect_rows_equal_the_square_rows(div_d):
    coords, mask, feats, _ = _inputs(seed=4)
    c, m, f = (torch.tensor(a) for a in (coords, mask, feats))
    T_sq = rcm.radial_contract_plain(c, m, f, 4.0, 6, div_d)
    for off, Pr in [(0, 8), (8, 13), (16, 8), (32, 13)]:
        T_r = rcm.radial_contract_rect_plain(c[off:off + Pr],
                                             m[off:off + Pr], off, c, m, f,
                                             4.0, 6, div_d)
        _close(T_r, T_sq[off:off + Pr], 1e-13)


def test_wrapper_takes_plain_version_on_cpu():
    coords, mask, feats, _ = _inputs(seed=3)
    before = dict(rcm.launches), dict(rcm.rect_launches)
    t = [torch.tensor(a, dtype=torch.float32)
         for a in (coords, mask, feats)]
    args = (t[0][8:21], t[1][8:21], 8, t[0], t[1], t[2], 5.0, 6, True)
    out = rcm.radial_contract_rect(*args)
    assert out.shape == (13, 7, F) and out.dtype == torch.float32
    assert torch.equal(out, rcm.radial_contract_rect_plain(*args))
    assert (dict(rcm.launches), dict(rcm.rect_launches)) == before


def _ladder(diff, pair, S, rc, R, div_d):
    """G = sum_r dA_r/dd S_r over pairs ``pair`` inside the cutoff, by the
    kernel's sin/cos recurrence (csrc/radial_contract.cu: accum_g), and
    1/d (d = 1 outside)."""
    d = np.sqrt(np.maximum((diff ** 2).sum(-1), 1e-12))
    within = (d <= rc) & pair
    d = np.where(within, d, 1.0)
    s1, c1 = np.sin(np.pi / rc * d), np.cos(np.pi / rc * d)
    env = np.where(within, 0.5 * (c1 + 1.0), 0.0)
    denv = np.where(within, -0.5 * np.pi / rc * s1, 0.0)
    inv = 1.0 / d
    p = 2.0 if div_d else 1.0
    base = np.sqrt(2.0 / rc) * inv ** p
    s, c, G = s1, c1, np.zeros_like(d)
    for r in range(R):
        freq = (r + 1) * np.pi / rc
        G += base * (freq * c * env + s * denv - p * s * env * inv) * S[r]
        s, c = s * c1 + c * s1, c * c1 - s * s1
    G += inv ** (p - 1) * (denv - (p - 1) * env * inv) * S[R]
    return np.where(within, G, 0.0), inv


def _kernel_formula_dxyz(xr, mr, off, xc, mc, feats, g, rc, R, div_d):
    """(dx_rows, dx_cols) as the CUDA coordinate kernel forms them
    (csrc/radial_contract.cu: rc_coords_pairs<RECT>, here over all pairs
    at once): S = g_I feats_J^T over all features, G = sum_r dA_r/dd S_r
    with the sin/cos ladder by the coupled rotation recurrence, then
    dx_rows[i] = sum_j G (x_i - x_j)/d and dx_cols[j] = sum_i G (x_j -
    x_i)/d."""
    S = np.einsum("irf,jf->rij", g, feats)
    diff = xr[:, None, :] - xc[None, :, :]
    gi = off + np.arange(xr.shape[0])
    gj = np.arange(xc.shape[0])
    pair = ((gi[:, None] != gj[None, :]) & (mr[:, None] > 0)
            & (mc[None, :] > 0))
    G, inv = _ladder(diff, pair, S, rc, R, div_d)
    w = (G * inv)[:, :, None] * diff
    return w.sum(1), -w.sum(0)


def _rect_plan_mirror_dxyz(xr, mr, off, xc, mc, feats, g, rc, R, div_d,
                           fault=None):
    """csrc/radial_contract.cu: rc_coords_pairs<RECT> +
    rc_rect_coords_reduce in numpy, on the rect tile plan of (rows,
    columns): one block per listed (row tile I, column tile J) pair forms
    S = g_I feats_J^T once, excludes self-pairs by global index (off +
    perm_r[a] against perm_c[b]), writes the row side's partial dx to slot
    e_row and the column side's to slot e_col; each row then sums its
    tile's slots in row-list order, each column in column-list order, and
    the results go out through perm_r and perm_c. ``fault`` makes a faulty
    twin: "plan_positions" tests self-pairs by plan position,
    "column_slots_by_row_list" writes the column side to slot e_row."""
    plan = rect_tile_plan(torch.tensor(xr), torch.tensor(mr), off,
                          torch.tensor(xc), torch.tensor(mc), rc)
    perm_r = plan.perm_r.numpy().astype(np.int64)
    perm_c = plan.perm_c.numpy().astype(np.int64)
    Tr, Tc = plan.row_ptr.shape[0] - 1, plan.col_ptr.shape[0] - 1

    def padded(a, perm, T):
        out = np.zeros((T * TILE,) + a.shape[1:])
        out[:len(perm)] = a[perm]
        return out

    xrs, mrs, gs = (padded(a, perm_r, Tr) for a in (xr, mr, g))
    xcs, mcs, fs = (padded(a, perm_c, Tc) for a in (xc, mc, feats))
    gid_r = np.full(Tr * TILE, -1)
    gid_r[:len(perm_r)] = off + perm_r
    gid_c = np.full(Tc * TILE, -2)
    gid_c[:len(perm_c)] = perm_c
    if fault == "plan_positions":
        gid_r, gid_c = np.arange(Tr * TILE), np.arange(Tc * TILE)
    n = plan.pairs.shape[0]
    part_r = np.full((n, TILE, 3), np.nan)
    part_c = np.full((n, TILE, 3), np.nan)
    for I, J, e_row, e_col in plan.pairs.numpy():
        a, b = slice(I * TILE, (I + 1) * TILE), slice(J * TILE, (J + 1) * TILE)
        S = np.einsum("irf,jf->rij", gs[a], fs[b])
        diff = xrs[a][:, None, :] - xcs[b][None, :, :]
        pair = ((gid_r[a][:, None] != gid_c[b][None, :])
                & (mrs[a][:, None] > 0) & (mcs[b][None, :] > 0))
        G, inv = _ladder(diff, pair, S, rc, R, div_d)
        wd = (G * inv)[:, :, None] * diff
        part_r[e_row] = wd.sum(1)
        part_c[e_row if fault == "column_slots_by_row_list" else e_col] = \
            -wd.sum(0)
    out = []
    for part, ptr, perm, T in ((part_r, plan.row_ptr, perm_r, Tr),
                               (part_c, plan.col_ptr, perm_c, Tc)):
        ptr = ptr.numpy()
        dx = np.zeros((T * TILE, 3))
        for I in range(T):
            for e in range(ptr[I], ptr[I + 1]):
                dx[I * TILE:(I + 1) * TILE] += part[e]
        res = np.empty((len(perm), 3))
        res[perm] = dx[:len(perm)]
        out.append(res)
    return out


def _blobs(P, rng):
    """Two clusters ~14 A apart in shuffled order: tiles of either never
    reach the other's."""
    x = rng.normal(scale=2.5, size=(P, 3))
    x[: P // 2, 0] += 14.0
    return x[rng.permutation(P)]


def _jax_dxyz(coords, mask, off, Pr, feats, g, rc, R, div_d):
    rows = slice(off, off + Pr)
    _, vjp = jax.vjp(
        lambda cr, cc: radial_contract_rect_reference(
            cr, jnp.asarray(mask[rows]), off, cc, jnp.asarray(mask),
            jnp.asarray(feats), rc, R, div_d),
        jnp.asarray(coords[rows]), jnp.asarray(coords))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("system,off,Pr", [
    ("spread", 0, 75), ("spread", 100, 75), ("spread", 260, 40),
    ("blobs", 150, 90)])
def test_rect_plan_coordinate_gradients_mirror_matches_jax(div_d, system,
                                                           off, Pr):
    """The coordinate kernel's walk over the rect plan, mirrored in numpy,
    against the JAX reference's VJP in f64 for the rows and the columns:
    several offsets, ragged row blocks and tiles, masked atoms (their rows
    exactly 0), a system whose tiles never meet half of the others."""
    rng = np.random.default_rng(7 + div_d + off)
    P, F, R, rc = 300, 6, 5, 4.0
    coords = (rng.uniform(0.0, 30.0, (P, 3)) if system == "spread"
              else _blobs(P, rng))
    mask = (rng.uniform(size=P) > 0.15).astype(np.float64)
    coords[mask == 0] = 0.0
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(Pr, R + 1, F))
    rows = slice(off, off + Pr)
    s = rect_tile_plan(torch.tensor(coords[rows]), torch.tensor(mask[rows]),
                       off, torch.tensor(coords), torch.tensor(mask),
                       rc).stats()
    assert s["listed"] < s["row_tiles"] * s["col_tiles"]   # some skipped
    dcr_j, dcc_j = _jax_dxyz(coords, mask, off, Pr, feats, g, rc, R, div_d)
    dcr, dcc = _rect_plan_mirror_dxyz(coords[rows], mask[rows], off, coords,
                                      mask, feats, g, rc, R, div_d)
    _close(dcr, dcr_j)
    _close(dcc, dcc_j)
    assert np.all(dcr[mask[rows] == 0] == 0.0)
    assert np.all(dcc[mask == 0] == 0.0)


@pytest.mark.parametrize("fault", ["plan_positions",
                                   "column_slots_by_row_list"])
def test_rect_plan_mirror_faulty_twins_fail(fault):
    """The same check catches a kernel that tests self-pairs by plan
    position (rows and columns are ordered apart, so on a block at an
    offset it drops real pairs) and one that stores the column side's
    partial sums in the row list's slots."""
    rng = np.random.default_rng(12)
    P, F, R, rc, off, Pr = 120, 6, 5, 4.5, 50, 40
    coords = rng.uniform(0.0, 10.0, (P, 3))
    mask = np.ones(P)
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(Pr, R + 1, F))
    rows = slice(off, off + Pr)
    want = _jax_dxyz(coords, mask, off, Pr, feats, g, rc, R, False)
    args = (coords[rows], mask[rows], off, coords, mask, feats, g, rc, R,
            False)
    for a, b in zip(_rect_plan_mirror_dxyz(*args), want):
        _close(a, b)
    bad = _rect_plan_mirror_dxyz(*args, fault=fault)
    with pytest.raises(AssertionError):
        for a, b in zip(bad, want):
            _close(a, b)


def test_plan_argument_is_ignored_on_cpu():
    """On CPU tensors ``plan=`` changes nothing: the plain version runs,
    no kernel is launched, and no plan is built."""
    coords, mask, feats, rng = _inputs(seed=5)
    t = [torch.tensor(a, dtype=torch.float32)
         for a in (coords, mask, feats)]
    plan = rect_tile_plan(t[0][8:21], t[1][8:21], 8, t[0], t[1], 5.0)
    before = dict(rcm.launches), dict(rcm.rect_launches), dict(rcm.plans)
    g = torch.tensor(rng.normal(size=(13, 7, F)), dtype=torch.float32)
    for div_d in (False, True):
        got, ref = [], []
        for kw, out in (({"plan": plan}, got), ({}, ref)):
            cr = t[0][8:21].clone().requires_grad_(True)
            cc = t[0].clone().requires_grad_(True)
            T = rcm.radial_contract_rect(cr, t[1][8:21], 8, cc, t[1], t[2],
                                         5.0, 6, div_d, **kw)
            out += [T, *torch.autograd.grad(T, [cr, cc], g)]
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (dict(rcm.launches), dict(rcm.rect_launches),
            dict(rcm.plans)) == before


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("off,Pr", [(0, 13), (16, 8), (32, 13)])
def test_kernel_row_and_column_gradient_formulas(div_d, off, Pr):
    R, rc = 6, 4.5
    coords, mask, feats, rng = _inputs(seed=11 + off)
    rows = slice(off, off + Pr)
    g = rng.normal(size=(Pr, R + 1, F))
    cr = torch.tensor(coords[rows], requires_grad=True)
    cc = torch.tensor(coords, requires_grad=True)
    T = rcm.radial_contract_rect_plain(cr, torch.tensor(mask[rows]), off, cc,
                                       torch.tensor(mask),
                                       torch.tensor(feats), rc, R, div_d)
    dcr, dcc = torch.autograd.grad(T, [cr, cc], torch.tensor(g))
    dxr, dxc = _kernel_formula_dxyz(coords[rows], mask[rows], off, coords,
                                    mask, feats, g, rc, R, div_d)
    _close(dxr, dcr.numpy())
    _close(dxc, dcc.numpy())


def _adjacency(xa, ma, ga, xb, mb, gb, rc, R, div_d):
    """A [a, b, R+1] between two sets of atoms (coordinates, masks, global
    indices) as the kernels build a tile of it (csrc/radial_contract.cu:
    pair_geo, a_column): pairs inside the cutoff, both atoms real, global
    indices apart; sin((r+1) t) by the coupled rotation recurrence."""
    diff = xa[:, None, :] - xb[None, :, :]
    d = np.sqrt(np.maximum((diff ** 2).sum(-1), 1e-12))
    within = ((d <= rc) & (ga[:, None] != gb[None, :]) & (ma[:, None] > 0)
              & (mb[None, :] > 0))
    d = np.where(within, d, 1.0)
    s1, c1 = np.sin(np.pi / rc * d), np.cos(np.pi / rc * d)
    env = np.where(within, 0.5 * (c1 + 1.0), 0.0)
    scale = env / d * np.sqrt(2.0 / rc)
    ench = env
    if div_d:
        scale, ench = scale / d, ench / d
    A = np.empty(d.shape + (R + 1,))
    s, c = s1, c1
    for r in range(R):
        A[..., r] = s * scale
        s, c = s * c1 + c * s1, c * c1 - s * s1
    A[..., R] = ench
    return A


def _plan_sides(xr, mr, off, xc, mc, rc, fault):
    """The rect plan of (rows, columns) and each side padded to whole
    tiles in plan order: (plan, rows (x, mask, global index, perm),
    columns (the same)). ``fault == "plan_positions"`` gives plan
    positions in place of global indices."""
    plan = rect_tile_plan(torch.tensor(xr), torch.tensor(mr), off,
                          torch.tensor(xc), torch.tensor(mc), rc)
    sides = []
    for x, m, perm, base, empty in ((xr, mr, plan.perm_r, off, -1),
                                    (xc, mc, plan.perm_c, 0, -2)):
        perm = perm.numpy().astype(np.int64)
        T = -(-len(perm) // TILE)
        xs, ms = np.zeros((T * TILE, 3)), np.zeros(T * TILE)
        xs[:len(perm)], ms[:len(perm)] = x[perm], m[perm]
        gid = np.full(T * TILE, empty)
        gid[:len(perm)] = base + perm
        if fault == "plan_positions":
            gid = np.arange(T * TILE)
        sides.append((xs, ms, gid, perm))
    return plan, sides[0], sides[1]


def _rect_fwd_mirror(xr, mr, off, xc, mc, feats, rc, R, div_d, fault=None):
    """csrc/radial_contract.cu: fwd_tc / fwd_fma with RECT in numpy, on the
    rect tile plan: each row tile walks its column list (row_ptr, cols) in
    list order, builds the [rows, 32, R+1] adjacency tile of each listed
    column tile from the plan's coordinates (self-pairs by global index,
    off + perm_r against perm_c) and contracts it with the tile's feats
    rows, read through perm_c; the rows go out through perm_r, and a row
    tile that lists nothing writes zeros. ``fault``: "plan_positions"
    tests self-pairs by plan position."""
    plan, (xrs, mrs, gr, perm_r), (xcs, mcs, gc, perm_c) = _plan_sides(
        xr, mr, off, xc, mc, rc, fault)
    fs = np.zeros((len(xcs), feats.shape[1]))
    fs[:len(perm_c)] = feats[perm_c]
    row_ptr, cols = plan.row_ptr.numpy(), plan.cols.numpy()
    acc = np.zeros((len(xrs), R + 1, feats.shape[1]))
    for I in range(len(row_ptr) - 1):
        a = slice(I * TILE, (I + 1) * TILE)
        for J in cols[row_ptr[I]:row_ptr[I + 1]]:
            b = slice(J * TILE, (J + 1) * TILE)
            A = _adjacency(xrs[a], mrs[a], gr[a], xcs[b], mcs[b], gc[b], rc,
                           R, div_d)
            acc[a] += np.einsum("ijr,jf->irf", A, fs[b])
    out = np.full((len(perm_r), R + 1, feats.shape[1]), np.nan)
    out[perm_r] = acc[:len(perm_r)]
    return out


def _rect_feats_mirror(xr, mr, off, xc, mc, g, rc, R, div_d, fault=None):
    """csrc/radial_contract.cu: feats_plan with RECT in numpy, on the rect
    tile plan: each column tile walks its row list (col_ptr, rows) in list
    order, in chunks of 4 row atoms, k = (i, r) contiguous as g's rows lie
    (read through perm_r): dfeats[j] += sum_k A[j][k] g[k]; the columns go
    out through perm_c into an output filled with NaN first, every column
    tile writing its rows (zeros when its list is empty). ``fault``:
    "plan_positions" tests self-pairs by plan position; "row_lists" walks
    the forward's row lists (row_ptr, cols) as if they were the column
    tile's; "empty_unwritten" leaves a column tile with an empty list
    unwritten."""
    plan, (xrs, mrs, gr, perm_r), (xcs, mcs, gc, perm_c) = _plan_sides(
        xr, mr, off, xc, mc, rc, fault)
    F = g.shape[2]
    gs = np.zeros((len(xrs), R + 1, F))
    gs[:len(perm_r)] = g[perm_r]
    Tr, Tc = len(xrs) // TILE, len(xcs) // TILE
    if fault == "row_lists":
        ptr, lst = plan.row_ptr.numpy(), plan.cols.numpy()
        ptr = np.concatenate([ptr, np.full(Tc - Tr, ptr[-1])]) \
            if Tc > Tr else ptr
    else:
        ptr, lst = plan.col_ptr.numpy(), plan.rows.numpy()
    out = np.full((len(perm_c), F), np.nan)
    acc = np.zeros((len(xcs), F))
    for J in range(Tc):
        b = slice(J * TILE, (J + 1) * TILE)
        listed = [I for I in lst[ptr[J]:ptr[J + 1]] if I < Tr]
        if not listed and fault == "empty_unwritten":
            continue
        for I in listed:
            for i0 in range(I * TILE, (I + 1) * TILE, 4):
                a = slice(i0, i0 + 4)
                A = _adjacency(xcs[b], mcs[b], gc[b], xrs[a], mrs[a], gr[a],
                               rc, R, div_d)                # [32, 4, R+1]
                acc[b] += A.reshape(TILE, -1) @ gs[a].reshape(-1, F)
        cols = perm_c[J * TILE:(J + 1) * TILE]
        out[cols] = acc[J * TILE:J * TILE + len(cols)]
    return out


def _system(kind, P, rng):
    """"spread": uniform in a 30 A box; "blobs": two clusters 14 A apart,
    the first half of the atoms in one (a row block of it leaves whole
    column tiles out of reach: their lists are empty); "masked": spread
    with 45% masked atoms (whole row tiles of them, which list nothing).
    Masked atoms sit at the origin."""
    if kind == "blobs":
        x = rng.normal(scale=2.5, size=(P, 3))
        x[P // 2:, 0] += 14.0
    else:
        x = rng.uniform(0.0, 30.0, (P, 3))
    mask = (rng.uniform(size=P) > (0.45 if kind == "masked" else 0.15)) \
        .astype(np.float64)
    x[mask == 0] = 0.0
    return x, mask


def _jax_fwd_dfeats(coords, mask, off, Pr, feats, g, rc, R, div_d):
    rows = slice(off, off + Pr)
    T, vjp = jax.vjp(
        lambda f: radial_contract_rect_reference(
            jnp.asarray(coords[rows]), jnp.asarray(mask[rows]), off,
            jnp.asarray(coords), jnp.asarray(mask), f, rc, R, div_d),
        jnp.asarray(feats))
    return T, vjp(jnp.asarray(g))[0]


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("system,off,Pr", [
    ("spread", 0, 75), ("spread", 100, 75), ("spread", 260, 40),
    ("blobs", 0, 150), ("blobs", 200, 100), ("masked", 0, 96),
    ("masked", 130, 96), ("masked", 204, 96)])
def test_rect_plan_forward_and_feats_mirrors_match_jax(div_d, system, off,
                                                       Pr):
    """The forward kernel's walk (row tiles over their column lists) and
    the feats-gradient kernel's walk (column tiles over their row lists,
    chunks of 4 row atoms), mirrored in numpy on the rect tile plan,
    against the JAX reference's forward and its VJP in feats in f64: the
    first, a middle and the last row block, ragged blocks and tiles,
    masked atoms (their forward rows exactly 0), column tiles with empty
    lists (blobs) and row tiles with empty lists (masked)."""
    rng = np.random.default_rng(21 + off + div_d)
    P, F, R, rc = 300, 6, 5, 4.0
    coords, mask = _system(system, P, rng)
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(Pr, R + 1, F))
    rows = slice(off, off + Pr)
    plan = rect_tile_plan(torch.tensor(coords[rows]),
                          torch.tensor(mask[rows]), off,
                          torch.tensor(coords), torch.tensor(mask), rc)
    empty_cols = int((np.diff(plan.col_ptr.numpy()) == 0).sum())
    empty_rows = int((np.diff(plan.row_ptr.numpy()) == 0).sum())
    if system == "blobs":
        assert empty_cols > 0
    if system == "masked":
        assert empty_rows > 0
    T_j, df_j = _jax_fwd_dfeats(coords, mask, off, Pr, feats, g, rc, R,
                                div_d)
    args = (coords[rows], mask[rows], off, coords, mask)
    T_m = _rect_fwd_mirror(*args, feats, rc, R, div_d)
    df_m = _rect_feats_mirror(*args, g, rc, R, div_d)
    _close(T_m, T_j)
    _close(df_m, df_j)
    assert np.all(T_m[mask[rows] == 0] == 0.0)


@pytest.mark.parametrize("fault", ["plan_positions", "row_lists",
                                   "empty_unwritten"])
def test_rect_plan_forward_and_feats_faulty_twins_fail(fault):
    """The same check catches a forward or feats kernel that tests
    self-pairs by plan position, a feats kernel that walks the row lists
    in place of its column tile's, and one that leaves a column tile with
    an empty list unwritten (its output was filled with NaN)."""
    rng = np.random.default_rng(30)
    P, F, R, rc, off, Pr = 300, 6, 5, 4.0, 40, 110
    coords, mask = _system("blobs", P, rng)
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(Pr, R + 1, F))
    rows = slice(off, off + Pr)
    T_j, df_j = _jax_fwd_dfeats(coords, mask, off, Pr, feats, g, rc, R,
                                False)
    args = (coords[rows], mask[rows], off, coords, mask)

    def both(fault):
        return (_rect_fwd_mirror(*args, feats, rc, R, False,
                                 fault if fault == "plan_positions"
                                 else None),
                _rect_feats_mirror(*args, g, rc, R, False, fault))

    for a, b in zip(both(None), (T_j, df_j)):
        _close(a, b)
    with pytest.raises(AssertionError):
        for a, b in zip(both(fault), (T_j, df_j)):
            _close(a, b)
