"""Port K5 (radial_contract) plain version against the JAX package's
``radial_contract_reference``: forward and the VJP (coordinates and
features, ``jax.vjp`` against autograd) in f64 to 1e-10, both ``div_d``
values, masked atoms, P not a multiple of 8. Also the coordinate-gradient
formula the CUDA kernel uses (S1 + S2 summed over all features, then the
radial-derivative ladder once per pair), written out here in f64 and held
against autograd, and mirrors of the kernels' algorithms on a tile plan
held against the JAX reference's VJP: the coordinate gradient (one Ssym
per listed I <= J tile pair, partial sums in per-pair slots reduced in
reach-list order) and the feats gradient (each row tile's reach list in
list order, A[j, (i, r)] contracted with g's rows, written through the
plan's permutation)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.mlip.pallas_ops import radial_contract_reference
from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
from pdb2reaction_tpu_torch.mlip.radial_contract import TILE, tile_plan
from pdb2reaction_tpu_torch.mlip.radial import (bessel_basis,
                                                cosine_envelope,
                                                gaussian_basis)

TOL = 1e-10          # f64: the same math, sums reordered


def _inputs(P=13, F=12, seed=0):
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
@pytest.mark.parametrize("P,R,cutoff", [(13, 4, 5.0), (21, 8, 4.0)])
def test_plain_matches_jax_reference(div_d, P, R, cutoff):
    coords, mask, feats, rng = _inputs(P=P, seed=P + R)
    g = rng.normal(size=(P, R + 1, feats.shape[1]))
    T_j, vjp = jax.vjp(
        lambda c, f: radial_contract_reference(c, jnp.asarray(mask), f,
                                               cutoff, R, div_d),
        jnp.asarray(coords), jnp.asarray(feats))
    dc_j, df_j = vjp(jnp.asarray(g))

    c = torch.tensor(coords, requires_grad=True)
    f = torch.tensor(feats, requires_grad=True)
    T_t = rcm.radial_contract_plain(c, torch.tensor(mask), f, cutoff, R,
                                    div_d)
    dc_t, df_t = torch.autograd.grad(T_t, [c, f], torch.tensor(g))
    _close(T_t.detach(), T_j)
    _close(dc_t, dc_j)
    _close(df_t, df_j)
    # padding rows and columns contribute nothing
    assert np.all(T_t.detach().numpy()[mask == 0] == 0.0)
    assert np.all(dc_t.numpy()[mask == 0] == 0.0)


def test_wrapper_takes_plain_version_on_cpu():
    coords, mask, feats, _ = _inputs(P=10, F=8, seed=3)
    before = dict(rcm.launches)
    args = (torch.tensor(coords, dtype=torch.float32),
            torch.tensor(mask, dtype=torch.float32),
            torch.tensor(feats, dtype=torch.float32), 5.0, 6, True)
    out = rcm.radial_contract(*args)
    assert out.shape == (10, 7, 8) and out.dtype == torch.float32
    assert torch.equal(out, rcm.radial_contract_plain(*args))
    assert rcm.launches == before


def _kernel_formula_dcoords(x, m, feats, g, rc, R, div_d):
    """dx_i = sum_j (G1 + G2^T)[i,j] (x_i - x_j)/d, G = sum_r dA_r/dd S_r,
    S = S1 + S2 over all features (csrc/radial_contract.cu:rc_bwd_coords),
    the sin/cos ladder by the coupled rotation recurrence."""
    P = x.shape[0]
    S1 = np.einsum("irf,jf->rij", g, feats)
    S2 = np.einsum("jrf,if->rij", g, feats)
    S = S1 + S2
    diff = x[:, None, :] - x[None, :, :]
    G, inv = _ladder(diff, ~np.eye(P, dtype=bool) & (m[:, None] > 0)
                     & (m[None, :] > 0), S, rc, R, div_d)
    return (G[:, :, None] * diff * inv[:, :, None]).sum(1)


def _ladder(diff, pair, S, rc, R, div_d):
    """G = sum_r dA_r/dd S_r over pairs ``pair`` inside the cutoff, by the
    kernels' sin/cos recurrence, and 1/d (d = 1 outside)."""
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


def _plan_mirror_dcoords(x, m, feats, g, rc, R, div_d):
    """csrc/radial_contract.cu:rc_coords_pairs + rc_coords_reduce in
    numpy: on the tile plan of (x, m), one block per listed tile pair
    I <= J forms Ssym = S1[i, j] + S1[j, i] (S1 = g_I feats_J^T) once,
    writes the I side's partial dx to slot e_IJ and, off the diagonal,
    the J side's to slot e_JI; each atom then sums its tile's slots in
    reach-list order. Indices are plan positions."""
    P = x.shape[0]
    plan = tile_plan(torch.tensor(x), torch.tensor(m), rc)
    perm = plan.perm.numpy().astype(np.int64)
    Pp = plan.n_tiles * TILE

    def padded(a):
        out = np.zeros((Pp,) + a.shape[1:])
        out[:P] = a[perm]
        return out

    xs, ms, fs, gs = padded(x), padded(m), padded(feats), padded(g)
    idx = np.arange(Pp)
    part = np.full((plan.cols.shape[0], TILE, 3), np.nan)
    for I, J, e_ij, e_ji in plan.pairs.numpy():
        a, b = slice(I * TILE, (I + 1) * TILE), slice(J * TILE, (J + 1) * TILE)
        Ssym = (np.einsum("irf,jf->rij", gs[a], fs[b])
                + np.einsum("jrf,if->rij", gs[b], fs[a]))
        diff = xs[a][:, None, :] - xs[b][None, :, :]
        pair = ((idx[a][:, None] != idx[b][None, :])
                & (ms[a][:, None] > 0) & (ms[b][None, :] > 0))
        G, inv = _ladder(diff, pair, Ssym, rc, R, div_d)
        wd = (G * inv)[:, :, None] * diff
        part[e_ij] = wd.sum(1)
        if I != J:                       # the diagonal writes one side
            part[e_ji] = -wd.sum(0)
    rp = plan.row_ptr.numpy()
    dx = np.zeros((Pp, 3))
    for I in range(plan.n_tiles):
        for e in range(rp[I], rp[I + 1]):
            dx[I * TILE:(I + 1) * TILE] += part[e]
    out = np.zeros((P, 3))
    out[perm] = dx[:P]
    return out


def _a_tile(xj, xi, mj, mi, pj, pi, rc, R, div_d):
    """A[j, i, r] of one pair tile, j as the row, by the kernels'
    sin/cos recurrence (csrc/radial_contract.cu: pair_geo, a_column);
    pj, pi are plan positions (i != j by position)."""
    diff = xj[:, None, :] - xi[None, :, :]
    d = np.sqrt(np.maximum((diff ** 2).sum(-1), 1e-12))
    within = ((d <= rc) & (pj[:, None] != pi[None, :])
              & (mj[:, None] > 0) & (mi[None, :] > 0))
    d = np.where(within, d, 1.0)
    s1, c1 = np.sin(np.pi / rc * d), np.cos(np.pi / rc * d)
    env = np.where(within, 0.5 * (c1 + 1.0), 0.0)
    inv = 1.0 / d
    scale = env * inv * np.sqrt(2.0 / rc)
    ench = env
    if div_d:
        scale, ench = scale * inv, env * inv
    A = np.empty(d.shape + (R + 1,))
    s, c = s1, c1
    for r in range(R):
        A[..., r] = s * scale
        s, c = s * c1 + c * s1, c * c1 - s * s1
    A[..., R] = ench
    return A


def _plan_mirror_dfeats(x, m, g, rc, R, div_d):
    """csrc/radial_contract.cu:rc_feats_plan in numpy: on the tile plan of
    (x, m), each row tile J walks its reach list cols[row_ptr[J]:
    row_ptr[J + 1]] in list order and adds A[j, (i, r)] g[(i, r), :] of
    each listed tile I; its rows are written through perm, so rows of a
    tile with no reach come out 0."""
    P = x.shape[0]
    plan = tile_plan(torch.tensor(x), torch.tensor(m), rc)
    perm = plan.perm.numpy().astype(np.int64)
    Pp = plan.n_tiles * TILE

    def padded(a):
        out = np.zeros((Pp,) + a.shape[1:])
        out[:P] = a[perm]
        return out

    xs, ms, gs = padded(x), padded(m), padded(g)
    pos = np.arange(Pp)
    rp, cols = plan.row_ptr.numpy(), plan.cols.numpy()
    out = np.full((Pp, g.shape[2]), np.nan)
    for J in range(plan.n_tiles):
        b = slice(J * TILE, (J + 1) * TILE)
        acc = np.zeros((TILE, g.shape[2]))
        for I in cols[rp[J]:rp[J + 1]]:
            a = slice(I * TILE, (I + 1) * TILE)
            A = _a_tile(xs[b], xs[a], ms[b], ms[a], pos[b], pos[a], rc, R,
                        div_d)
            acc += A.reshape(TILE, -1) @ gs[a].reshape(-1, g.shape[2])
        out[b] = acc
    res = np.empty((P, g.shape[2]))
    res[perm] = out[:P]
    return res


@pytest.mark.parametrize("div_d", [False, True])
def test_kernel_coordinate_gradient_formula(div_d):
    P, R, rc = 17, 6, 4.5
    coords, mask, feats, rng = _inputs(P=P, F=9, seed=11)
    g = rng.normal(size=(P, R + 1, feats.shape[1]))
    c = torch.tensor(coords, requires_grad=True)
    T = rcm.radial_contract_plain(c, torch.tensor(mask),
                                  torch.tensor(feats), rc, R, div_d)
    (dc,) = torch.autograd.grad(T, [c], torch.tensor(g))
    _close(_kernel_formula_dcoords(coords, mask, feats, g, rc, R, div_d),
           dc.numpy())


def _blobs(P, rng):
    """Two clusters ~14 A apart in shuffled order: tiles of either never
    reach the other's."""
    x = rng.normal(scale=2.5, size=(P, 3))
    x[: P // 2, 0] += 14.0
    return x[rng.permutation(P)]


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("system", ["spread", "blobs"])
def test_plan_coordinate_gradient_mirror_matches_jax(div_d, system):
    """The kernel's tiled coordinate gradient, mirrored in numpy on the
    plan (upper-triangle pair tiles, Ssym, diagonal tiles written once,
    the fixed-order slot reduction), against the JAX reference's VJP in
    f64, with masked atoms and a ragged last tile."""
    rng = np.random.default_rng(7 + div_d)
    P, F, R, rc = 300, 6, 5, 4.0
    if system == "spread":
        coords = rng.uniform(0.0, 30.0, (P, 3))
    else:
        coords = _blobs(P, rng)
    mask = (rng.uniform(size=P) > 0.15).astype(np.float64)
    coords[mask == 0] = 0.0
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(P, R + 1, F))
    plan = tile_plan(torch.tensor(coords), torch.tensor(mask), rc)
    s = plan.stats()
    assert s["listed"] < s["tiles"] ** 2      # some tile pairs are skipped
    _, vjp = jax.vjp(
        lambda c: radial_contract_reference(c, jnp.asarray(mask),
                                            jnp.asarray(feats), rc, R,
                                            div_d), jnp.asarray(coords))
    (dc_j,) = vjp(jnp.asarray(g))
    got = _plan_mirror_dcoords(coords, mask, feats, g, rc, R, div_d)
    _close(got, dc_j)
    assert np.all(got[mask == 0] == 0.0)


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("system", ["spread", "blobs"])
def test_plan_feats_gradient_mirror_matches_jax(div_d, system):
    """The kernel's feats gradient on the plan, mirrored in numpy (each
    row tile's reach list in order, the A[j, (i, r)] layout, rows written
    through perm), against the JAX reference's VJP in f64, with masked
    atoms (their rows exactly 0) and a ragged last tile."""
    rng = np.random.default_rng(17 + div_d)
    P, F, R, rc = 300, 6, 5, 4.0
    if system == "spread":
        coords = rng.uniform(0.0, 30.0, (P, 3))
    else:
        coords = _blobs(P, rng)
    mask = (rng.uniform(size=P) > 0.15).astype(np.float64)
    coords[mask == 0] = 0.0
    feats = rng.normal(size=(P, F))
    g = rng.normal(size=(P, R + 1, F))
    s = tile_plan(torch.tensor(coords), torch.tensor(mask), rc).stats()
    assert s["listed"] < s["tiles"] ** 2      # some tile pairs are skipped
    _, vjp = jax.vjp(
        lambda f: radial_contract_reference(jnp.asarray(coords),
                                            jnp.asarray(mask), f, rc, R,
                                            div_d), jnp.asarray(feats))
    (df_j,) = vjp(jnp.asarray(g))
    got = _plan_mirror_dfeats(coords, mask, g, rc, R, div_d)
    _close(got, df_j)
    assert np.all(got[mask == 0] == 0.0)


def test_plan_argument_is_ignored_on_cpu():
    """On CPU tensors ``plan=`` changes nothing: the plain version runs,
    and no kernel is launched."""
    coords, mask, feats, _ = _inputs(P=40, F=8, seed=5)
    c, m, f = (torch.tensor(a, dtype=torch.float32)
               for a in (coords, mask, feats))
    before = dict(rcm.launches)
    plan = tile_plan(c, m, 5.0)
    for div_d in (False, True):
        assert torch.equal(rcm.radial_contract(c, m, f, 5.0, 6, div_d,
                                               plan=plan),
                           rcm.radial_contract(c, m, f, 5.0, 6, div_d))
    assert rcm.launches == before


def test_radial_bases_match_jax():
    from pdb2reaction_tpu.mlip import radial as jr
    d = np.linspace(0.0, 7.0, 29)
    for t, j in ((cosine_envelope(torch.tensor(d), 5.0),
                  jr.cosine_envelope(jnp.asarray(d), 5.0)),
                 (bessel_basis(torch.tensor(d), 5.0, 6),
                  jr.bessel_basis(jnp.asarray(d), 5.0, 6)),
                 (gaussian_basis(torch.tensor(d), 5.0, 7, 1.5),
                  jr.gaussian_basis(jnp.asarray(d), 5.0, 7, 1.5))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13,
                                   atol=1e-13)
