"""Port K6 (radial_contract_rect) plain version against the JAX package's
``radial_contract_rect_reference``, the way the JAX package's own test
reaches K6 on the CPU (tests/test_spatial.py): forward and the VJP (rows,
columns and feats, ``jax.vjp`` against autograd) in f64 to 1e-10, both
``div_d`` values, offsets 0/8/16/32, masked atoms, Pr not a multiple of 8.
Also: rect rows equal the plain K5 rows; the row and column
coordinate-gradient formulas the CUDA kernels use (one S = g_I feats_J^T
product, then the radial-derivative ladder once per pair), written out in
numpy and held against autograd; the CPU wrapper takes the plain version
and launches nothing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.mlip.pallas_ops import radial_contract_rect_reference
from pdb2reaction_tpu_torch.mlip import radial_contract as rcm

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


def _kernel_formula_dxyz(xr, mr, off, xc, mc, feats, g, rc, R, div_d):
    """(dx_rows, dx_cols) as the CUDA kernels form them
    (csrc/radial_contract.cu:rc_rect_bwd_xyz): S = g_I feats_J^T over all
    features, G = sum_r dA_r/dd S_r with the sin/cos ladder by the coupled
    rotation recurrence, then dx_rows[i] = sum_j G (x_i - x_j)/d and
    dx_cols[j] = sum_i G (x_j - x_i)/d."""
    S = np.einsum("irf,jf->rij", g, feats)
    diff = xr[:, None, :] - xc[None, :, :]
    d = np.sqrt(np.maximum((diff ** 2).sum(-1), 1e-12))
    gi = off + np.arange(xr.shape[0])
    gj = np.arange(xc.shape[0])
    within = ((d <= rc) & (gi[:, None] != gj[None, :]) & (mr[:, None] > 0)
              & (mc[None, :] > 0))
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
    w = np.where(within, G, 0.0)[:, :, None] * diff * inv[:, :, None]
    return w.sum(1), -w.sum(0)


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
