"""SO(3) machinery for the eSCN backbone: real spherical harmonics, Wigner
rotation matrices on the real-SH basis and S2 grid transform tables.

Same conventions as ``pdb2reaction_tpu/mlip/so3.py``:

- real spherical harmonics without the Condon-Shortley phase, flat (l, m)
  index ``l*(l+1)+m``;
- rotation matrices by the Ivanic & Ruedenberg (1996, with erratum)
  recursion, written as one fixed bilinear coefficient table per l, so
  each step is one batched matmul and differentiable;
- the edge frame: a proper rotation taking each edge direction to +z;
- S2 grid to/from tables (Gauss-Legendre and midpoint/Driscoll-Healy).

The table builders are numpy (built once, cached); the per-edge Wigner
construction is torch.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def lm_index(l: int, m: int) -> int:  # noqa: E741
    return l * (l + 1) + m


def num_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


# ---------------------------------------------------------------------------
# real spherical harmonics (numpy, for tables and tests)
# ---------------------------------------------------------------------------

def real_sph_harm(lmax: int, xyz: np.ndarray) -> np.ndarray:
    """Real spherical harmonics Y_lm [..., (lmax+1)^2] of unit vectors
    [..., 3]; e.g. Y_{1,-1} = sqrt(3/4pi) y, Y_{1,0} = sqrt(3/4pi) z,
    Y_{1,1} = sqrt(3/4pi) x.

    Associated Legendre functions by the standard upward recurrence in l
    (no Condon-Shortley phase), normalised per (l, m)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ct = np.clip(z, -1.0, 1.0)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    phi = np.arctan2(y, x)
    out = np.zeros(xyz.shape[:-1] + (num_coeffs(lmax),), dtype=np.float64)
    for m in range(lmax + 1):
        # P_m^m = (2m-1)!! sin^m
        pmm = np.full_like(ct, float(np.prod(np.arange(1, 2 * m, 2))))
        pmm = pmm * st ** m
        p_prev, p_cur = None, pmm
        for l in range(m, lmax + 1):  # noqa: E741
            if l == m + 1:
                p_prev, p_cur = p_cur, ct * (2 * m + 1) * p_cur
            elif l > m + 1:
                p_prev, p_cur = p_cur, ((2 * l - 1) * ct * p_cur
                                        - (l + m - 1) * p_prev) / (l - m)
            norm = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                out[..., lm_index(l, 0)] = norm * p_cur
            else:
                s = math.sqrt(2.0) * norm * p_cur
                out[..., lm_index(l, m)] = s * np.cos(m * phi)
                out[..., lm_index(l, -m)] = s * np.sin(m * phi)
    return out


# ---------------------------------------------------------------------------
# Wigner rotation matrices on the real-SH basis (Ivanic-Ruedenberg)
# ---------------------------------------------------------------------------

def _ir_uvw(l: int, m: int, mp: int):  # noqa: E741
    """Scalar coefficients u, v, w of the IR recursion."""
    d = float((l + mp) * (l - mp)) if abs(mp) < l else float(2 * l * (2 * l - 1))
    dm0 = 1.0 if m == 0 else 0.0
    u = np.sqrt((l + m) * (l - m) / d)
    v = 0.5 * np.sqrt((1.0 + dm0) * (l + abs(m) - 1) * (l + abs(m)) / d) \
        * (1.0 - 2.0 * dm0)
    w = -0.5 * np.sqrt((l - abs(m) - 1) * (l - abs(m)) / d) * (1.0 - dm0)
    return u, v, w


def _ir_P(r1, Dprev, i: int, l: int, a: int, b: int):  # noqa: E741
    """Helper P_i(l; a, b): r1 [..., 3, 3] (m in -1..1), Dprev the
    [..., 2l-1, 2l-1] block of D^{l-1}."""
    lm1 = l - 1

    def R(m, mp):
        return r1[..., m + 1, mp + 1]

    def D(a_, b_):
        return Dprev[..., a_ + lm1, b_ + lm1]

    if abs(b) < l:
        return R(i, 0) * D(a, b)
    if b == l:
        return R(i, 1) * D(a, lm1) - R(i, -1) * D(a, -lm1)
    return R(i, 1) * D(a, -lm1) + R(i, -1) * D(a, lm1)


def _ir_next(r1, Dprev, l: int):  # noqa: E741
    """D^l from D^{l-1} and the l=1 block r1 (numpy arrays)."""
    rows = []
    for m in range(-l, l + 1):
        u_, v_, w_ = zip(*[_ir_uvw(l, m, mp) for mp in range(-l, l + 1)])
        cols = []
        for k, mp in enumerate(range(-l, l + 1)):
            term = 0.0
            if u_[k] != 0.0:
                term = term + u_[k] * _ir_P(r1, Dprev, 0, l, m, mp)
            if v_[k] != 0.0:
                if m == 0:
                    V = _ir_P(r1, Dprev, 1, l, 1, mp) \
                        + _ir_P(r1, Dprev, -1, l, -1, mp)
                elif m > 0:
                    d1 = 1.0 if m == 1 else 0.0
                    V = _ir_P(r1, Dprev, 1, l, m - 1, mp) * np.sqrt(1.0 + d1) \
                        - _ir_P(r1, Dprev, -1, l, -m + 1, mp) * (1.0 - d1)
                else:
                    d1 = 1.0 if m == -1 else 0.0
                    V = _ir_P(r1, Dprev, 1, l, m + 1, mp) * (1.0 - d1) \
                        + _ir_P(r1, Dprev, -1, l, -m - 1, mp) * np.sqrt(1.0 + d1)
                term = term + v_[k] * V
            if w_[k] != 0.0:
                if m > 0:
                    W = _ir_P(r1, Dprev, 1, l, m + 1, mp) \
                        + _ir_P(r1, Dprev, -1, l, -m - 1, mp)
                else:
                    W = _ir_P(r1, Dprev, 1, l, m - 1, mp) \
                        - _ir_P(r1, Dprev, -1, l, -m + 1, mp)
                term = term + w_[k] * W
            cols.append(term)
        rows.append(np.stack(cols, axis=-1))
    return np.stack(rows, axis=-2)


@lru_cache(maxsize=None)
def _ir_coeff_table(l: int) -> np.ndarray:  # noqa: E741
    """Bilinear coefficient tensor T [(2l+1)^2, 9, (2l-1)^2] of the step
    l-1 -> l: D^l[o] = sum_{a,c} T[o,a,c] D^1flat[a] D^{l-1}flat[c],
    read off by running the recursion on one-hot inputs."""
    n_prev = (2 * l - 1) ** 2
    r1 = np.broadcast_to(np.eye(9).reshape(9, 1, 3, 3), (9, n_prev, 3, 3))
    Dp = np.broadcast_to(
        np.eye(n_prev).reshape(1, n_prev, 2 * l - 1, 2 * l - 1),
        (9, n_prev, 2 * l - 1, 2 * l - 1))
    out = _ir_next(r1, Dp, l)                   # [9, n_prev, 2l+1, 2l+1]
    return np.ascontiguousarray(
        out.reshape(9, n_prev, (2 * l + 1) ** 2).transpose(2, 0, 1))


_CONST = {}


def _const(key, build, dtype, device):
    """The numpy table ``build()`` as a tensor, built once per (key, dtype,
    device): a copy from host memory inside a force call would wait for
    the device queue."""
    k = (key, dtype, str(device))
    t = _CONST.get(k)
    if t is None:
        t = torch.as_tensor(build(), dtype=dtype, device=device)
        _CONST[k] = t
    return t


def wigner_blocks(rot: torch.Tensor, lmax: int):
    """Per-l rotation blocks [..., 2l+1, 2l+1], l = 0..lmax, with
    Y_l(R x) = D_l(R) Y_l(x), for proper rotations ``rot`` [..., 3, 3]."""
    batch = rot.shape[:-2]
    blocks = [torch.ones(batch + (1, 1), dtype=rot.dtype, device=rot.device)]
    if lmax == 0:
        return blocks
    # l=1 real SH order is (y, z, x): conjugate by that permutation
    perm = _const("perm", lambda: np.eye(3)[[1, 2, 0]], rot.dtype,
                  rot.device)
    D1 = perm @ rot @ perm.T
    blocks.append(D1)
    r9 = D1.reshape(batch + (9,))
    Dprev = r9
    for l in range(2, lmax + 1):  # noqa: E741
        n_prev = (2 * l - 1) ** 2
        n_out = (2 * l + 1) ** 2
        T = _const(("ir", l), lambda: _ir_coeff_table(l), rot.dtype,
                   rot.device).reshape(n_out, 9 * n_prev)
        outer = (r9[..., :, None] * Dprev[..., None, :]).reshape(
            batch + (9 * n_prev,))
        Dl_flat = outer @ T.T
        blocks.append(Dl_flat.reshape(batch + (2 * l + 1, 2 * l + 1)))
        Dprev = Dl_flat
    return blocks


def wigner_full(rot: torch.Tensor, lmax: int) -> torch.Tensor:
    """Block-diagonal [..., (lmax+1)^2, (lmax+1)^2] rotation on flat (l,m)."""
    blocks = wigner_blocks(rot, lmax)
    M = num_coeffs(lmax)
    batch = rot.shape[:-2]
    out = rot.new_zeros(batch + (M, M))
    for l, D in enumerate(blocks):  # noqa: E741
        i0 = l * l
        out[..., i0:i0 + 2 * l + 1, i0:i0 + 2 * l + 1] = D
    return out


# ---------------------------------------------------------------------------
# edge-aligned frame
# ---------------------------------------------------------------------------

def edge_rot_mat(vec: torch.Tensor) -> torch.Tensor:
    """Proper rotation R with R @ d_hat = +z for each edge vector [..., 3].

    Rows are (a, d_hat x a, d_hat) with a = normalize(d_hat x helper); the
    helper axis is the coordinate axis least aligned with the edge. Its
    choice is piecewise constant and carries no gradient: the energy does
    not depend on the frame."""
    d = vec / vec.norm(dim=-1, keepdim=True)
    helper_idx = torch.argmin(d.abs().detach(), dim=-1)
    # one-hot by comparison (F.one_hot checks its input on the host)
    helper = (helper_idx[..., None]
              == torch.arange(3, device=d.device)).to(d.dtype)
    a = torch.linalg.cross(d, helper, dim=-1)
    a = a / a.norm(dim=-1, keepdim=True)
    return torch.stack([a, torch.linalg.cross(d, a, dim=-1), d], dim=-2)


# ---------------------------------------------------------------------------
# S2 grid transform tables (numpy)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def s2_grid_tables(lmax: int, n_theta: int = 0, n_phi: int = 0):
    """(to_grid [G, M], from_grid [M, G]) float64 tables on Gauss-Legendre
    cos(theta) x uniform phi nodes; from_grid @ to_grid is the identity on
    band-limited (<= lmax) signals."""
    if n_theta <= 0:
        n_theta = 2 * (lmax + 1)
    if n_phi <= 0:
        n_phi = 2 * lmax + 3
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    theta = np.arccos(ct)
    phi = np.arange(n_phi) * (2.0 * np.pi / n_phi)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp),
                    np.sin(tt) * np.sin(pp),
                    np.cos(tt)], axis=-1).reshape(-1, 3)
    Y = real_sph_harm(lmax, xyz)                      # [G, M]
    w = np.repeat(wt, n_phi) * (2.0 * np.pi / n_phi)  # [G]
    return Y, (Y * w[:, None]).T


@lru_cache(maxsize=None)
def s2_grid_tables_midpoint(lmax: int, n_theta: int, n_phi: int):
    """(to_grid [G, M], from_grid [M, G]) on the midpoint theta grid with
    Driscoll-Healy weights (theta_j = pi(2j+1)/(2 n_theta), uniform phi),
    the grid of the per-edge S2 activation."""
    j = np.arange(n_theta)
    theta = np.pi * (2 * j + 1) / (2.0 * n_theta)
    b = n_theta // 2
    k = np.arange(b)
    w = np.array([(2.0 / b) * np.sin(t)
                  * np.sum(np.sin((2 * k + 1) * t) / (2 * k + 1))
                  for t in theta])
    phi = np.arange(n_phi) * (2.0 * np.pi / n_phi)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp),
                    np.sin(tt) * np.sin(pp),
                    np.cos(tt)], axis=-1).reshape(-1, 3)
    Y = real_sph_harm(lmax, xyz)                      # [G, M]
    wq = np.repeat(w, n_phi) * (2.0 * np.pi / n_phi)  # [G]
    return Y, (Y * wq[:, None]).T
