"""Rational Function Optimization: minimization (RFO) and TS search
(RS-I-RFO) in one engine, as a host loop over float64 tensors.

Counterpart of ``pdb2reaction_tpu/engines/rfo.py`` (``RFO_KW``,
``RSIRFO_KW``): trust-region step control, BFGS or Bofill Hessian
updates, an exact Hessian to start from and to refresh every
``hessian_recalc`` cycles, uphill mode following for TS searches and
the GDIIS endgame for minimizations.

- The work happens in the compact free-DOF space (``DofMap``): the
  Hessian is a [Df, Df] tensor on the device of the coordinates. A cycle
  is an eigendecomposition, the restricted step (the RFO secular
  equation by a fixed 64-step bisection, falling back to a trust-radius
  shift when the RFO step is too long), one force call and a
  quasi-Newton update. The trust update, the rejection and the
  convergence test read a few scalars on the host, once a cycle.
- TS mode is the image-function form: the followed roots' eigenvalues
  and gradient components are sign-flipped and the minimization step
  runs on that image spectrum.
- The JAX package runs the cycles between Hessian refreshes as one
  device loop; this loop refreshes at the same cycles.

Every force evaluation goes through ``energy_force_fn``: the calculator's
closure counts them (the JAX device loop counts none).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .dof import DofMap
from .thresholds import converged, get_thresholds

RFO_KW: Dict[str, Any] = {
    "thresh": "gau",
    "max_cycles": 10000,
    "trust_radius": 0.10,
    "trust_update": True,
    "trust_min": 0.00,
    "trust_max": 0.10,
    "hessian_update": "bfgs",
    "hessian_init": "calc",
    "hessian_recalc": 200,
    "small_eigval_thresh": 1e-8,
    "max_micro_cycles": 50,
    "line_search": True,
    "print_every": 100,
}

_NO_PARAMS = object()

RSIRFO_KW: Dict[str, Any] = {
    **RFO_KW,
    "thresh": "baker",
    "roots": [0],
    "hessian_update": "bofill",
    "hessian_recalc_reset": True,
    "max_micro_cycles": 50,
    "assert_neg_eigval": False,
}

_GDIIS_M = 6      # DIIS history depth


class RfoResult(NamedTuple):
    x: torch.Tensor         # [P, 3] Bohr
    e: float
    f: torch.Tensor         # [P, 3]
    hessian: np.ndarray     # [Df, Df] final quasi-Newton Hessian (au)
    cycles: int
    converged: bool


def _bisect(f, lo, hi, n_iter: int, below):
    """Fixed-step bisection on tensors (no host read): the midpoint m
    replaces ``lo`` where ``below(f(m))``, else ``hi``."""
    a, b = lo, hi
    for _ in range(n_iter):
        m = 0.5 * (a + b)
        go_up = below(f(m))
        a = torch.where(go_up, m, a)
        b = torch.where(go_up, b, m)
    return 0.5 * (a + b)


def _secular_rfo_step(lam, gt, trust, n_iter: int = 64):
    """Restricted RFO step in the eigenbasis (``lam`` eigenvalues, ``gt``
    the gradient there): nu < min(lam) solving
    nu = sum g^2 / (nu - lam) by bisection, s = g / (nu - lam); if |s|
    exceeds ``trust``, the shift mu < min(lam) with |g / (mu - lam)| =
    trust instead, also by bisection."""
    g2 = gt * gt
    lam_min = lam.min()
    gnorm = torch.sqrt(g2.sum())
    # f(nu) = nu - sum g^2/(nu - lam) rises from -inf to +inf below lam_min
    lo = lam_min - gnorm - 1.0
    hi = lam_min - 1e-12
    nu = _bisect(lambda nu: nu - (g2 / (nu - lam)).sum(), lo - 10.0 * gnorm,
                 hi, n_iter, lambda fm: fm < 0)
    s_rfo = gt / (nu - lam)
    s_norm = torch.sqrt((s_rfo * s_rfo).sum())

    # |s(mu)| shrinks as mu -> -inf: far (lo2) short, near (hi2) long
    def step_len(mu):
        s = gt / (mu - lam)
        return torch.sqrt((s * s).sum())

    lo2 = lam_min - gnorm / max(float(trust), 1e-12) - 1.0
    hi2 = lam_min - 1e-10
    mu = _bisect(lambda mu: step_len(mu) - trust, lo2, hi2, n_iter,
                 lambda fm: ~(fm > 0))
    s_tr = gt / (mu - lam)
    return torch.where(s_norm > trust, s_tr, s_rfo)


def _safe(d):
    """Denominator guard: d where |d| > 1e-30, else 1e-30."""
    return torch.where(d.abs() > 1e-30, d, torch.full_like(d, 1e-30))


def _bfgs_update(H, s, y):
    Hs = H @ s
    sy = torch.dot(s, y)
    sHs = torch.dot(s, Hs)
    dH = (torch.outer(y, y) / _safe(sy)
          - torch.outer(Hs, Hs) / _safe(sHs))
    return torch.where(sy > 1e-12, H + dH, H)


def _bofill_update(H, s, y):
    """Bofill: phi SR1 + (1 - phi) PSB."""
    r = y - H @ s                   # residual
    ss = torch.dot(s, s)
    rr = torch.dot(r, r)
    sr = torch.dot(s, r)
    phi = torch.where(ss * rr > 1e-30, (sr * sr) / (ss * rr),
                      torch.zeros_like(ss))
    dH_sr1 = torch.outer(r, r) / _safe(sr)
    dH_psb = ((torch.outer(r, s) + torch.outer(s, r)) / ss.clamp_min(1e-30)
              - sr * torch.outer(s, s) / (ss * ss).clamp_min(1e-30))
    dH = phi * torch.where(sr.abs() > 1e-14, dH_sr1,
                           torch.zeros_like(dH_sr1)) + (1.0 - phi) * dH_psb
    return H + dH


def make_rfo_cycle(ts_roots: Optional[Sequence[int]], hessian_update: str,
                   small_eigval_thresh: float):
    """(cycle, update): ``cycle(H, g, trust) -> (step, predicted dE,
    eigenvalues)`` over compact [Df] tensors, and the Hessian update."""
    roots = tuple(int(r) for r in ts_roots) if ts_roots else ()

    def cycle(H, g, trust):
        lam, V = torch.linalg.eigh(H)
        gt = V.T @ g
        # near-zero modes (TR modes of unfrozen systems) take no step
        tiny = lam.abs() < small_eigval_thresh
        gt = torch.where(tiny, torch.zeros_like(gt), gt)
        lam_eff = torch.where(tiny, torch.ones_like(lam), lam)
        if roots:
            # image function: the followed (lowest) roots flipped; the
            # image-minimization step applies directly, with no un-flip
            flip = torch.zeros_like(tiny)
            flip[list(roots)] = True
            lam_eff = torch.where(flip, -lam_eff, lam_eff)
            gt = torch.where(flip, -gt, gt)
        st = _secular_rfo_step(lam_eff, gt, trust)
        st = torch.where(tiny, torch.zeros_like(st), st)
        step = V @ st
        pred = torch.dot(g, step) + 0.5 * torch.dot(step, H @ step)
        return step, pred, lam

    upd = _bofill_update if hessian_update == "bofill" else _bfgs_update
    return cycle, upd


def _gdiis(hist_x, hist_g, n_hist: int, x_free, step, g, H, trust,
           gdiis_thresh: float, n_span):
    """GDIIS extrapolation over a masked (M+2)^2 system: the coefficients
    c minimizing |sum c_i g_i| with sum c_i = 1, over the stored pairs and
    the RFO step's point. The RFO step stands where the solve fails, a
    |c| passes 10, the extrapolated step is empty or longer than twice
    the trust radius, the RFO step's RMS is at or above ``gdiis_thresh``
    or no pair is stored yet (the JAX package's gates), and where the
    system is singular by construction: more gradients than the
    ``n_span`` directions they can span (the Hessian's modes above
    ``small_eigval_thresh``; an unfrozen molecule's gradients have no
    translation or rotation part). The JAX package gates the last case on
    a non-finite solve, which an LU in floating point does not give: the
    coefficients it returns there are set by rounding and differ between
    LAPACK builds. Decided on the device."""
    M = _GDIIS_M
    dev, dt = g.device, g.dtype
    g_est = g + H @ step
    Xc = torch.cat([hist_x, (x_free + step)[None]], 0)       # [M+1, D]
    Gc = torch.cat([hist_g, g_est[None]], 0)
    valid = torch.cat([torch.arange(M, device=dev) < n_hist,
                       torch.ones(1, dtype=torch.bool, device=dev)])
    Bm = Gc @ Gc.T
    vm = valid[:, None] & valid[None, :]
    vf = valid.to(dt)
    A = torch.zeros(M + 2, M + 2, dtype=dt, device=dev)
    A[: M + 1, : M + 1] = torch.where(vm, Bm, torch.zeros_like(Bm)) \
        + torch.diag(1.0 - vf)
    A[M + 1, : M + 1] = vf
    A[: M + 1, M + 1] = vf
    rhs = torch.zeros(M + 2, dtype=dt, device=dev)
    rhs[M + 1] = 1.0
    sol, info = torch.linalg.solve_ex(A, rhs)
    c = torch.where(valid, sol[: M + 1], torch.zeros_like(vf))
    dstep = c @ Xc - x_free
    nrm = torch.linalg.norm(dstep)
    step_rms = torch.sqrt(torch.mean(step * step))
    ok = ((info == 0) & torch.isfinite(c).all() & (c.abs().max() <= 10.0)
          & (nrm > 0.0) & (nrm <= 2.0 * trust) & (step_rms < gdiis_thresh)
          & (n_hist + 1 <= n_span))
    if n_hist < 1:
        return step
    return torch.where(ok, dstep, step)


def rfo_optimize(
    energy_force_fn: Callable,      # [P,3] Bohr -> (E Ha, F [P,3] au)
    x0_bohr_pad: torch.Tensor,
    free_mask,                      # [P]
    n_atoms: int,
    *,
    hessian0,                       # (3N,3N) or (Df,Df) au
    mode: str = "min",              # "min" | "ts"
    roots: Sequence[int] = (0,),
    thresh: str = "gau",
    max_cycles: int = 10000,
    trust_radius: float = 0.10,
    trust_update: bool = True,
    trust_min: float = 0.0,
    trust_max: float = 0.10,
    hessian_update: str = "bfgs",
    hessian_recalc: Optional[int] = 200,
    hessian_fn: Optional[Callable] = None,   # x_pad -> (3N,3N) au (exact)
    params: Any = _NO_PARAMS,                # packed params for fn(x, p)
    small_eigval_thresh: float = 1e-8,
    max_energy_incr: Optional[float] = None,
    gdiis: bool = True,
    gdiis_thresh: float = 2.5e-3,   # RMS(step) gate
    callback: Optional[Callable] = None,
    print_every: int = 100,
    **_ignored,
) -> RfoResult:
    """Minimize (``mode="min"``) or follow ``roots`` uphill to a saddle
    (``mode="ts"``). ``callback(cycle, e, f_numpy)`` fires after every
    cycle. With ``hessian_fn``, the exact Hessian replaces the updated
    one after every ``hessian_recalc`` cycles."""
    th = get_thresholds(thresh)
    x = x0_bohr_pad.detach().to(torch.float64)
    dev = x.device
    dmap = DofMap(free_mask, n_atoms)
    Df = dmap.n_free

    def to_compact(Hn):
        Hn = np.asarray(Hn, dtype=np.float64)
        if Hn.shape[0] == 3 * n_atoms:
            Hn = dmap.compact_hessian(Hn)
        assert Hn.shape == (Df, Df), (Hn.shape, Df)
        return torch.as_tensor(Hn, device=dev)

    H = to_compact(hessian0)
    is_min = mode == "min"
    cycle_fn, update_fn = make_rfo_cycle(
        tuple(roots) if mode == "ts" else None, hessian_update,
        small_eigval_thresh)
    use_gdiis = bool(gdiis and is_min)

    def eff(xc):
        e, f = (energy_force_fn(xc) if params is _NO_PARAMS
                else energy_force_fn(xc, params))
        return float(e), f.to(torch.float64)

    e, f = eff(x)
    trust = float(trust_radius)
    M = _GDIIS_M
    hist_x = torch.zeros(M, Df, dtype=torch.float64, device=dev)
    hist_g = torch.zeros(M, Df, dtype=torch.float64, device=dev)
    n_hist = 0
    cyc_total, conv = 0, False
    while cyc_total < max_cycles and not conv:
        chunk = max_cycles - cyc_total
        if hessian_fn is not None and hessian_recalc:
            chunk = min(chunk, int(hessian_recalc))
        for _ in range(chunk):
            x_free = dmap.gather(x)
            g = -dmap.gather(f)
            step, pred, lam = cycle_fn(H, g, trust)
            if use_gdiis:
                n_span = (lam.abs() >= small_eigval_thresh).sum()
                step = _gdiis(hist_x, hist_g, n_hist, x_free, step, g, H,
                              trust, gdiis_thresh, n_span)
            x_new = dmap.scatter(x_free + step, x)
            e_new, f_new = eff(x_new)
            dE = e_new - e
            g_new = -dmap.gather(f_new)
            reject = max_energy_incr is not None and dE > max_energy_incr
            slen = float(torch.linalg.norm(step))
            if trust_update:
                pred_f = float(pred)
                ratio = dE / pred_f if abs(pred_f) > 1e-14 else 1.0
                if ratio < 0.25 or (is_min and dE > 1e-12):
                    trust_new = max(trust_min, min(trust, slen) * 0.5)
                elif ratio > 0.75 and slen >= 0.8 * trust:
                    trust_new = min(trust_max, trust * 2.0)
                else:
                    trust_new = trust
                trust_new = max(trust_new, 1e-4)
            else:
                trust_new = trust
            if reject:
                trust_new = max(trust_min, 0.25 * slen)
            is_conv = converged(th, f_new.reshape(-1),
                                (x_new - x).reshape(-1), dE, float(Df))
            if not reject:
                H = update_fn(H, step, g_new - g)
                # DIIS ring: append the accepted geometry and gradient
                if n_hist >= M:
                    hist_x = torch.roll(hist_x, -1, 0)
                    hist_g = torch.roll(hist_g, -1, 0)
                slot = min(n_hist, M - 1)
                hist_x[slot] = dmap.gather(x_new)
                hist_g[slot] = g_new
                n_hist = min(n_hist + 1, M)
                x, e, f = x_new, e_new, f_new
            trust = trust_new
            cyc_total += 1
            conv = bool(is_conv and not reject)
            if callback is not None:
                callback(cyc_total, e, f.cpu().numpy())
            if conv:
                break
        if not conv and hessian_fn is not None and hessian_recalc \
                and cyc_total < max_cycles:
            H = to_compact(hessian_fn(x))
    return RfoResult(x=x, e=e, f=f, hessian=H.cpu().numpy(),
                     cycles=cyc_total, converged=conv)
