"""Direct Max Flux (DMF) variational MEP with FB-ENM-style interpolation,
as host loops over float64 tensors on the calculator's device.

Counterpart of ``pdb2reaction_tpu/engines/dmf.py`` (``DMF_KW``,
``dmf_mep``):

- the path starts from a flat-bottom ENM interpolation: bonded-pair
  distances (either endpoint's bonds, ``bond_scale`` x covalent radii)
  interpolate linearly between the endpoints' values, and the interior
  images relax towards them for ``fbenm_cycles`` gradient steps with a
  weak tether to the straight line (``fbenm_interpolate``);
- the discrete max-flux functional
  J = log(sum_seg 0.5 (e^{b E_i} + e^{b E_{i+1}}) |x_{i+1} - x_i|) / b,
  with max(E) taken as a constant shift (the JAX package's
  ``stop_gradient``), plus the equal-spacing equality constraints
  c_k = |x_{k+1} - x_k| - mean in an augmented Lagrangian
  L = J + lam . c + mu / 2 |c|^2, six outer multiplier updates
  (lam += mu c, mu doubled up to 1e4);
- the inner solve is heavy-ball descent (``solver="device"``; the step
  shrinks as mu grows) or the native C++ L-BFGS-B over the interior
  images (``solver="native"``, ``native.lbfgsb_minimize``).

Each gradient of L is ONE batched force call of all M images (the fixed
endpoints included, as in the JAX package) through the calculator's
``au_energy_force_batch_fn``: dL/dE_i times -F_i, plus the autograd
gradient of the spacing and segment-length terms with E held as data.
The model is differentiated once, by the force call itself, never twice.
Every image evaluated is a force call of the calculator (the JAX package
adds (cycles + 2) x M instead, whatever it evaluated).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from .. import elements
from ..constants import AU2EV
from .gsm import select_hei_index

DMF_KW: Dict[str, Any] = {
    "n_images": 12,              # max_nodes+2 analogue
    "beta_ev": 10.0,             # reference dmf_options["beta"] (1/eV)
    "correlated": True,
    "fbenm_only_endpoints": False,
    "bond_scale": 1.25,          # fbenm_options["bond_scale"]
    "delta_scale": 0.2,
    "k_fix": 100.0,              # eV/Ang^2 endpoint/frozen restraints
    "eps_vel": 0.01,
    "spacing_weight": 10.0,      # equal-spacing penalty weight
    "max_cycles": 300,
    "fbenm_cycles": 100,
    "tol": 1e-4,
}

N_OUTER = 6                      # multiplier updates of the Lagrangian


class DmfResult(NamedTuple):
    images: np.ndarray                  # [M, P, 3] Bohr
    energies: np.ndarray                # [M] Hartree
    hei_idx: int
    converged: bool
    cycles: int
    force_calls: int                    # images evaluated
    constraint_violation: float = 0.0   # max |seglen_k - mean| (Bohr)


def _bond_pairs(numbers, xA, xB, atom_mask, bond_scale):
    """Union of bonded pairs in either endpoint (host, static)."""
    Z = np.asarray(numbers)
    cov = elements.COVALENT_RADII_BOHR[Z]
    thr = bond_scale * (cov[:, None] + cov[None, :])
    m = np.asarray(atom_mask) > 0

    def bonds(x):
        d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
        b = (d <= thr) & m[:, None] & m[None, :]
        np.fill_diagonal(b, False)
        return b

    bb = bonds(np.asarray(xA)) | bonds(np.asarray(xB))
    ii, jj = np.nonzero(np.triu(bb, 1))
    return ii.astype(np.int64), jj.astype(np.int64)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def fbenm_interpolate(x0, x1, n_images, numbers, atom_mask,
                      bond_scale=1.25, cycles=100, lr=0.05):
    """[M, P, 3] images between the endpoints ``x0`` and ``x1`` ([P, 3]
    Bohr tensors): the straight line, then ``cycles`` gradient steps of
    the flat-bottom ENM with the endpoints held."""
    ii, jj = _bond_pairs(_host(numbers), _host(x0), _host(x1),
                         _host(atom_mask), bond_scale)
    w = torch.linspace(0.0, 1.0, n_images, dtype=x0.dtype, device=x0.device)
    lin = (1 - w)[:, None, None] * x0[None] + w[:, None, None] * x1[None]
    if len(ii) == 0:
        return lin
    ii = torch.as_tensor(ii, device=x0.device)
    jj = torch.as_tensor(jj, device=x0.device)
    dA = torch.linalg.norm(x0[ii] - x0[jj], dim=-1)
    dB = torch.linalg.norm(x1[ii] - x1[jj], dim=-1)
    d_t = (1 - w)[:, None] * dA[None] + w[:, None] * dB[None]  # [M, E]

    def loss(imgs):
        vi = imgs[:, ii] - imgs[:, jj]
        d = torch.sqrt((vi * vi).sum(-1) + 1e-12)
        e_enm = (((d - d_t) / (d_t + 0.5)) ** 2).sum()
        return e_enm + 1e-3 * ((imgs - lin) ** 2).sum()

    imgs = lin
    with torch.enable_grad():
        for _ in range(cycles):
            x = imgs.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(x), x)
            g[0] = 0.0
            g[-1] = 0.0
            imgs = imgs - lr * g
    return imgs.detach()


def _seglen(imgs):
    seg = imgs[1:] - imgs[:-1]
    return torch.sqrt((seg * seg).sum(dim=(1, 2)) + 1e-12)


def spacing_c(imgs):
    """Equality constraints c_k = seglen_k - mean(seglen) (the equal-
    spacing set Ipopt handled in the reference)."""
    s = _seglen(imgs)
    return s - s.mean()


def lagrangian_grad(batch_fn, imgs, beta, lam, mu, free):
    """(L, dL/dimgs [M, P, 3] with frozen and padding rows zero, E [M])
    from one batched force call: dL/dE_i (-F_i) plus the spacing and
    segment-length terms' autograd gradient with E held as data."""
    E, F = batch_fn(imgs)
    with torch.enable_grad():
        x = imgs.detach().requires_grad_(True)
        e = E.detach().to(x.dtype).requires_grad_(True)
        es = e - e.max().detach()                       # logsumexp shift
        wflux = 0.5 * (torch.exp(beta * es[1:]) + torch.exp(beta * es[:-1]))
        J = torch.log((wflux * _seglen(x)).sum() + 1e-30) / beta
        c = spacing_c(x)
        L = J + (lam * c).sum() + 0.5 * mu * (c * c).sum()
        gx, ge = torch.autograd.grad(L, (x, e))
    g = (gx - ge[:, None, None] * F.to(gx.dtype)) * free
    return float(L.detach()), g, E


def dmf_mep(
    calc,
    x0_bohr_pad: torch.Tensor,
    x1_bohr_pad: torch.Tensor,
    *,
    n_images: int = 12,
    beta_ev: float = 10.0,
    bond_scale: float = 1.25,
    spacing_weight: float = 10.0,
    max_cycles: int = 300,
    fbenm_cycles: int = 100,
    tol: float = 1e-4,
    lr: float = 0.02,
    solver: str = "device",        # "device" heavy ball | "native" C++
    verbose: bool = False,
    **_ignored,
) -> DmfResult:
    """Solve the discrete max-flux path problem between two padded
    endpoints (Bohr) on ``calc``. ``solver="device"``: ``max_cycles // 6``
    heavy-ball steps per multiplier update (at least one), the step
    ``lr / max(1, mu / mu0)``; ``solver="native"``: at most
    ``max_cycles // 6`` L-BFGS-B iterations per update, the interior
    images the variables. The result's ``force_calls`` counts every image
    evaluated, as ``calc.force_calls`` does."""
    if solver not in ("device", "native"):
        raise ValueError(f"solver must be 'device' or 'native', got "
                         f"{solver!r}")
    sys_ = calc.system
    batch_fn = calc.au_energy_force_batch_fn()
    beta = beta_ev / AU2EV                      # 1/Hartree
    x0 = torch.as_tensor(x0_bohr_pad, dtype=torch.float64,
                         device=calc.device)
    x1 = torch.as_tensor(x1_bohr_pad, dtype=torch.float64,
                         device=calc.device)
    free = sys_.free_mask[:, None].to(torch.float64)
    images = fbenm_interpolate(x0, x1, n_images, sys_.numbers,
                               sys_.atom_mask, bond_scale, fbenm_cycles)
    M = n_images
    mu0 = float(spacing_weight)
    lam = torch.zeros(M - 1, dtype=torch.float64, device=calc.device)
    mu = mu0
    calls0 = calc.force_calls

    if solver == "native":
        from .. import native
        inner_shape = (M - 2,) + tuple(images.shape[1:])
        ends = (images[:1], images[-1:])
        xs = images[1:-1].cpu().numpy().reshape(-1)
        iters_total, conv = 0, False
        for _ in range(N_OUTER):
            def fg(xflat, lam=lam, mu=mu):
                inner = torch.as_tensor(xflat.reshape(inner_shape),
                                        device=calc.device)
                imgs = torch.cat([ends[0], inner, ends[1]], 0)
                val, g, _ = lagrangian_grad(batch_fn, imgs, beta, lam, mu,
                                            free)
                return val, g[1:-1].cpu().numpy().reshape(-1)

            xs, _, iters, conv = native.lbfgsb_minimize(
                fg, xs, max_iter=max_cycles // N_OUTER, gtol=tol)
            iters_total += iters
            images = torch.cat([ends[0], torch.as_tensor(
                xs.reshape(inner_shape), device=calc.device), ends[1]], 0)
            c = spacing_c(images)
            lam = lam + mu * c                  # multiplier update
            mu = min(mu * 2.0, 1e4)
        cycles = iters_total
        gmax = float("nan")
    else:
        inner = max(max_cycles // N_OUTER, 1)
        m = torch.zeros_like(images)
        for _ in range(N_OUTER):
            # the penalty stiffness grows with mu: shrink the step to stay
            # inside the heavy-ball stability region (lr < 2 / curvature)
            lr_eff = lr / max(1.0, mu / mu0)
            for _ in range(inner):
                _, g, _ = lagrangian_grad(batch_fn, images, beta, lam, mu,
                                          free)
                g[0] = 0.0
                g[-1] = 0.0
                m = 0.9 * m + g
                images = images - lr_eff * m
            gmax = float(g.abs().max())
            c = spacing_c(images)
            lam = lam + mu * c
            mu = min(mu * 2.0, 1e4)
        cycles = inner * N_OUTER
        conv = gmax < tol * 10
    cviol = float(c.abs().max())
    E, _ = batch_fn(images)
    E = E.cpu().numpy().astype(float)
    if verbose:
        print(f"[dmf] {solver}: {cycles} cycles, final max|grad| = "
              f"{gmax:.2e}, max|c| = {cviol:.2e} Bohr")
    return DmfResult(images=images.cpu().numpy(), energies=E,
                     hei_idx=select_hei_index(E), converged=bool(conv),
                     cycles=int(cycles),
                     force_calls=calc.force_calls - calls0,
                     constraint_violation=cviol)
