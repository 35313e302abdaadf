"""A minimal-basis RHF engine for the DFT driver, in float64 torch.

Counterpart of ``pdb2reaction_tpu/workflows/minidft.py``: closed-shell
restricted Hartree-Fock over s-type STO-3G Gaussians (H and He), with the
textbook closed-form integrals (Szabo & Ostlund, App. A):

- overlap      S = (pi/p)^{3/2} K_AB
- kinetic      T = mu (3 - 2 mu |AB|^2) S
- nuclear      V = -(2 pi / p) K_AB Z F0(p |P-C|^2)
- ERI (ab|cd)  = 2 pi^{5/2} / (pq sqrt(p+q)) K_AB K_CD F0(rho |P-Q|^2)

with p = a+b, mu = ab/p, K_AB = exp(-mu |AB|^2), P the Gaussian product
centre, rho = pq/(p+q) and F0 the zeroth Boys function from ``erf``. The
integrals are formed over all primitive pairs at once and the SCF runs
on an explicit ``device`` (the card by default, as every entry point of
the port). It serves ``run_dft(engine="mini")`` on hosts without PySCF:
a real SCF with Mulliken and Löwdin populations through the same driver
code the PySCF engine takes (H2, HeH+, H3+ ...).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..constants import ANG2BOHR

# STO-3G s-shell exponents (zeta-scaled) and contraction coefficients
_STO3G: Dict[int, List] = {
    1: ([3.42525091, 0.62391373, 0.16885540],
        [0.15432897, 0.53532814, 0.44463454]),
    2: ([6.36242139, 1.15892300, 0.31364979],
        [0.15432897, 0.53532814, 0.44463454]),
}


def _boys0(t: torch.Tensor) -> torch.Tensor:
    """F0(t) = 1/2 sqrt(pi/t) erf(sqrt(t)), 1 at t -> 0."""
    big = t > 1e-12
    ts = torch.where(big, t, torch.ones_like(t))
    val = 0.5 * torch.sqrt(torch.pi / ts) * torch.erf(torch.sqrt(ts))
    return torch.where(big, val, torch.ones_like(t))


def _basis(numbers, dev):
    """Exponents [n, 3] and normalised contraction coefficients [n, 3],
    one contracted s function per atom."""
    exps, coefs = [], []
    for z in numbers:
        z = int(z)
        if z not in _STO3G:
            raise ValueError(
                f"mini-rhf engine supports s-block STO-3G elements "
                f"{sorted(_STO3G)} only (got Z={z}); use a PySCF-equipped "
                f"host for general systems")
        exps.append(_STO3G[z][0])
        coefs.append(_STO3G[z][1])
    a = torch.tensor(exps, dtype=torch.float64, device=dev)
    c = torch.tensor(coefs, dtype=torch.float64, device=dev) \
        * (2.0 * a / torch.pi) ** 0.75
    p = a[:, :, None] + a[:, None, :]
    norm = torch.einsum("ni,nij,nj->n", c, (torch.pi / p) ** 1.5, c)
    return a, c / torch.sqrt(norm)[:, None]


def _pairs(a, c, R):
    """Primitive-pair quantities over basis pairs (i, j) and primitives
    (u, v): p [n, n, 3, 3], mu, |AB|^2 [n, n, 1, 1], c_iu c_jv K and the
    product centres P [n, n, 3, 3, xyz]."""
    ai = a[:, None, :, None]
    aj = a[None, :, None, :]
    p = ai + aj
    mu = ai * aj / p
    ab2 = ((R[:, None] - R[None, :]) ** 2).sum(-1)[:, :, None, None]
    K = torch.exp(-mu * ab2)
    cc = c[:, None, :, None] * c[None, :, None, :]
    P = (ai[..., None] * R[:, None, None, None, :]
         + aj[..., None] * R[None, :, None, None, :]) / p[..., None]
    return p, mu, ab2, cc * K, P


def _integrals(numbers, R, dev):
    """S, T, V [n, n] and the ERI tensor [n, n, n, n] (chemists' order)."""
    a, c = _basis(numbers, dev)
    p, mu, ab2, cK, P = _pairs(a, c, R)
    s_prim = (torch.pi / p) ** 1.5 * cK
    S = s_prim.sum((-2, -1))
    T = (mu * (3.0 - 2.0 * mu * ab2) * s_prim).sum((-2, -1))
    Z = torch.as_tensor(np.asarray(numbers, dtype=np.float64), device=dev)
    pc2 = ((P[..., None, :] - R) ** 2).sum(-1)           # [n, n, 3, 3, C]
    V = -((2.0 * torch.pi / p)[..., None] * cK[..., None] * Z
          * _boys0(p[..., None] * pc2)).sum((-3, -2, -1))
    n = len(numbers)
    p2, cK2, P2 = p.reshape(n, n, 9), cK.reshape(n, n, 9), \
        P.reshape(n, n, 9, 3)
    pp = p2[:, :, None, None, :, None]
    qq = p2[None, None, :, :, None, :]
    pq2 = ((P2[:, :, None, None, :, None, :]
            - P2[None, None, :, :, None, :, :]) ** 2).sum(-1)
    rho = pp * qq / (pp + qq)
    eri = (cK2[:, :, None, None, :, None] * cK2[None, None, :, :, None, :]
           * 2.0 * torch.pi ** 2.5 / (pp * qq * torch.sqrt(pp + qq))
           * _boys0(rho * pq2)).sum((-2, -1))
    return S, T, V, eri


def rhf(numbers, coords_ang, *, charge=0, max_cycle=100, conv_tol=1e-9,
        device="cuda"):
    """Restricted Hartree-Fock / STO-3G (s-block) on ``device``: e_tot
    (Hartree), converged, per-atom Mulliken and Löwdin charges, the MO
    energies and the basis size."""
    numbers = np.asarray(numbers, dtype=int)
    nelec = int(numbers.sum()) - int(charge)
    if nelec <= 0 or nelec % 2 != 0:
        raise ValueError(
            f"mini-rhf is closed-shell RHF: need an even positive "
            f"electron count (got {nelec})")
    nocc = nelec // 2
    dev = torch.device(device)
    R = torch.as_tensor(np.asarray(coords_ang, dtype=np.float64) * ANG2BOHR,
                        device=dev)
    S, T, V, eri = _integrals(numbers, R, dev)
    hcore = T + V
    Zf = torch.as_tensor(numbers.astype(np.float64), device=dev)
    dist = torch.cdist(R, R)
    iu = torch.tril_indices(len(numbers), len(numbers), -1, device=dev)
    e_nuc = float((Zf[iu[0]] * Zf[iu[1]] / dist[iu[0], iu[1]]).sum())

    sval, svec = torch.linalg.eigh(S)
    X = svec @ torch.diag(sval ** -0.5) @ svec.T

    def density(F):
        eps, cv = torch.linalg.eigh(X.T @ F @ X)
        C = X @ cv
        return eps, 2.0 * C[:, :nocc] @ C[:, :nocc].T

    _, P = density(hcore)
    e_old, e_tot, converged = 0.0, 0.0, False
    for _ in range(max_cycle):
        F = hcore + torch.einsum("pqrs,rs->pq", eri, P) \
            - 0.5 * torch.einsum("prqs,rs->pq", eri, P)
        e_tot = 0.5 * float((P * (hcore + F)).sum()) + e_nuc
        eps, P_new = density(F)
        dP = float((P_new - P).abs().max())
        P = P_new
        if abs(e_tot - e_old) < conv_tol and dP < np.sqrt(conv_tol):
            converged = True
            break
        e_old = e_tot

    # one s function per atom: the basis index is the atom index
    mull = (Zf - torch.diagonal(P @ S)).tolist()
    Sh = svec @ torch.diag(torch.sqrt(sval)) @ svec.T
    low = (Zf - torch.diagonal(Sh @ P @ Sh)).tolist()
    return {"e_tot": float(e_tot), "converged": bool(converged),
            "mulliken": mull, "lowdin": low,
            "mo_energies": eps.tolist(), "n_basis": len(numbers)}


class MiniRhfBackend:
    """The SCF backend seam of ``run_dft`` (as ``PyscfBackend``) over the
    RHF above, on ``device``."""

    def __init__(self, device="cuda"):
        self.device = device

    def kernel(self, struct, *, charge, spin_mult, func, basis,
               density_fit, max_cycle, conv_tol, grid_level, pop):
        from .dft import ScfResult
        if spin_mult != 1:
            raise ValueError(
                "mini-rhf engine is closed-shell (multiplicity 1) only")
        res = rhf(struct.numbers, struct.coords, charge=charge,
                  max_cycle=max_cycle, conv_tol=conv_tol,
                  device=self.device)
        out = ScfResult(e_tot=res["e_tot"], converged=res["converged"],
                        scf_type="RHF", engine_label="mini-rhf(sto-3g)",
                        used_gpu=torch.device(self.device).type == "cuda",
                        density_fit=False)
        if pop:
            out.mulliken = res["mulliken"]
            out.lowdin = res["lowdin"]
            out.population_error = (
                "iao: unavailable in the minimal-basis mini-rhf engine "
                "(IAO of a minimal basis is the basis itself)")
        return out
