"""Delocalized internal coordinates (DLC): L-BFGS and RFO / RS-I-RFO
stepping in internals, as host loops over float64 tensors.

Counterpart of ``pdb2reaction_tpu/engines/dlc.py``:

- primitives from covalent-radius connectivity (fragments joined through
  their closest contacts): bonds, angles of bonded triples that are not
  near-linear, proper dihedrals of bonded quadruples (``build_primitives``,
  numpy, once a run);
- the Wilson B matrix as the autodiff jacobian of the primitive map
  (``torch.func.jacrev``, as the JAX package's ``jax.jacrev``);
- delocalization: the eigenvectors of G = B Bᵀ at the start geometry with
  eigenvalue > 1e-6 form U. B, G and the eigendecomposition at the start
  run in float64 on the host's CPU whatever the device, so a card run and
  a CPU run pick the same U (the L-BFGS step cap is a max-abs cap in DLC
  space, so the path depends on U inside degenerate eigenspaces, not only
  on its span);
- the iterative back-transformation of a DLC step to Cartesians
  (``back_iters`` steps, dihedral differences wrapped to [-pi, pi]);
- frozen atoms run constrained delocalization: B keeps only the free
  Cartesian columns, so U spans only free-atom motion and a frozen
  coordinate never moves.

The JAX package runs each loop as one device ``while_loop``; here each
cycle is a host step around one force call on the calculator's device,
with the jacobians, solves and transforms on that device too. Every force
evaluation goes through ``energy_force_fn``, whose closure counts it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import elements
from ..constants import BOHR2ANG
from .lbfgs import _two_loop
from .thresholds import converged, get_thresholds

_NO_PARAMS = object()


# ---------------------------------------------------------------------------
# primitive construction (host, once a run)
# ---------------------------------------------------------------------------

def build_primitives(numbers: np.ndarray, coords_ang: np.ndarray,
                     bond_factor: float = 1.3):
    """(bonds [nb,2], angles [na,3], dihedrals [nd,4]) index arrays."""
    n = len(numbers)
    radii = elements.covalent_radii_of(np.asarray(numbers, int))
    d = np.linalg.norm(coords_ang[:, None] - coords_ang[None, :], axis=-1)
    cut = bond_factor * (radii[:, None] + radii[None, :])
    bonded = (d < cut) & ~np.eye(n, dtype=bool)

    # join disconnected fragments through their closest contacts
    comp = np.arange(n)
    for _ in range(n):
        changed = False
        for i in range(n):
            nbrs = np.nonzero(bonded[i])[0]
            if nbrs.size and comp[nbrs].min() < comp[i]:
                comp[i] = comp[nbrs].min()
                changed = True
        if not changed:
            break
    while len(set(comp)) > 1:
        labels = sorted(set(comp))
        a_set = np.nonzero(comp == labels[0])[0]
        b_set = np.nonzero(comp != labels[0])[0]
        sub = d[np.ix_(a_set, b_set)]
        i, j = np.unravel_index(np.argmin(sub), sub.shape)
        ai, bj = a_set[i], b_set[j]
        bonded[ai, bj] = bonded[bj, ai] = True
        comp[comp == comp[bj]] = comp[ai]

    bonds = [(i, j) for i in range(n) for j in range(i + 1, n)
             if bonded[i, j]]
    nbrs = [np.nonzero(bonded[i])[0] for i in range(n)]

    def cos_at(a, b, c):
        v1 = coords_ang[a] - coords_ang[b]
        v2 = coords_ang[c] - coords_ang[b]
        return np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))

    angles = []
    for j in range(n):
        for a in range(len(nbrs[j])):
            for b in range(a + 1, len(nbrs[j])):
                i, k = nbrs[j][a], nbrs[j][b]
                # skip near-linear angles (ill-conditioned B rows)
                if cos_at(i, j, k) > -0.995:
                    angles.append((int(i), int(j), int(k)))
    dihedrals = []
    for (j, k) in bonds:
        for i in nbrs[j]:
            if i == k:
                continue
            for l in nbrs[k]:  # noqa: E741
                if l == j or l == i:
                    continue
                # skip if either inner angle is near-linear
                if not any(abs(cos_at(a, b, c)) > 0.99
                           for (a, b, c) in ((i, j, k), (j, k, l))):
                    dihedrals.append((int(i), int(j), int(k), int(l)))
    return (np.asarray(bonds, int).reshape(-1, 2),
            np.asarray(angles, int).reshape(-1, 3),
            np.asarray(dihedrals, int).reshape(-1, 4))


def make_prim_fn(bonds, angles, dihedrals, n_atoms: int):
    """Pure function coords_flat [3N] -> primitive values [n_prims]: bond
    lengths, then angles, then dihedrals signed in (-pi, pi]. The angle
    cosine is clipped as ``jnp.clip`` is (a maximum, then a minimum: the
    gradient is halved at an exact tie with a bound and zero beyond it)."""
    nb, na, nd = len(bonds), len(angles), len(dihedrals)
    host = [np.asarray(a, np.int64) for a in (bonds, angles, dihedrals)]
    per_dev = {}

    def idx(device):
        key = str(device)
        if key not in per_dev:
            per_dev[key] = [torch.as_tensor(a, device=device) for a in host]
        return per_dev[key]

    def prims(x_flat):
        x = x_flat.reshape(n_atoms, 3)
        b, a, dh = idx(x.device)
        out = []
        if nb:
            v = x[b[:, 1]] - x[b[:, 0]]
            out.append(torch.sqrt((v * v).sum(-1) + 1e-30))
        if na:
            v1 = x[a[:, 0]] - x[a[:, 1]]
            v2 = x[a[:, 2]] - x[a[:, 1]]
            n1 = torch.linalg.norm(v1, dim=-1)
            n2 = torch.linalg.norm(v2, dim=-1)
            c = (v1 * v2).sum(-1) / torch.clamp(n1 * n2, min=1e-30)
            lo = torch.full_like(c, -1 + 1e-10)
            hi = torch.full_like(c, 1 - 1e-10)
            out.append(torch.arccos(torch.minimum(torch.maximum(c, lo), hi)))
        if nd:
            b0 = x[dh[:, 0]] - x[dh[:, 1]]
            b1 = x[dh[:, 2]] - x[dh[:, 1]]
            b2 = x[dh[:, 3]] - x[dh[:, 2]]
            n1 = torch.linalg.cross(b0, b1, dim=-1)
            n2 = torch.linalg.cross(b2, b1, dim=-1)
            m1 = torch.linalg.cross(
                n1, b1 / torch.linalg.norm(b1, dim=-1, keepdim=True), dim=-1)
            out.append(torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1)))
        return torch.cat(out)

    return prims, (nb, na, nd)


def wrap_dq(dq, nb: int, na: int):
    """Wrap dihedral differences to (-pi, pi] (floor modulo, as
    ``jnp.remainder``)."""
    di = torch.remainder(dq[nb + na:] + torch.pi, 2.0 * torch.pi) - torch.pi
    return torch.cat([dq[: nb + na], di])


# ---------------------------------------------------------------------------
# the delocalized space of one run
# ---------------------------------------------------------------------------

class DlcSpace:
    """Primitives, free columns and U of one run, from the start geometry
    ``x0_flat`` [3N] Bohr (on the device the run uses). ``U`` may be
    replaced before use (the tests hold the step functions to the JAX
    package's on its own U)."""

    def __init__(self, numbers, x0_flat: torch.Tensor, n_atoms: int,
                 freeze: Optional[Sequence[int]] = None,
                 back_iters: int = 10):
        x0 = x0_flat.detach().to(torch.float64)
        self.device = x0.device
        self.n_atoms = n_atoms
        self.back_iters = int(back_iters)
        if isinstance(numbers, torch.Tensor):
            numbers = numbers.cpu().numpy()
        bonds, angles, dihedrals = build_primitives(
            np.asarray(numbers, int)[:n_atoms],
            x0.reshape(n_atoms, 3).cpu().numpy() * BOHR2ANG)
        self.prims = (bonds, angles, dihedrals)
        self.prim_fn, (self.nb, self.na, self.nd) = make_prim_fn(
            bonds, angles, dihedrals, n_atoms)
        free_dof = np.ones(3 * n_atoms, bool)
        fz = sorted(set(int(i) for i in (freeze or ())))
        if fz:
            assert fz[-1] < n_atoms, (fz, n_atoms)
            free_dof[np.repeat(fz, 3) * 3 + np.tile([0, 1, 2], len(fz))] = \
                False
        self.free_np = np.nonzero(free_dof)[0]
        self.free_idx = torch.as_tensor(self.free_np, device=self.device)
        self.n_free = int(self.free_np.size)
        # B0, G0 and the eigendecomposition in float64 on the host's CPU,
        # whatever the device: a card run and a CPU run start from the
        # same bits and pick the same U
        B0 = torch.func.jacrev(self.prim_fn)(x0.cpu())[
            :, torch.as_tensor(self.free_np)]
        w, V = torch.linalg.eigh(B0 @ B0.T)
        keep = torch.nonzero(w > 1e-6).reshape(-1)
        self.U = V[:, keep].to(self.device)            # [n_prims, n_dlc]

    @property
    def n_dlc(self) -> int:
        return int(self.U.shape[1])

    def jacobian(self, x_flat):
        """B [n_prims, n_free]: the primitives' jacobian, free columns."""
        return torch.func.jacrev(self.prim_fn)(x_flat)[:, self.free_idx]

    def bs(self, x_flat):
        """(B_s = Uᵀ B [n_dlc, n_free], G_s = B_s B_sᵀ)."""
        Bs = self.U.T @ self.jacobian(x_flat)
        return Bs, Bs @ Bs.T

    def grad_q(self, x_flat, f_flat):
        """g_q = G_s⁻¹ B_s g_x from the Cartesian forces [3N]."""
        Bs, Gs = self.bs(x_flat)
        return torch.linalg.solve(Gs, Bs @ (-f_flat[self.free_idx]))

    def dq(self, x_new, x_old):
        """Uᵀ wrap(q(x_new) - q(x_old)): the internal displacement."""
        return self.U.T @ wrap_dq(self.prim_fn(x_new) - self.prim_fn(x_old),
                                  self.nb, self.na)

    def backtransform(self, x_flat, ds):
        """x after the DLC step ``ds``: ``back_iters`` Newton steps
        dx = B_sᵀ G_s⁻¹ r on the remaining internal displacement r."""
        x, remaining = x_flat, ds
        for _ in range(self.back_iters):
            Bs, Gs = self.bs(x)
            dx = Bs.T @ torch.linalg.solve(Gs, remaining)
            x_new = x.index_add(0, self.free_idx, dx)
            remaining = remaining - self.dq(x_new, x)
            x = x_new
        return x

    def to_q(self, x_flat, H_free):
        """A free-block Cartesian Hessian in DLC space,
        (G_s⁻¹ B_s) H (G_s⁻¹ B_s)ᵀ (the dB/dx force term dropped)."""
        Bs, Gs = self.bs(x_flat)
        Binv_t = torch.linalg.solve(Gs, Bs)
        return Binv_t @ H_free @ Binv_t.T

    def cart_step(self, x_flat, step, max_step_cart: float):
        """(x_new, step): the back-transformed step, rescaled and
        transformed again when its largest Cartesian component passes
        ``max_step_cart`` Bohr (the Cartesian L-BFGS's step control)."""
        x_try = self.backtransform(x_flat, step)
        mxc = float((x_try - x_flat).abs().max())
        scale = min(1.0, max_step_cart / max(mxc, 1e-30))
        if scale < 1.0:
            step = step * scale
            return self.backtransform(x_flat, step), step
        return x_try, step


class DlcResult(NamedTuple):
    x: torch.Tensor          # [P, 3] Bohr
    e: float
    f: torch.Tensor          # [P, 3]
    cycles: int
    converged: bool


def _eforce(energy_force_fn, params, x0_pad, n_atoms):
    """x_flat [3N] -> (E float, F [3N] float64) through the padded
    closure; padding rows zero."""
    P = x0_pad.shape[0]

    def eff(x_flat):
        pad = torch.zeros(P, 3, dtype=x_flat.dtype, device=x_flat.device)
        pad[:n_atoms] = x_flat.reshape(n_atoms, 3)
        e, f = (energy_force_fn(pad) if params is _NO_PARAMS
                else energy_force_fn(pad, params))
        return float(e), f[:n_atoms].reshape(-1).to(torch.float64)
    return eff


def _result(x0_pad, x, e, f, n_atoms, cycles, conv) -> DlcResult:
    x_pad = x0_pad.detach().to(torch.float64).clone()
    x_pad[:n_atoms] = x.reshape(n_atoms, 3)
    f_pad = torch.zeros_like(x_pad)
    f_pad[:n_atoms] = f.reshape(n_atoms, 3)
    return DlcResult(x=x_pad, e=float(e), f=f_pad, cycles=int(cycles),
                     converged=bool(conv))


# ---------------------------------------------------------------------------
# DLC L-BFGS
# ---------------------------------------------------------------------------

def dlc_lbfgs_minimize(
    energy_force_fn: Callable,       # [P,3] Bohr -> (E Ha, F [P,3] au)
    x0_bohr_pad: torch.Tensor,       # [P,3]
    numbers,
    n_atoms: int,
    *,
    params: Any = _NO_PARAMS,        # packed params for fn(coords, p)
    freeze: Optional[Sequence[int]] = None,
    thresh: str = "gau",
    max_cycles: int = 10000,
    keep_last: int = 7,
    max_step_s: float = 0.3,         # step cap in DLC space
    max_step_cart: float = 0.30,     # Bohr cap on the resulting move
    back_iters: int = 10,
    callback: Optional[Callable] = None,
    **_ignored,
) -> DlcResult:
    """Minimize in delocalized internals. Convergence is tested on the
    Cartesian forces and steps with the presets of the Cartesian path.
    ``freeze`` (atom indices) runs constrained delocalization.
    ``callback(cycle, e, f_numpy)`` fires after every cycle."""
    th = get_thresholds(thresh)
    x = x0_bohr_pad.detach().to(torch.float64)[:n_atoms].reshape(-1)
    sp = DlcSpace(numbers, x, n_atoms, freeze, back_iters)
    eff = _eforce(energy_force_fn, params, x0_bohr_pad, n_atoms)
    M, D = keep_last, sp.n_dlc
    s_hist = torch.zeros(M, D, dtype=torch.float64, device=x.device)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros(M, dtype=torch.float64, device=x.device)
    n_hist, gamma, cycle, done = 0, 1.0, 0, False

    e, f = eff(x)
    g_s = sp.grad_q(x, f) if max_cycles > 0 else None
    while not done and cycle < max_cycles:
        step = _two_loop(-g_s, s_hist, y_hist, rho, n_hist, gamma, 1.0)
        mx = float(step.abs().max())
        step = step * min(1.0, max_step_s / max(mx, 1e-30))
        x_new, step = sp.cart_step(x, step, max_step_cart)
        e_new, f_new = eff(x_new)
        g_new = sp.grad_q(x_new, f_new)

        y = g_new - g_s
        sy = float(torch.dot(step, y))
        if sy > 1e-12:
            if n_hist >= M:
                s_hist = torch.roll(s_hist, -1, 0)
                y_hist = torch.roll(y_hist, -1, 0)
                rho = torch.roll(rho, -1, 0)
            slot = min(n_hist, M - 1)
            s_hist[slot], y_hist[slot] = step, y
            rho[slot] = 1.0 / max(sy, 1e-30)
            n_hist = min(n_hist + 1, M)
            gamma = min(max(sy / max(float(torch.dot(y, y)), 1e-30), 1e-2),
                        100.0)

        done = converged(th, f_new, x_new - x, e_new - e, sp.n_free)
        x, e, f, g_s = x_new, e_new, f_new, g_new
        cycle += 1
        if callback is not None:
            callback(cycle, e, f.cpu().numpy())
    return _result(x0_bohr_pad, x, e, f, n_atoms, cycle, done)


# ---------------------------------------------------------------------------
# DLC RFO / RS-I-RFO
# ---------------------------------------------------------------------------

def dlc_rfo_optimize(
    energy_force_fn: Callable,       # [P,3] Bohr -> (E Ha, F [P,3] au)
    x0_bohr_pad: torch.Tensor,       # [P,3]
    numbers,
    n_atoms: int,
    *,
    hessian0,                        # (3N,3N) Cartesian exact Hessian (au)
    mode: str = "ts",                # "min" | "ts"
    roots: Sequence[int] = (0,),
    thresh: str = "baker",
    max_cycles: int = 10000,
    params: Any = _NO_PARAMS,
    freeze: Optional[Sequence[int]] = None,
    trust_radius: float = 0.10,
    trust_update: bool = True,
    trust_min: float = 0.0,
    trust_max: float = 0.10,
    hessian_update: str = "bofill",
    hessian_recalc: Optional[int] = 200,
    hessian_fn: Optional[Callable] = None,  # x_pad [P,3] -> (3N,3N) au
    small_eigval_thresh: float = 1e-8,
    max_step_cart: float = 0.30,     # Bohr cap on the Cartesian move
    back_iters: int = 10,
    **_ignored,
) -> DlcResult:
    """RFO (``mode="min"``) or RS-I-RFO (``mode="ts"``, ``roots``
    followed uphill) in delocalized internals. The cycle (eigensolve and
    restricted step) is the Cartesian engine's ``make_rfo_cycle`` on
    [n_dlc] tensors; g_q = G_s⁻¹ B_s g_x and the Hessian projection
    recompute B every cycle; the Bofill / BFGS update runs on the actual
    internal displacement Uᵀ wrap(dq), not the requested step. With
    ``hessian_fn`` the exact Hessian, projected again, replaces the
    updated one after every ``hessian_recalc`` cycles. Convergence is
    tested on the free Cartesian forces and steps."""
    from .rfo import make_rfo_cycle
    th = get_thresholds(thresh)
    x = x0_bohr_pad.detach().to(torch.float64)[:n_atoms].reshape(-1)
    sp = DlcSpace(numbers, x, n_atoms, freeze, back_iters)
    eff = _eforce(energy_force_fn, params, x0_bohr_pad, n_atoms)
    cycle_fn, update_fn = make_rfo_cycle(
        tuple(roots) if mode == "ts" else None, hessian_update,
        small_eigval_thresh)
    fidx = sp.free_np

    def hq_of(x_flat, H):
        H = np.asarray(H, dtype=np.float64)
        if H.shape[0] == 3 * n_atoms:
            H = H[np.ix_(fidx, fidx)]
        assert H.shape == (sp.n_free, sp.n_free), H.shape
        return sp.to_q(x_flat, torch.as_tensor(H, device=x_flat.device))

    Hq = hq_of(x, hessian0)
    e, f = eff(x)
    g_q = sp.grad_q(x, f)
    trust = float(trust_radius)
    cyc_total, conv = 0, False
    while cyc_total < max_cycles and not conv:
        chunk = max_cycles - cyc_total
        if hessian_fn is not None and hessian_recalc:
            chunk = min(chunk, int(hessian_recalc))
        for _ in range(chunk):
            step_q, pred, _ = cycle_fn(Hq, g_q, trust)
            x_new, step_q = sp.cart_step(x, step_q, max_step_cart)
            e_new, f_new = eff(x_new)
            g_new = sp.grad_q(x_new, f_new)
            Hq = update_fn(Hq, sp.dq(x_new, x), g_new - g_q)
            dE = e_new - e
            if trust_update:
                slen = float(torch.linalg.norm(step_q))
                pred_f = float(pred)
                ratio = dE / pred_f if abs(pred_f) > 1e-14 else 1.0
                if ratio < 0.25 or (mode == "min" and dE > 1e-12):
                    trust = max(trust_min, min(trust, slen) * 0.5)
                elif ratio > 0.75 and slen >= 0.8 * trust:
                    trust = min(trust_max, trust * 2.0)
                trust = max(trust, 1e-4)
            conv = converged(th, f_new[sp.free_idx],
                             (x_new - x)[sp.free_idx], dE, sp.n_free)
            x, e, f, g_q = x_new, e_new, f_new, g_new
            cyc_total += 1
            if conv:
                break
        if not conv and hessian_fn is not None and hessian_recalc \
                and cyc_total < max_cycles:
            x_pad = x0_bohr_pad.detach().to(torch.float64).clone()
            x_pad[:n_atoms] = x.reshape(n_atoms, 3)
            Hq = hq_of(x, hessian_fn(x_pad))
    return _result(x0_bohr_pad, x, e, f, n_atoms, cyc_total, conv)
