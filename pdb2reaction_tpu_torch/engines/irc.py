"""EulerPC intrinsic reaction coordinate integration, as a host loop over
float64 tensors on the calculator's device.

Counterpart of ``pdb2reaction_tpu/engines/irc.py`` (``IRC_KW``):
mass-weighted predictor-corrector integration from a TS along its
imaginary mode, both branches, Bofill Hessian updates (an optional exact
refresh every ``hessian_recalc`` cycles), the ``displ="energy"`` start
(dE = 1e-3 Hartree on the local quadratic), convergence on the RMS
gradient or on the energy rising past a minimum, and the modified
Bulirsch-Stoer corrector on a distance-weighted interpolation (DWI)
surface between the two most recent real points.

A macro cycle is one force call, the Bofill update, the corrector (one
Bulirsch-Stoer step over the last arc: modified-midpoint passes of 8, 16,
24 and 32 sub-steps, Neville extrapolation in h^2) and the predictor
(``max_pred_steps`` Euler sub-steps of dq/ds = -g/|g| on the DWI
surface). The DWI field is evaluated about 590 times a cycle, so its
gradient is written in closed form (``_dwi_grad``) instead of taken by
autograd: with d_k = q - q_k, a = |d1|^2, b = |d2|^2, w1 = b/(a+b),
w2 = a/(a+b) and T_k the second-order Taylor surface at q_k,

    grad E = 2 (a d2 - b d1) / (a+b)^2 (T1 - T2)
             + w1 (g1 + (h1+h1^T)/2 d1) + w2 (g2 + (h2+h2^T)/2 d2),

the gradient of ``_dwi_energy`` also for a Bofill Hessian that is not
quite symmetric. The JAX package compiles the whole branch into one
device loop and takes the gradient with ``jax.grad``.

``_IrcState`` is the branch's whole carry (trajectory buffers included):
with ``restart=`` it is dumped every ``every`` cycles and a rerun resumes
the interrupted branch from the dump. Force calls: one a cycle, counted
by the calculator's closure, and an exact refresh is metered as 3n force
calls, as the JAX package meters it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..constants import H_EVAA_2_AU
from ..runtime.checkpoint import content_key, load_state, save_state
from .rfo import _bofill_update
from .vib import free_block_modes, frequencies_and_modes

IRC_KW: Dict[str, Any] = {
    "step_length": 0.10,         # sqrt(amu) Bohr
    "max_cycles": 125,
    "downhill": False,
    "forward": True,
    "backward": True,
    "root": 0,
    "hessian_init": "calc",
    "displ": "energy",
    "displ_energy": 1.0e-3,      # Hartree
    "displ_length": 0.10,
    "rms_grad_thresh": 1.0e-3,
    "energy_thresh": 1.0e-6,
    "force_inflection": True,
    "hessian_update": "bofill",
    "hessian_recalc": None,
    "corr_func": "mbs",
    "max_pred_steps": 500,
}

# modified-midpoint sub-step counts: n = 2 is pre-asymptotic on strongly
# curved arcs and spoils the h^2 extrapolation; the evaluations are DWI
# model calls, never force calls
_MBS_SEQ = (8, 16, 24, 32)


class IrcBranch(NamedTuple):
    coords: List[np.ndarray]     # [N, 3] Bohr each (the TS excluded)
    energies: List[float]
    gradients: List[np.ndarray]  # [3N] Hartree/Bohr each
    converged: bool


class IrcResult(NamedTuple):
    ts_coords: np.ndarray
    ts_energy: float
    forward: Optional[IrcBranch]
    backward: Optional[IrcBranch]


def _dwi_energy(q, q1, e1, g1, h1, q2, e2, g2, h2):
    """Distance-weighted interpolation of two second-order Taylor surfaces
    (Hratchian-Schlegel): E(q) = w1 T1(q) + w2 T2(q), w1 = b/(a+b),
    w2 = a/(a+b), a = |q-q1|^2, b = |q-q2|^2."""
    d1, d2 = q - q1, q - q2
    a, b = torch.dot(d1, d1), torch.dot(d2, d2)
    s = (a + b).clamp_min(1e-30)
    t1 = e1 + torch.dot(g1, d1) + 0.5 * torch.dot(d1, h1 @ d1)
    t2 = e2 + torch.dot(g2, d2) + 0.5 * torch.dot(d2, h2 @ d2)
    return b / s * t1 + a / s * t2


def _sym(h):
    return 0.5 * (h + h.T)


def _dwi_grad(q, Q, E, G, HS):
    """Closed-form gradient of ``_dwi_energy`` at q [n3], the two points
    stacked: Q, G [2, n3] (positions, gradients), E [2] (energies), HS
    [2, n3, n3] (the Hessians symmetrised, (h + h^T) / 2)."""
    D = q[None] - Q                                      # [d1, d2]
    HD = torch.bmm(HS, D.unsqueeze(-1)).squeeze(-1)
    ab = (D * D).sum(1)                                  # [a, b]
    T = E + (G * D).sum(1) + 0.5 * (D * HD).sum(1)       # [T1, T2]
    s = ab.sum().clamp_min(1e-30)
    W = ab.flip(0) / s                                   # [w1, w2]
    # dw1/dq = 2 (a d2 - b d1) / s^2 = -dw2/dq
    dw = 2.0 * (ab[0] * D[1] - ab[1] * D[0]) / (s * s)
    return dw * (T[0] - T[1]) + (W[:, None] * (G + HD)).sum(0)


def _unit_descent(grad):
    return -grad / torch.linalg.norm(grad).clamp_min(1e-12)


def dwi_field(Q, E, G, HS, free):
    """dq/ds = -grad E / |grad E| on the DWI surface of the two points
    stacked in Q, E, G, HS (as ``_dwi_grad`` takes them), frozen
    components zero."""
    def field(q):
        return _unit_descent(_dwi_grad(q, Q, E, G, HS) * free)
    return field


def integrate_cycle(field, q_prev, q_cur, step_length, max_pred_steps,
                    free):
    """A macro cycle's integration on ``field``: with ``q_prev`` the
    corrector re-integrates the last arc from it (``_mbs_integrate``),
    else the predictor starts at ``q_cur``; then ``max_pred_steps`` Euler
    sub-steps over ``step_length``."""
    q = q_cur if q_prev is None else _mbs_integrate(field, q_prev,
                                                    step_length, free)
    h_sub = step_length / max_pred_steps
    for _ in range(max_pred_steps):
        q = q + h_sub * field(q)
    return q


def _mbs_integrate(field, q0, arc_length, free):
    """One Bulirsch-Stoer step over the whole arc: modified-midpoint
    passes with n in ``_MBS_SEQ`` sub-steps, Neville extrapolation in
    h^2 -> 0. ``field(q)`` returns dq/ds (normalized and masked)."""
    H = arc_length

    def midpoint(n: int):
        h = H / n
        zm1, zm = q0, q0 + h * field(q0)
        for _ in range(n - 1):
            zm1, zm = zm, zm1 + 2.0 * h * field(zm)
        return 0.5 * (zm + zm1 + h * field(zm))

    tab = [midpoint(n) for n in _MBS_SEQ]
    xs = [(H / n) ** 2 for n in _MBS_SEQ]
    for lvl in range(1, len(tab)):
        for i in range(len(tab) - lvl):
            x_i, x_ip = xs[i], xs[i + lvl]
            tab[i] = tab[i + 1] + (tab[i + 1] - tab[i]) \
                * (x_ip / max(x_i - x_ip, 1e-300))
    # frozen components never move
    return torch.where(free > 0, tab[0], q0)


class _IrcState(NamedTuple):
    q_prev: torch.Tensor     # MW coords of the previous real point
    q_cur: torch.Tensor      # MW coords of the current real point
    e_prev: float
    g_prev: torch.Tensor     # MW gradient at the previous point
    h_prev: torch.Tensor     # MW Hessian at the previous point
    h_cur: torch.Tensor
    have_prev: bool
    path: torch.Tensor       # [max_cycles, 3N] Cartesian Bohr
    path_e: torch.Tensor     # [max_cycles]
    path_g: torch.Tensor     # [max_cycles, 3N] Cartesian gradient
    count: int
    cycle: int
    done: bool
    conv: bool


_SCALARS = {"e_prev": float, "have_prev": bool, "count": int, "cycle": int,
            "done": bool, "conv": bool}


def _state_on(st: _IrcState, device) -> _IrcState:
    """A carry read back by ``load_state`` with its tensors on ``device``
    and its scalars as Python values."""
    return _IrcState(**{
        k: (_SCALARS[k](v) if k in _SCALARS
            else v.to(device=device, dtype=torch.float64))
        for k, v in st._asdict().items()})


def _make_branch_runner(eforce, hvp, n: int, P: int, max_cycles: int,
                        max_pred_steps: int, corr_mbs: bool,
                        hessian_recalc: int, on_refresh: Callable):
    """``resume(st, sqm, free, step_length, rms_grad_thresh,
    energy_thresh, budget)``: macro cycles from the carry ``st`` until
    done or ``st.cycle`` reaches ``budget``."""

    def pad(x):
        out = torch.zeros(P, 3, dtype=x.dtype, device=x.device)
        out[:n] = x.reshape(n, 3)
        return out

    def resume(st, sqm, free, step_length, rms_grad_thresh, energy_thresh,
               budget):
        n3 = 3 * n
        n_free = max(float(free.sum()), 1.0)

        def eforce_mw(q):
            e, f = eforce(pad(q / sqm))
            return float(e), -f[:n].reshape(-1).to(torch.float64)

        def exact_hessian_mw(q):
            """The exact MW Hessian at q from 3n HVPs."""
            x = pad(q / sqm)
            v = torch.zeros_like(x)
            rows = []
            for k in range(n3):
                v.zero_()
                v.view(-1)[k] = 1.0
                rows.append(hvp(x, v)[:n].reshape(-1))
            on_refresh(n3)
            R = torch.stack(rows)
            H_au = 0.5 * (R + R.T) * H_EVAA_2_AU
            return H_au / sqm[:, None] / sqm[None, :]

        while not st.done and st.cycle < budget:
            e, g_cart = eforce_mw(st.q_cur)
            g_mw = (g_cart / sqm) * free
            gf = g_cart * free
            rms_g = float(torch.sqrt((gf * gf).sum() / n_free))
            conv_g = st.cycle > 0 and rms_g < rms_grad_thresh
            # force inflection: the energy rose past a minimum
            conv_e = st.cycle > 1 and e > st.e_prev + energy_thresh

            # Bofill update (mass-weighted) with the new real pair
            s = st.q_cur - st.q_prev
            h_new = st.h_cur
            if st.have_prev and float(torch.linalg.norm(s)) > 1e-12:
                h_new = _bofill_update(st.h_cur, s, g_mw - st.g_prev)
            if hessian_recalc and st.cycle > 0 \
                    and st.cycle % hessian_recalc == 0:
                h_new = exact_hessian_mw(st.q_cur)

            path, path_e, path_g = st.path, st.path_e, st.path_g
            path[st.count] = st.q_cur / sqm
            path_e[st.count] = e
            path_g[st.count] = g_cart

            # the DWI surface between the two most recent real points
            # (the local quadratic until two points exist)
            if st.have_prev:
                fld = dwi_field(torch.stack([st.q_prev, st.q_cur]),
                                torch.tensor([st.e_prev, e],
                                             dtype=torch.float64,
                                             device=free.device),
                                torch.stack([st.g_prev, g_mw]),
                                torch.stack([_sym(st.h_prev), _sym(h_new)]),
                                free)
            else:
                q_cur, h = st.q_cur, h_new

                def fld(q):
                    return _unit_descent((g_mw + h @ (q - q_cur)) * free)
            q_next = integrate_cycle(
                fld, st.q_prev if st.have_prev and corr_mbs else None,
                st.q_cur, step_length, max_pred_steps, free)

            st = _IrcState(
                q_prev=st.q_cur, q_cur=q_next, e_prev=e, g_prev=g_mw,
                h_prev=st.h_cur, h_cur=h_new, have_prev=True, path=path,
                path_e=path_e, path_g=path_g, count=st.count + 1,
                cycle=st.cycle + 1,
                done=conv_g or conv_e or st.count + 1 >= max_cycles,
                conv=conv_g or conv_e)
        return st

    return resume


def eulerpc_irc(
    calc,
    x_ts_bohr_pad,
    *,
    step_length: float = 0.10,
    max_cycles: int = 125,
    root: int = 0,
    displ: str = "energy",
    displ_energy: float = 1.0e-3,
    displ_length: float = 0.10,
    rms_grad_thresh: float = 1.0e-3,
    energy_thresh: float = 1.0e-6,
    forward: bool = True,
    backward: bool = True,
    downhill: bool = False,
    hessian_recalc: Optional[int] = None,
    corr_func: str = "mbs",
    max_pred_steps: int = 500,
    callback: Optional[Callable] = None,
    restart: Optional[Dict[str, Any]] = None,
    **_ignored,
) -> IrcResult:
    """Both branches from the TS ``x_ts_bohr_pad`` ([P, 3] Bohr).
    ``callback(sign, step, energy, rms_gradient)`` fires for every point
    of a branch once the branch ends."""
    n, P = calc.n_atoms, calc.n_pad
    dev = calc.device
    freeze = calc.structure.freeze
    numbers = calc.structure.numbers
    free_np = np.repeat(calc.system.free_mask[:n].cpu().numpy() > 0,
                        3).astype(float)
    sqm_np = np.sqrt(np.repeat(calc.structure.masses, 3))  # [3N] amu^(1/2)
    free = torch.as_tensor(free_np, device=dev)
    sqm = torch.as_tensor(sqm_np, device=dev)

    if isinstance(x_ts_bohr_pad, torch.Tensor):
        x_ts_bohr_pad = x_ts_bohr_pad.detach().cpu().numpy()
    x_ts = np.asarray(x_ts_bohr_pad, dtype=np.float64)[:n].reshape(-1)
    e_ts = float(calc.get_energy(x_ts)["energy"])

    # TS Hessian -> imaginary mode (mass-weighted direction)
    Hfull = calc.get_hessian(x_ts)["hessian"]
    vib = frequencies_and_modes(Hfull, numbers, x_ts.reshape(n, 3), freeze)
    if len(vib.freqs_cm) > 0:
        k = int(np.argsort(vib.freqs_cm)[min(root, len(vib.freqs_cm) - 1)])
        mode_mw = vib.modes_mw[k]
    else:
        # tiny active spaces: the unprojected free block
        _, modes = free_block_modes(Hfull, numbers, freeze)
        mode_mw = modes[min(root, modes.shape[0] - 1)]
    mode_mw = mode_mw / max(np.linalg.norm(mode_mw), 1e-30)

    Hmw = Hfull / sqm_np[:, None] / sqm_np[None, :]
    curv = float(mode_mw @ Hmw @ mode_mw)
    if displ == "energy" and curv < 0:
        dq = np.sqrt(max(2.0 * displ_energy / abs(curv), 1e-12))
    else:
        dq = displ_length

    # TS-side model data for the first DWI pair
    g_ts = -np.asarray(calc.get_forces(x_ts)["forces"])   # ~0 at a TS
    g_ts_mw = (g_ts / sqm_np) * free_np
    q_ts = x_ts * sqm_np

    k_recalc = int(hessian_recalc) if hessian_recalc else 0

    def metered(n3):
        calc.force_calls += n3

    runner = _make_branch_runner(
        calc.au_energy_force_fn(),
        calc.au_hvp_fn() if k_recalc else None, n, P, int(max_cycles),
        int(max_pred_steps), corr_func == "mbs", k_recalc, metered)

    def T(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    def run_branch(sign: float) -> IrcBranch:
        q0 = q_ts + sign * dq * mode_mw
        q0 = np.where(free_np > 0, q0, q_ts)
        n3 = 3 * n
        st = _IrcState(
            q_prev=T(q_ts), q_cur=T(q0), e_prev=e_ts, g_prev=T(g_ts_mw),
            h_prev=T(Hmw), h_cur=T(Hmw), have_prev=False,
            path=T(np.zeros((max_cycles, n3))), path_e=T(np.zeros(max_cycles)),
            path_g=T(np.zeros((max_cycles, n3))), count=0, cycle=0,
            done=False, conv=False)
        args = (sqm, free, float(step_length), float(rms_grad_thresh),
                float(energy_thresh))
        if restart:
            every = int(restart.get("every", 10)) or 10
            bname = f"{restart['name']}_{'fwd' if sign > 0 else 'bwd'}"
            rkey = content_key(x_ts, np.asarray([sign]),
                               extra=f"irc:{step_length}:{max_cycles}:"
                                     f"{rms_grad_thresh}")
            hit = load_state(restart["store"], bname, _IrcState,
                             expect_key=rkey)
            if hit is not None:
                st = _state_on(hit[1], dev)
            # the carry dumped every `every` cycles
            while not st.done:
                st = runner(st, *args, st.cycle + every)
                save_state(restart["store"], bname, st,
                           {"key": rkey, "done": st.done})
        else:
            st = runner(st, *args, np.iinfo(np.int64).max)
        cnt = st.count
        path = st.path[:cnt].cpu().numpy()
        coords = [path[i].reshape(n, 3) for i in range(cnt)]
        energies = [float(v) for v in st.path_e[:cnt].cpu().numpy()]
        grads = list(st.path_g[:cnt].cpu().numpy())
        if callback:
            for i in range(cnt):
                callback(sign, i + 1, energies[i],
                         float(np.sqrt((grads[i] ** 2).mean())))
        return IrcBranch(coords=coords, energies=energies, gradients=grads,
                         converged=st.conv)

    fwd = run_branch(+1.0) if (forward or downhill) else None
    bwd = run_branch(-1.0) if (backward and not downhill) else None
    return IrcResult(ts_coords=x_ts.reshape(n, 3), ts_energy=e_ts,
                     forward=fwd, backward=bwd)
