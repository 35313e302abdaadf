"""Hessian-seeded dimer TS refinement (the "light" tsopt mode), as host
loops over float64 tensors on the calculator's device.

Counterpart of ``pdb2reaction_tpu/engines/dimer.py`` (``DIMER_KW``,
``HESSIAN_DIMER_KW``):

1. an exact Hessian gives the mass-weighted, TR-projected lowest mode as
   the first dimer orientation;
2. a loose dimer + L-BFGS pass, the orientation refreshed from a fresh
   Hessian, then tight passes under a global cycle budget;
3. the flatten loop: extra imaginary modes are probed with +/-
   displacements (all probes in one batched force call) and the search
   moves downhill along the best one, with an optional Bofill update in
   place of the fresh Hessian and representative-atom separation gating;
4. the final Hessian, its imaginary-mode count and the TS mode.

A dimer pass is one host loop: a cycle is a force call, Fourier
rotations (each one or two more force calls; one host read of the
rotation's stop test each) and an L-BFGS translation through the port's
``engines/lbfgs.py`` two-loop recursion, with the oscillation guard and
the trust update. The JAX package compiles the pass into one device
loop. ``_DimerState`` is the pass's whole carry: with ``restart=`` it is
dumped every ``every`` cycles, and exact Hessians and passes are memoized
in sequence under content keys, so a killed run resumes where it died.

Force calls are counted by the calculator's closures as they happen
(``_DimerState.calls`` carries the JAX package's count of the same
evaluations: one a cycle plus the rotations').
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..runtime.checkpoint import content_key, load_state, save_state
from .lbfgs import _two_loop
from .rfo import _bofill_update
from .thresholds import Thresholds, converged, get_thresholds
from .vib import (count_imaginary, free_block_modes, free_block_wavenumbers,
                  frequencies_and_modes)
from .. import elements
from ..constants import ANG2BOHR

DIMER_KW: Dict[str, Any] = {
    "length": 0.0189,               # Bohr (~0.01 Angstrom)
    "rotation_max_cycles": 15,
    "rotation_method": "fourier",
    "rotation_thresh": 1e-4,
    "rotation_tol": 1.0,            # degrees
    "rotation_disable": False,
    "rotation_disable_pos_curv": True,
    "rotation_remove_trans": True,
    "trans_force_f_perp": True,
}

HESSIAN_DIMER_KW: Dict[str, Any] = {
    "thresh_loose": "gau_loose",
    "thresh": "baker",
    "update_interval_hessian": 500,
    "neg_freq_thresh_cm": 5.0,
    "flatten_amp_ang": 0.10,
    "flatten_max_iter": 50,
    "flatten_sep_cutoff": 0.0,
    "flatten_bofill": False,
    "flatten_k": 10,
    "root": 0,
    "max_cycles_total": 10000,
}


class DimerResult(NamedTuple):
    x: torch.Tensor             # [P, 3] Bohr
    e: float
    freqs_cm: np.ndarray
    imag_mode_cart: Optional[np.ndarray]   # [N, 3]
    n_imag: int
    converged: bool
    cycles: int


def lowest_mode_direction(H_au, numbers, coords_bohr, freeze_idx,
                          root: int = 0) -> np.ndarray:
    """Cartesian unit vector [3N] of the root-th lowest TR-projected
    mass-weighted mode; the unprojected free block's when the projection
    leaves no mode (tiny active spaces)."""
    vib = frequencies_and_modes(H_au, numbers, coords_bohr,
                                freeze_idx=freeze_idx)
    if len(vib.freqs_cm) == 0:
        sqm = np.sqrt(np.repeat(elements.masses_of(np.asarray(numbers,
                                                              int)), 3))
        _, modes = free_block_modes(H_au, numbers, freeze_idx)
        mode = modes[min(root, modes.shape[0] - 1)] / sqm
        return mode / max(np.linalg.norm(mode), 1e-30)
    order = np.argsort(vib.freqs_cm)
    mode = vib.modes_cart[order[min(root, len(order) - 1)]].reshape(-1)
    return mode / max(np.linalg.norm(mode), 1e-30)


class _DimerState(NamedTuple):
    x: torch.Tensor          # [3P]
    N: torch.Tensor          # [3P] dimer orientation
    e: float
    s_hist: torch.Tensor     # [keep_last, 3P]
    y_hist: torch.Tensor
    rho: torch.Tensor        # [keep_last]
    n_hist: int
    gamma: float
    trust: float
    prev_step: torch.Tensor
    x_prev: torch.Tensor
    g_prev: torch.Tensor
    have_prev: bool
    cycle: int
    done: bool
    calls: int


def init_dimer_state(x0, N0, keep_last: int = 7,
                     max_step: float = 0.3) -> _DimerState:
    """A fresh dimer-pass carry."""
    z = torch.zeros_like(x0)
    return _DimerState(
        x=x0, N=N0, e=0.0,
        s_hist=torch.zeros(keep_last, x0.numel(), dtype=x0.dtype,
                           device=x0.device),
        y_hist=torch.zeros(keep_last, x0.numel(), dtype=x0.dtype,
                           device=x0.device),
        rho=torch.zeros(keep_last, dtype=x0.dtype, device=x0.device),
        n_hist=0, gamma=1.0, trust=min(0.1, max_step), prev_step=z,
        x_prev=x0, g_prev=z, have_prev=False, cycle=0, done=False, calls=0)


def _state_on(st: _DimerState, device) -> _DimerState:
    """A carry read back by ``load_state`` (CPU tensors throughout) with
    its vectors on ``device`` and its scalars as Python values."""
    kinds = {"e": float, "n_hist": int, "gamma": float, "trust": float,
             "have_prev": bool, "cycle": int, "done": bool, "calls": int}
    return _DimerState(**{
        k: (kinds[k](v) if k in kinds
            else v.to(device=device, dtype=torch.float64))
        for k, v in st._asdict().items()})


def make_dimer_pass(eforce: Callable, th: Thresholds, kw: Dict[str, Any],
                    all_free: bool, max_step: float, fm_flat: torch.Tensor,
                    keep_last: int = 7):
    """``resume(st, budget) -> _DimerState``: dimer cycles from the carry
    ``st`` until converged or ``st.cycle`` reaches ``budget`` (an absolute
    cycle cap, so a chunked caller can dump the carry between calls).
    ``eforce``: flat [3P] Bohr -> (E Hartree float, F [P, 3] Hartree/Bohr,
    frozen rows zero); ``fm_flat`` [3P] is the free mask."""
    L = float(kw["length"])
    rot_max = int(kw["rotation_max_cycles"])
    rot_thresh = float(kw["rotation_thresh"])
    rot_tol = float(np.deg2rad(kw["rotation_tol"]))
    rot_disable = bool(kw["rotation_disable"])
    remove_trans = bool(kw["rotation_remove_trans"]) and all_free
    n_free = float(fm_flat.sum())

    def ef(x):
        e, f = eforce(x.reshape(-1, 3))
        return float(e), f.reshape(-1).to(torch.float64)

    def rotate(x, F0, N):
        """Fourier rotations (Heyden / Kastner): (N, C, force calls)."""
        i, C, calls, stop = 0, 0.0, 0, False
        while not stop and i < rot_max:
            _, F1 = ef(x + L * N)
            dF = F1 - F0
            dFN = torch.dot(dF, N)
            C0 = float(-dFN / L)
            F_rot = (2.0 * dF - 2.0 * dFN * N) * fm_flat
            if remove_trans:
                fr3 = F_rot.reshape(-1, 3)
                F_rot = (fr3 - fr3.mean(dim=0)).reshape(-1) * fm_flat
            frn = float(torch.linalg.norm(F_rot))
            theta_dir = F_rot / max(frn, 1e-30)
            dC = float(-2.0 * torch.dot(dF, theta_dir) / L)
            theta1 = -0.5 * math.atan2(dC, 2.0 * abs(C0) + 1e-30)
            stop = frn < rot_thresh or abs(theta1) < rot_tol
            if not stop:
                N_trial = N * math.cos(theta1) + theta_dir * math.sin(theta1)
                N_trial = N_trial / torch.linalg.norm(N_trial)
                _, F1t = ef(x + L * N_trial)
                C1 = float(-torch.dot(F1t - F0, N_trial) / L)
                b1 = 0.5 * dC
                denom = 1.0 - math.cos(2.0 * theta1)
                a1 = (C0 - C1 + b1 * math.sin(2.0 * theta1)) \
                    / max(denom, 1e-12)
                theta_min = 0.5 * math.atan2(b1, a1)
                c_min = a1 * math.cos(2 * theta_min) \
                    + b1 * math.sin(2 * theta_min)
                if c_min > 0:
                    theta_min += 0.5 * math.pi
                N = N * math.cos(theta_min) + theta_dir * math.sin(theta_min)
                N = N / torch.linalg.norm(N)
                calls += 2
            else:
                calls += 1
            i += 1
            C = C0
        return N, C, calls

    def cycle(st: _DimerState) -> _DimerState:
        e, F = ef(st.x)
        F = F * fm_flat
        if rot_disable:
            _, F1 = ef(st.x + L * st.N)
            N, C, rc = st.N, float(-torch.dot(F1 - F, st.N) / L), 1
        else:
            N, C, rc = rotate(st.x, F, st.N)
        f_par = torch.dot(F, N) * N
        # below the curvature inflection the full force with its parallel
        # part reversed, above it the reversed parallel part alone
        Fp = (F - 2.0 * f_par if C < 0 else -f_par) * fm_flat
        g = -Fp

        # curvature pair from the previous cycle (L-BFGS on the projected
        # force field)
        s_v = st.x - st.x_prev
        y_v = g - st.g_prev
        sy = float(torch.dot(s_v, y_v))
        sh, yh, rh = st.s_hist, st.y_hist, st.rho
        n_hist, gamma = st.n_hist, st.gamma
        if st.have_prev and sy > 1e-12:
            M = keep_last
            if n_hist >= M:
                sh, yh, rh = (torch.roll(t, -1, 0) for t in (sh, yh, rh))
            else:
                sh, yh, rh = sh.clone(), yh.clone(), rh.clone()
            slot = min(n_hist, M - 1)
            sh[slot], yh[slot] = s_v, y_v
            rh[slot] = 1.0 / max(sy, 1e-30)
            n_hist = min(n_hist + 1, M)
            yy = float(torch.dot(y_v, y_v))
            gamma = min(max(sy / max(yy, 1e-30), 1e-2), 10.0)

        step = _two_loop(Fp, sh, yh, rh, n_hist, gamma, 1.0) * fm_flat
        mx = float(step.abs().max())
        step = step * min(1.0, st.trust / max(mx, 1e-30))
        # oscillation guard: a reversal halves the trust, damps the step
        # and resets the curvature history
        osc = st.have_prev and float(torch.dot(step, st.prev_step)) < 0
        if osc:
            step = step * 0.5
            trust = max(st.trust * 0.5, 1e-4)
            n_hist, gamma = 0, 1.0
        elif float(step.abs().max()) >= 0.99 * st.trust:
            trust = min(st.trust * 1.2, max_step)
        else:
            trust = st.trust

        dE = e - st.e if st.have_prev else math.inf
        ok = converged(th, Fp, step, dE, n_free)
        return _DimerState(
            x=st.x + step, N=N, e=e, s_hist=sh, y_hist=yh, rho=rh,
            n_hist=n_hist, gamma=gamma, trust=trust, prev_step=step,
            x_prev=st.x, g_prev=g, have_prev=True, cycle=st.cycle + 1,
            done=ok, calls=st.calls + rc + 1)

    def resume(st: _DimerState, budget: int) -> _DimerState:
        while not st.done and st.cycle < budget:
            st = cycle(st)
        return st

    return resume


def _representative_separation(mode_a, mode_b, coords, k: int) -> float:
    """Least distance between the k most-displaced atoms of two modes."""
    wa = np.linalg.norm(mode_a, axis=1)
    wb = np.linalg.norm(mode_b, axis=1)
    ia = np.argsort(wa)[-k:]
    ib = np.argsort(wb)[-k:]
    d = np.linalg.norm(coords[ia][:, None, :] - coords[ib][None, :, :],
                       axis=-1)
    return float(d.min())


def hessian_dimer(
    calc,                          # Calculator (Hessians and forces)
    x0_bohr_pad,
    *,
    dimer_kw: Optional[Dict[str, Any]] = None,
    thresh_loose: str = "gau_loose",
    thresh: str = "baker",
    update_interval_hessian: int = 500,
    neg_freq_thresh_cm: float = 5.0,
    flatten_amp_ang: float = 0.10,
    flatten_max_iter: int = 50,
    flatten_sep_cutoff: float = 0.0,
    flatten_bofill: bool = False,
    flatten_k: int = 10,
    root: int = 0,
    max_step: float = 0.3,
    max_cycles_total: int = 10000,
    callback: Optional[Callable] = None,
    restart: Optional[Dict[str, Any]] = None,
    **_ignored,
) -> DimerResult:
    """``restart={"store": CheckpointStore, "name": str, "every": int}``
    makes the run restartable mid-loop: exact Hessians and dimer passes
    are memoized in sequence under content keys, and each pass dumps its
    carry every ``every`` cycles; a killed run replays the memoized steps
    and resumes the interrupted pass from its last dump."""
    kw = {**DIMER_KW, **(dimer_kw or {})}
    n, P = calc.n_atoms, calc.n_pad
    dev = calc.device
    free_np = calc.system.free_mask.cpu().numpy() > 0
    fm_np = np.repeat(free_np, 3).astype(float)
    fm_flat = torch.as_tensor(fm_np, device=dev)
    all_free = bool(free_np[:n].all() and n == P)
    eforce = calc.au_energy_force_fn()
    ebatch = calc.au_energy_force_batch_fn()
    numbers = calc.structure.numbers
    freeze = calc.structure.freeze

    def as_dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64).reshape(-1),
                               device=dev)

    def real(xf):
        return xf.reshape(P, 3)[:n]

    x = as_dev(x0_bohr_pad.detach().cpu().numpy()
               if isinstance(x0_bohr_pad, torch.Tensor) else x0_bohr_pad)

    store = restart["store"] if restart else None
    r_every = (int(restart.get("every", 50)) or 50) if restart else 0
    r_base = restart["name"] if restart else ""
    seq = {"h": 0, "p": 0}   # deterministic replay counters

    def orientation(H, xc):
        d = lowest_mode_direction(H, numbers, real(xc), freeze, root)
        out = np.zeros(3 * P)
        out[: 3 * n] = d
        out *= fm_np
        return out / max(np.linalg.norm(out), 1e-30)

    def fresh_mode(x_flat):
        xc = x_flat.cpu().numpy()
        nm = skey = None
        if store is not None:
            nm = f"{r_base}_hess{seq['h']:03d}"
            seq["h"] += 1
            skey = content_key(xc, extra=f"hdimer-h:{root}")
            rec = store.load(nm)
            if rec is not None and rec[0].get("key") == skey:
                return as_dev(rec[1]["N"]), rec[1]["H"]
        H = calc.get_hessian(real(xc).reshape(-1))["hessian"]
        out = orientation(H, xc)
        if store is not None:
            store.save(nm, {"key": skey}, {"N": out, "H": np.asarray(H)})
        return as_dev(out), H

    total = {"cycles": 0, "calls": 0}

    def dimer_pass(x, N, thresh_name, budget):
        resume = make_dimer_pass(eforce, get_thresholds(thresh_name), kw,
                                 all_free, max_step, fm_flat)
        budget = min(budget, max_cycles_total - total["cycles"])
        if budget <= 0:
            return x, N, False
        if store is None:
            st = resume(init_dimer_state(x, N, max_step=max_step), budget)
        else:
            nm = f"{r_base}_pass{seq['p']:03d}"
            seq["p"] += 1
            skey = content_key(x, N,
                               extra=f"hdimer-p:{thresh_name}:{budget}")
            hit = load_state(store, nm, _DimerState, expect_key=skey)
            st = (_state_on(hit[1], dev) if hit is not None
                  else init_dimer_state(x, N, max_step=max_step))
            while not st.done and st.cycle < budget:
                st = resume(st, min(st.cycle + r_every, budget))
                save_state(store, nm, st, {"key": skey, "done": st.done})
        total["cycles"] += st.cycle
        total["calls"] += st.calls
        if callback:
            # g_prev is the negated projected force at the last point
            callback(total["cycles"], st.e, -st.g_prev.cpu().numpy())
        return st.x, st.N, st.done

    # seed mode, loose pass, refresh, tight pass
    N, _ = fresh_mode(x)
    x, N, _ = dimer_pass(x, N, thresh_loose, update_interval_hessian)
    N, _ = fresh_mode(x)
    x, N, converged_ = dimer_pass(x, N, thresh, update_interval_hessian)
    while not converged_ and total["cycles"] < max_cycles_total:
        N, _ = fresh_mode(x)
        x, N, converged_ = dimer_pass(x, N, thresh, update_interval_hessian)

    # flatten loop over extra imaginary modes
    xf = x.cpu().numpy()
    for _ in range(flatten_max_iter or 0):
        H = calc.get_hessian(real(xf).reshape(-1))["hessian"]
        vib = frequencies_and_modes(H, numbers, real(xf), freeze)
        n_imag = count_imaginary(vib.freqs_cm, neg_freq_thresh_cm)
        if n_imag <= 1:
            break
        order = np.argsort(vib.freqs_cm)
        extra = list(order[1:n_imag])
        # only flatten extra modes spatially separated from the TS mode
        if flatten_sep_cutoff and flatten_sep_cutoff > 0:
            ts_mode = vib.modes_cart[order[0]]
            extra = [k for k in extra
                     if _representative_separation(
                         ts_mode, vib.modes_cart[k], real(xf), flatten_k)
                     > flatten_sep_cutoff]
            if not extra:
                break
        # +/- probes along every extra mode in one batched force call
        amp = flatten_amp_ang * ANG2BOHR
        probes = []
        for k in extra:
            mode = np.zeros((P, 3))
            mode[:n] = vib.modes_cart[k]
            probes.append(xf.reshape(P, 3) + amp * mode)
            probes.append(xf.reshape(P, 3) - amp * mode)
        Eb, Fb = ebatch(torch.as_tensor(np.stack(probes), device=dev))
        best = int(torch.argmin(Eb))
        if flatten_bofill:
            # Bofill update from the probe data; the new orientation comes
            # from the updated Hessian instead of a fresh exact one
            s = (probes[best].reshape(-1) - xf)[: 3 * n]
            _, f0 = ebatch(torch.as_tensor(xf.reshape(1, P, 3), device=dev))
            y = (-Fb[best][:n].reshape(-1) + f0[0][:n].reshape(-1))
            H = _bofill_update(torch.as_tensor(H, device=dev), as_dev(s),
                               y.to(torch.float64)).cpu().numpy()
            xf = probes[best].reshape(-1)
            N = as_dev(orientation(H, xf))
        else:
            xf = probes[best].reshape(-1)
            N, _ = fresh_mode(as_dev(xf))
        x, N, converged_ = dimer_pass(as_dev(xf), N, thresh,
                                      update_interval_hessian)
        xf = x.cpu().numpy()

    # final Hessian and the TS mode
    H = calc.get_hessian(real(xf).reshape(-1))["hessian"]
    vib = frequencies_and_modes(H, numbers, real(xf), freeze)
    freqs_fin = vib.freqs_cm
    imode = (vib.modes_cart[int(np.argmin(freqs_fin))]
             if len(freqs_fin) else None)
    if len(freqs_fin) == 0 and freeze:
        # PHVA's in-subspace TR projection can annihilate every mode of a
        # tiny active space: report the unprojected free block instead
        fb, fb_mode = free_block_wavenumbers(H, numbers, freeze)
        if len(fb):
            freqs_fin, imode = fb, fb_mode
    n_imag = count_imaginary(freqs_fin, neg_freq_thresh_cm)
    e_fin = float(calc.get_forces(real(xf).reshape(-1))["energy"])
    return DimerResult(x=as_dev(xf).reshape(P, 3), e=e_fin,
                       freqs_cm=freqs_fin, imag_mode_cart=imode,
                       n_imag=n_imag, converged=converged_,
                       cycles=total["cycles"])
