"""L-BFGS minimizer as a host loop over torch tensors.

Same algorithm as ``pdb2reaction_tpu/engines/lbfgs.py`` (two-loop
recursion, double damping, component-wise step control, one quadratic
line-search retry when the energy rises; ``LBFGS_KW``). The JAX package
runs the whole loop on the device; here each cycle is a host step around
one or two force calls, each of which runs on the calculator's device.

Units: Bohr coordinates, Hartree energies. Every force evaluation passes
through ``energy_force_fn``; the Calculator's closure counts them.

``restart={"store", "name", "every"}`` makes a run restartable, as the
JAX package's ``restart`` contract: the loop's carry (``LBFGSState``) is
dumped through ``runtime/checkpoint.save_state`` every ``every`` cycles
and at the end, keyed by a content hash of x0 and the settings; a rerun
with the same x0 and settings resumes from the last dump, any other run
ignores it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from .thresholds import converged, get_thresholds

LBFGS_KW: Dict[str, Any] = {
    "thresh": "gau",
    "max_cycles": 10000,
    "keep_last": 7,
    "beta": 1.0,
    "max_step": 0.30,
    "control_step": True,
    "double_damp": True,
    "gamma_mult": False,
    "line_search": True,
    "min_step_norm": 1e-8,
    "print_every": 100,
}


class LBFGSState(NamedTuple):
    """The host loop's carry: what a restart dump holds."""
    x: torch.Tensor         # [3P] Bohr
    e: torch.Tensor         # () Hartree
    f: torch.Tensor         # [3P] Hartree/Bohr
    s_hist: torch.Tensor    # [M, 3P]
    y_hist: torch.Tensor    # [M, 3P]
    rho: torch.Tensor       # [M]
    n_hist: torch.Tensor    # () int
    cycle: torch.Tensor     # () int
    done: torch.Tensor      # () bool
    gamma: torch.Tensor     # () float


class OptResult(NamedTuple):
    x: torch.Tensor         # [P, 3] Bohr
    e: float                # Hartree
    f: torch.Tensor         # [P, 3] Hartree/Bohr
    cycles: int
    converged: bool


def _two_loop(f, s_hist, y_hist, rho, n_hist, gamma, beta):
    """Two-loop recursion on forces (= -gradient): returns the step."""
    M = s_hist.shape[0]
    q = f.clone()
    alphas = [0.0] * M
    for i in range(M):
        j = M - 1 - i
        if j < n_hist:
            a = float(rho[j] * torch.dot(s_hist[j], q))
            q = q - a * y_hist[j]
            alphas[j] = a
    r = q * (gamma / beta)
    for j in range(M):
        if j < n_hist:
            b = float(rho[j] * torch.dot(y_hist[j], r))
            r = r + (alphas[j] - b) * s_hist[j]
    return r


def _double_damp(s, y, gamma, mu1: float = 0.2, mu2: float = 1e-3):
    """Damping that keeps the stored curvature positive: Powell-style on y
    with H0 = gamma I, then drop the pair (phi = 0) if still poor."""
    sy = float(torch.dot(s, y))
    Bs = s / max(gamma, 1e-12)
    sBs = float(torch.dot(s, Bs))
    theta = 0.8 * sBs / max(sBs - sy, 1e-12) if sy < mu1 * sBs else 1.0
    y_d = theta * y + (1.0 - theta) * Bs
    sy_d = float(torch.dot(s, y_d))
    yy = float(torch.dot(y_d, y_d))
    phi = 0.0 if sy_d < mu2 * yy else 1.0
    return y_d, phi


def lbfgs_minimize(
    energy_force_fn: Callable,        # [P,3] Bohr -> (E Ha, F [P,3])
    x0_bohr_pad: torch.Tensor,        # [P,3]
    free_mask: torch.Tensor,          # [P]
    *,
    thresh: str = "gau",
    max_cycles: int = 10000,
    keep_last: int = 7,
    max_step: float = 0.30,
    beta: float = 1.0,
    gamma_mult: bool = False,
    line_search: bool = True,
    callback: Optional[Callable] = None,
    restart: Optional[Dict[str, Any]] = None,
    **_ignored,
) -> OptResult:
    """Minimize; ``callback(cycle, e, f_flat_numpy)`` fires after every
    cycle. ``restart``: see the module docstring."""
    th = get_thresholds(thresh)
    x = x0_bohr_pad.detach().reshape(-1).to(torch.float64)
    dev = x.device
    D = x.numel()
    mask = free_mask.to(dev, torch.float64).repeat_interleave(3)
    n_free = float(mask.sum())

    def eff(xf):
        e, f = energy_force_fn(xf.reshape(-1, 3))
        return float(e), f.reshape(-1).to(torch.float64)

    M = keep_last
    rkey, hit = None, None
    if restart:
        from ..runtime.checkpoint import content_key, load_state
        every = int(restart.get("every", 50)) or 50
        rkey = content_key(x, extra=f"lbfgs:{thresh}:{keep_last}:{max_step}")
        hit = load_state(restart["store"], restart["name"], LBFGSState,
                         expect_key=rkey)
    if hit is not None:
        st = LBFGSState(*(t.to(dev) for t in hit[1]))
        x, e, f = st.x.to(torch.float64), float(st.e), st.f
        s_hist, y_hist, rho = st.s_hist, st.y_hist, st.rho
        n_hist, cycle = int(st.n_hist), int(st.cycle)
        done, gamma = bool(st.done), float(st.gamma)
    else:
        e, f = eff(x)
        s_hist = torch.zeros(M, D, dtype=torch.float64, device=dev)
        y_hist = torch.zeros(M, D, dtype=torch.float64, device=dev)
        rho = torch.zeros(M, dtype=torch.float64, device=dev)
        n_hist, cycle, done, gamma = 0, 0, False, 1.0

    while not done and cycle < max_cycles:
        d = _two_loop(f, s_hist, y_hist, rho, n_hist, gamma, beta) * mask
        max_comp = float(d.abs().max())
        scale = max_step / max(max_comp, 1e-30) if max_comp > max_step \
            else 1.0
        step = d * scale
        x_new = x + step
        e_new, f_new = eff(x_new)
        e2, f2, x2, step2 = e_new, f_new, x_new, step
        if line_search and e_new > e + 1e-12:
            # quadratic through (0, e, slope) and (1, e_new): one retry
            g0 = -float(torch.dot(f, step))
            denom = 2.0 * (e_new - e - g0)
            alpha = -g0 / denom if abs(denom) > 1e-30 else 0.5
            alpha = min(max(alpha, 0.05), 0.9)
            x_r = x + alpha * step
            e_r, f_r = eff(x_r)
            if e_r < e_new:
                e2, f2, x2, step2 = e_r, f_r, x_r, alpha * step

        s = x2 - x
        y, phi = _double_damp(s, f - f2, gamma)
        sy = float(torch.dot(s, y))
        if phi > 0 and sy > 1e-16:
            if n_hist >= M:
                s_hist = torch.roll(s_hist, -1, 0)
                y_hist = torch.roll(y_hist, -1, 0)
                rho = torch.roll(rho, -1, 0)
            slot = min(n_hist, M - 1)
            s_hist[slot] = s
            y_hist[slot] = y
            rho[slot] = 1.0 / max(sy, 1e-30)
            n_hist = min(n_hist + 1, M)
            if gamma_mult:
                gamma = sy / max(float(torch.dot(y, y)), 1e-30)

        dE = e2 - e
        done = converged(th, f2, step2, dE, n_free)
        x, e, f = x2, e2, f2
        cycle += 1
        if callback is not None:
            callback(cycle, e, f.cpu().numpy())
        if rkey is not None and (done or cycle % every == 0
                                 or cycle >= max_cycles):
            from ..runtime.checkpoint import save_state
            save_state(restart["store"], restart["name"], LBFGSState(
                x, torch.tensor(e), f, s_hist, y_hist, rho,
                torch.tensor(n_hist), torch.tensor(cycle),
                torch.tensor(done), torch.tensor(gamma)),
                {"key": rkey, "done": bool(done)})

    return OptResult(x=x.reshape(-1, 3), e=e, f=f.reshape(-1, 3),
                     cycles=cycle, converged=bool(done))
