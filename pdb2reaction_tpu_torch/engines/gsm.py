"""Growing String Method with image-batched forces.

Counterpart of ``pdb2reaction_tpu/engines/gsm.py`` (the pysisyphus
``GrowingString`` + ``StringOptimizer`` configuration of ``GS_KW`` /
``STOPT_KW``): double-ended growth, equal-arc reparametrization, a
climbing image once the perpendicular force RMS drops below ``climb_rms``,
growth on the perpendicular-force criterion until ``max_nodes`` interior
nodes exist, then relaxation of the fully grown string for at most
``stop_in_when_full`` cycles.

- The string is one [M, P, 3] float64 tensor (M = max_nodes + 2) on the
  calculator's device; growing moves two frontier counters, and the
  ungrown interior is re-interpolated linearly between the frontier nodes
  each cycle, as in the JAX package.
- Each macro cycle evaluates every image through one batched closure
  ``eforce_batch_fn`` ([M, P, 3] Bohr -> (E [M], F [M, P, 3])); tangents
  (upwinded), projection, climbing, step scaling and reparametrization
  are vectorised over the images on the device.
- The climbing image's tangent (``climb_lanczos``) is the lowest-curvature
  direction from Lanczos iteration on Hessian-vector products
  (``lanczos_lowest_mode``).
- One loop, the JAX package's host loop (``_gsm_mep_host``): one small
  host read a macro cycle (the frontier's two perpendicular RMS values in
  growth; done, climbing and the next climbing-image index in
  relaxation). The JAX package holds its device and host loops equal,
  and both are this loop's reference; the device loop is not ported.

``force_calls`` = (cycles + 1) x M: growth and relaxation cycles, plus the
energy seed of the first climbing-image pick.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

GS_KW: Dict[str, Any] = {
    "fix_first": True,
    "fix_last": True,
    "max_nodes": 10,
    "perp_thresh": 5e-3,
    "reparam_every": 1,
    "reparam_every_full": 1,
    "param": "equi",
    "max_micro_cycles": 10,
    "climb": True,
    "climb_rms": 5e-4,
    "climb_lanczos": True,
    "climb_lanczos_rms": 5e-4,
    "climb_fixed": False,
}

STOPT_KW: Dict[str, Any] = {
    "stop_in_when_full": 300,
    "max_cycles": 300,
    "scale_step": "global",
    "print_every": 10,
}


class GsmResult(NamedTuple):
    images: np.ndarray       # [M, P, 3] Bohr
    energies: np.ndarray     # [M] Hartree
    hei_idx: int
    converged: bool
    cycles: int
    force_calls: int
    perp_rms: float = float("nan")   # final overall perpendicular-force RMS


def select_hei_index(energies) -> int:
    """Prefer internal local maxima."""
    E = np.asarray(energies, dtype=float)
    n = len(E)
    if n >= 3:
        cands = [i for i in range(1, n - 1)
                 if E[i] > E[i - 1] and E[i] > E[i + 1]]
        if cands:
            return int(max(cands, key=lambda i: E[i]))
        return 1 + int(np.argmax(E[1:-1]))
    return int(np.argmax(E))


def _interp_linear(x0, x1, M):
    w = torch.linspace(0.0, 1.0, M, dtype=x0.dtype,
                       device=x0.device)[:, None, None]
    return (1.0 - w) * x0[None] + w * x1[None]


def _tangents(images, energies):
    """Upwinded unit tangents per image [M, P, 3]; endpoints one-sided."""
    M = images.shape[0]
    fwd = torch.roll(images, -1, 0) - images             # x_{i+1} - x_i
    bwd = images - torch.roll(images, 1, 0)
    higher_fwd = (torch.roll(energies, -1) > torch.roll(energies, 1))
    tau = torch.where(higher_fwd[:, None, None], fwd, bwd)
    tau[0] = fwd[0]
    tau[M - 1] = bwd[M - 1]
    norm = torch.sqrt((tau * tau).sum((1, 2), keepdim=True) + 1e-30)
    return tau / norm


def _reparam_equal_arc(images):
    """Redistribute interior images at equal arc length along the string."""
    M = images.shape[0]
    seg = images[1:] - images[:-1]
    seglen = torch.sqrt((seg * seg).sum((1, 2)) + 1e-30)          # [M-1]
    cum = torch.cat([seglen.new_zeros(1), torch.cumsum(seglen, 0)])
    targets = torch.linspace(0.0, 1.0, M, dtype=images.dtype,
                             device=images.device) * cum[-1]
    seg_idx = torch.clamp(torch.searchsorted(cum, targets, right=True) - 1,
                          0, M - 2)
    frac = (targets - cum[seg_idx]) / torch.clamp(seglen[seg_idx],
                                                  min=1e-30)
    newpos = images[seg_idx] + frac[:, None, None] * seg[seg_idx]
    newpos[0] = images[0]
    newpos[M - 1] = images[M - 1]
    return newpos


def _make_step_core(fm, max_step: float, scale_step: str, fix_ends: bool):
    """Everything in a GSM macro step after the batched force call:
    tangents, projection, climbing, step scaling and metrics. ``fm`` is
    the free mask [1, P, 1]; ``climb_on`` / ``use_tau_hei`` are host
    bools and ``hei_idx`` a host int."""

    def core(images, E, F, img_mask, climb_on, hei_idx, tau_hei,
             use_tau_hei):
        F = F * fm
        tau = _tangents(images, E)
        # climb_lanczos: the climbing image's tangent may be the Lanczos
        # lowest-curvature direction
        if use_tau_hei:
            tau[hei_idx] = tau_hei
        f_par = (F * tau).sum((1, 2), keepdim=True) * tau
        f_perp = F - f_par
        M = images.shape[0]
        # the climbing image takes the full force with its parallel
        # component inverted, F - 2 (F.tau) tau
        climb_vec = f_perp - f_par
        f_eff = f_perp.clone()
        if climb_on:
            f_eff[hei_idx] = climb_vec[hei_idx]
        active = img_mask[:, None, None]
        f_eff = f_eff * active
        if fix_ends:
            f_eff[0] = 0.0
            f_eff[M - 1] = 0.0
        # steepest-descent step with scaling
        if scale_step == "per_image":
            mx = f_eff.abs().amax((1, 2), keepdim=True)
        else:  # global
            mx = f_eff.abs().max()
        scale = torch.clamp(max_step / torch.clamp(mx, min=1e-30), max=1.0)
        new_images = images + f_eff * scale
        # metrics
        dof = (torch.ones_like(f_perp) * fm * active)
        perp_rms = torch.sqrt((f_perp * f_perp * active).sum((1, 2))
                              / torch.clamp(dof.sum((1, 2)), min=1.0))
        rms_all = torch.sqrt((f_perp * f_perp * active).sum()
                             / torch.clamp(dof.sum(), min=1.0))
        # max |climbing force| on the climbing image: the climb-converged
        # criterion
        hei_fmax = (climb_vec[hei_idx] * fm[0]).abs().max()
        return new_images, E, perp_rms, rms_all, hei_fmax

    return core


def _hei_device(E):
    """``select_hei_index`` on the device: prefer internal local maxima."""
    M = E.shape[0]
    k = torch.arange(M, device=E.device)
    interior = (k > 0) & (k < M - 1)
    is_max = (E > torch.roll(E, 1)) & (E > torch.roll(E, -1)) & interior
    ninf = torch.full_like(E, -float("inf"))
    hei_lmax = torch.argmax(torch.where(is_max, E, ninf))
    hei_int = 1 + torch.argmax(torch.where(interior, E, ninf)[1:M - 1])
    return torch.where(is_max.any(), hei_lmax, hei_int)


def lanczos_lowest_mode(hvp, x_pad, v0_flat, free_mask_flat,
                        iters: int = 10):
    """Lowest-curvature direction at ``x_pad`` by Lanczos iteration with
    full reorthogonalization on Hessian-vector products.

    hvp: (x_pad [P, 3], v_pad [P, 3]) -> H v [P, 3]. Returns a unit [D]
    flat direction restricted to free DOFs; its sign is arbitrary. After
    a Krylov breakdown (fewer free DOFs than ``iters``) the remaining
    rows of the tridiagonal matrix are decoupled with a large diagonal.
    """
    D = v0_flat.shape[0]
    fm = free_mask_flat.to(v0_flat.dtype)
    q = v0_flat * fm
    q = q / torch.clamp(torch.linalg.norm(q), min=1e-30)
    BIG = 1e6   # padding eigenvalue after Krylov breakdown: never lowest
    Q = v0_flat.new_zeros(iters, D)
    alphas = v0_flat.new_zeros(iters)
    betas = v0_flat.new_zeros(iters)
    q_prev = torch.zeros_like(q)
    beta = v0_flat.new_zeros(())
    alive = torch.ones((), dtype=torch.bool, device=v0_flat.device)
    zero = torch.zeros_like(q)
    for k in range(iters):
        Hq = hvp(x_pad, q.reshape(x_pad.shape)).reshape(-1).to(q.dtype) * fm
        alpha = torch.dot(q, Hq)
        r = Hq - alpha * q - beta * q_prev
        r = r - Q.T @ (Q @ r)
        beta_new = torch.linalg.norm(r)
        alive_next = alive & (beta_new > 1e-10)
        q_new = torch.where(alive_next,
                            r / torch.clamp(beta_new, min=1e-30), zero)
        Q[k] = torch.where(alive, q, zero)
        alphas[k] = torch.where(alive, alpha, alpha.new_tensor(BIG))
        betas[k] = torch.where(alive_next, beta_new, beta_new.new_zeros(()))
        q_prev, q, beta, alive = q, q_new, beta_new, alive_next
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w, U = torch.linalg.eigh(T)
    ritz = (Q.T @ U[:, 0]) * fm
    return ritz / torch.clamp(torch.linalg.norm(ritz), min=1e-30)


def gsm_mep(
    eforce_batch_fn: Callable,     # [M, P, 3] Bohr -> (E [M], F [M, P, 3])
    x0_bohr_pad,                   # [P, 3] endpoint A
    x1_bohr_pad,                   # [P, 3] endpoint B
    free_mask,                     # [P]
    *,
    max_nodes: int = 10,
    perp_thresh: float = 5e-3,
    max_cycles: int = 300,
    stop_in_when_full: int = 300,
    max_step: float = 0.1,         # Bohr, per-cycle displacement cap
    scale_step: str = "global",
    climb: bool = True,
    climb_rms: float = 5e-4,
    climb_lanczos: bool = True,
    fix_ends: bool = True,
    lanczos_iters: int = 10,
    hvp_fn: Optional[Callable] = None,   # (x_pad, v_pad) -> H v
    reparam_every: int = 1,
    reparam_every_full: int = 1,
    conv_perp_rms: float = 1.0e-3,  # converged when overall perp RMS below
    callback: Optional[Callable] = None,
    print_every: int = 10,
    on_cycle: Optional[Callable] = None,
    **_ignored,
) -> GsmResult:
    """The GSM MEP between two padded endpoints (Bohr) on their device,
    through the host loop (module docstring). ``callback`` is called as
    in the JAX package, after growth and at the end; ``on_cycle(cycle,
    perp_rms)``, if given, after every relaxation cycle with the overall
    perpendicular-force RMS that cycle read anyway."""
    x0 = torch.as_tensor(x0_bohr_pad, dtype=torch.float64)
    x1 = torch.as_tensor(x1_bohr_pad, dtype=torch.float64,
                         device=x0.device)
    free_mask = torch.as_tensor(free_mask, device=x0.device).to(x0.dtype)
    M = max_nodes + 2
    return _gsm_mep_host(
        eforce_batch_fn, _interp_linear(x0, x1, M), free_mask,
        fully_grown=M - 2 <= 2, max_step=max_step, scale_step=scale_step,
        perp_thresh=perp_thresh,
        max_micro_cycles=int(_ignored.get("max_micro_cycles", 10)),
        max_cycles=max_cycles, stop_in_when_full=stop_in_when_full,
        climb=climb, climb_rms=climb_rms, conv_perp_rms=conv_perp_rms,
        hvp_fn=(hvp_fn if climb_lanczos else None),
        lanczos_iters=lanczos_iters, fix_ends=fix_ends, callback=callback,
        on_cycle=on_cycle)


def _grow_cycle(core, images, E, F, nl, nr, stall, perp_thresh,
                max_micro_cycles):
    """One growth cycle after its force call: step the grown images,
    move the frontiers (one host read: their two perpendicular RMS
    values), re-interpolate the ungrown interior. Returns (images, nl,
    nr, stall)."""
    M = images.shape[0]
    k = torch.arange(M, device=images.device)
    gm = ((k <= nl) | (k >= M - 1 - nr)).to(images.dtype)
    imgs_new, _, perp_rms, _, _ = core(
        images, E, F, gm, False, M // 2, None, False)
    imgs2 = torch.where(gm[:, None, None] > 0, imgs_new, images)
    p_l, p_r = perp_rms[[nl, M - 1 - nr]].tolist()
    # grow a frontier once its perpendicular force has relaxed below
    # perp_thresh (the pysisyphus growth criterion)
    grow_l = p_l < perp_thresh and nl + nr < M - 2
    nl2 = nl + int(grow_l)
    grow_r = p_r < perp_thresh and nl2 + nr < M - 2
    nr2 = nr + int(grow_r)
    grew = grow_l or grow_r
    stall2 = 0 if grew else stall + 1
    force = (not grew) and stall2 >= max_micro_cycles \
        and nl2 + nr2 < M - 2
    nl3 = nl2 + 1 if force and nl2 <= nr2 else nl2
    nr3 = nr2 + 1 if force and nl2 > nr2 else nr2
    stall3 = 0 if force else stall2
    # linear re-interpolation of the ungrown interior between the
    # frontier nodes (the JAX package's documented deviation from
    # pysisyphus, which extrapolates along the tangent)
    li, ri = nl3, M - 1 - nr3
    w = ((k - li).to(images.dtype) / max(ri - li, 1))[:, None, None]
    interior = ((k > li) & (k < ri))[:, None, None]
    interp = (1.0 - w) * imgs2[li][None] + w * imgs2[ri][None]
    return torch.where(interior, interp, imgs2), nl3, nr3, stall3


def _gsm_mep_host(eforce_batch_fn, images, free_mask, *, fully_grown,
                  max_step, scale_step, perp_thresh, max_micro_cycles,
                  max_cycles, stop_in_when_full, climb, climb_rms,
                  conv_perp_rms, hvp_fn, lanczos_iters, fix_ends,
                  callback, on_cycle=None) -> GsmResult:
    """The host-driven GSM loop: one batched force call and one epilogue a
    macro cycle."""
    M = images.shape[0]
    core = _make_step_core(free_mask[None, :, None], max_step, scale_step,
                           fix_ends)
    fm_flat = free_mask.repeat_interleave(3)
    force_calls = 0
    g_steps = 0
    E = None
    if not fully_grown:
        nl, nr, stall = 1, 1, 0
        while g_steps < max_cycles:
            E, F = eforce_batch_fn(images)
            images, nl, nr, stall = _grow_cycle(
                core, images, E, F, nl, nr, stall, perp_thresh,
                max_micro_cycles)
            g_steps += 1
            force_calls += M
            if nl + nr >= M - 2:
                break
        if callback and g_steps:
            callback(g_steps, E.cpu().numpy(), -1.0, nl + nr, False)

    budget = min(max_cycles - g_steps, stop_in_when_full)
    gm = torch.ones(M, dtype=images.dtype, device=images.device)
    E, _ = eforce_batch_fn(images)    # energy seed for the first HEI pick
    force_calls += M
    hei = int(_hei_device(E))
    climb_on = False
    conv = False
    rms = float("inf")
    n_relax = 0
    for _ in range(max(budget, 0)):
        E_new, F = eforce_batch_fn(images)
        use_l = hvp_fn is not None and climb_on
        tau_l = None
        if use_l:
            v0 = (images[min(hei + 1, M - 1)]
                  - images[max(hei - 1, 0)]).reshape(-1)
            tau_l = lanczos_lowest_mode(hvp_fn, images[hei], v0, fm_flat,
                                        lanczos_iters).reshape(-1, 3)
        imgs2, E, _, rms_all, hei_fmax = core(
            images, E_new, F, gm, climb_on, hei, tau_l, use_l)
        # reparametrize, keeping the climbing image where it stepped
        images = _reparam_equal_arc(imgs2)
        if climb_on:
            images[hei] = imgs2[hei]
        if climb:
            climb_ok = climb_on & (hei_fmax < max(conv_perp_rms, climb_rms))
            climb_on2 = climb_on | (rms_all < climb_rms)
        else:
            climb_ok = torch.ones_like(rms_all, dtype=torch.bool)
            climb_on2 = ~climb_ok
        done = (rms_all < conv_perp_rms) & climb_ok
        # the cycle's one host read
        rms, climb_on, done, hei = torch.stack([
            rms_all, climb_on2.to(E.dtype), done.to(E.dtype),
            _hei_device(E).to(E.dtype)]).tolist()
        climb_on, hei = bool(climb_on), int(hei)
        n_relax += 1
        force_calls += M
        if on_cycle is not None:
            on_cycle(g_steps + n_relax, rms)
        if done:
            conv = True
            break
    cyc = g_steps + n_relax
    E = E.cpu().numpy()
    if callback:
        callback(cyc, E, -1.0, M - 2, True)
    return GsmResult(images=images.cpu().numpy(), energies=E,
                     hei_idx=select_hei_index(E), converged=conv,
                     cycles=cyc, force_calls=force_calls,
                     perp_rms=float(rms))
