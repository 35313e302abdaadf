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
  (``lanczos_lowest_mode``; its 10 x 10 tridiagonal matrix diagonalised
  by Jacobi rotations, ``eigh_jacobi``).
- Two loops, as in the JAX package. ``loop="device"`` (the default) runs
  growth and relaxation each as one device loop
  (``runtime/device_loop.py``, the counterpart of ``lax.while_loop``):
  on the CPU eager masked cycles, on CUDA one captured CUDA graph a phase
  replayed with a lagged read of the stop flag; ``make_device_growth``
  and ``make_device_relax`` are JAX's. ``loop="host"`` (``_gsm_mep_host``)
  makes one small host read a macro cycle (the frontiers in growth; done,
  climbing and the next climbing-image index in relaxation). Both run the
  same step (``make_macro_step``, its climbing flags and index tensors on
  the device). The JAX package holds its two loops equal, and both are
  the references of the port's two.
- The device loop refuses, on CUDA, closures marked ``collective``
  (atom-axis sharding, tensor-parallel parameters, a data axis): their
  gloo collectives are staged through host memory and cannot be
  captured.

``force_calls`` = (cycles + 1) x M: growth and relaxation cycles, plus the
energy seed of the first climbing-image pick. Cycles a graph replays past
the stop are no-ops and count nothing.
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


def _take(x, i):
    """``x[i]`` for a 0-d index tensor, read on the device."""
    return x.index_select(0, i.reshape(1).to(torch.int64)).squeeze(0)


def _step_core(fm, max_step: float, scale_step: str, fix_ends: bool):
    """Everything in a GSM macro step after the batched force call:
    tangents, projection, climbing, step scaling and metrics. ``fm`` is
    the free mask [1, P, 1]; ``climb_on`` and ``use_tau_hei`` are 0-d bool
    tensors, ``hei_idx`` a 0-d integer tensor and ``tau_hei`` [P, 3], all
    on the device: nothing is read on the host."""

    def core(images, E, F, img_mask, climb_on, hei_idx, tau_hei,
             use_tau_hei):
        F = F * fm
        tau = _tangents(images, E)
        M = images.shape[0]
        is_hei = (torch.arange(M, device=images.device)
                  == hei_idx)[:, None, None]
        # climb_lanczos: the climbing image's tangent may be the Lanczos
        # lowest-curvature direction
        tau = torch.where(is_hei & use_tau_hei, tau_hei.to(tau.dtype)[None],
                          tau)
        f_par = (F * tau).sum((1, 2), keepdim=True) * tau
        f_perp = F - f_par
        # the climbing image takes the full force with its parallel
        # component inverted, F - 2 (F.tau) tau
        climb_vec = f_perp - f_par
        f_eff = torch.where(is_hei & climb_on, climb_vec, f_perp)
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
        hei_fmax = (_take(climb_vec, hei_idx) * fm[0]).abs().max()
        return new_images, E, perp_rms, rms_all, hei_fmax

    return core


def make_macro_step(eforce_batch_fn, free_mask, max_step: float,
                    scale_step: str, fix_ends: bool = True):
    """One macro step: the batched force call, then the step core (its
    ``core`` attribute). ``step(images, img_mask, climb_on, hei_idx,
    tau_hei, use_tau_hei) -> (images, E, perp_rms [M], rms_all,
    hei_fmax)`` with tensor-valued ``climb_on``, ``hei_idx`` and
    ``use_tau_hei``: one step serves both loops, and the device loop's
    cycle reads nothing on the host."""
    core = _step_core(free_mask[None, :, None].to(torch.float64), max_step,
                      scale_step, fix_ends)

    def step(images, img_mask, climb_on, hei_idx, tau_hei, use_tau_hei):
        E, F = eforce_batch_fn(images)
        return core(images, E, F, img_mask, climb_on, hei_idx, tau_hei,
                    use_tau_hei)

    step.core = core
    return step


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


_ROUNDS: dict = {}


def _jacobi_rounds(m: int, device):
    """The round-robin pairing of m (even) indices: m - 1 rounds of m / 2
    disjoint pairs, as flat indices into an [m, m] matrix (pp, qq, pq, qp)
    and the pairs' p and q, made once per (m, device)."""
    key = (m, str(device))
    if key not in _ROUNDS:
        arr = list(range(m))
        rounds = []
        for _ in range(m - 1):
            p = [arr[i] for i in range(m // 2)]
            q = [arr[m - 1 - i] for i in range(m // 2)]
            p, q = torch.tensor(p), torch.tensor(q)
            rounds.append(tuple(t.to(device) for t in (
                p * m + p, q * m + q, p * m + q, q * m + p)))
            arr = [arr[0], arr[-1]] + arr[1:-1]
        _ROUNDS[key] = rounds
    return _ROUNDS[key]


def eigh_jacobi(T, sweeps: int = 12):
    """(w, U) of the symmetric matrix T [n, n] by cyclic Jacobi rotations
    in torch ops (``torch.linalg.eigh`` checks its status on the host, so
    a captured graph cannot hold it): ``sweeps`` sweeps of n - 1 rounds,
    each round n / 2 disjoint rotations at once (odd n: padded with one
    decoupled row, which no rotation touches and which is dropped). The
    eigenvalues come unsorted, U's columns in the same order; a pair whose
    coupling is zero gets the identity, exactly."""
    n = T.shape[0]
    m = n + n % 2
    A = T.new_zeros(m, m)
    A[:n, :n] = T
    V = torch.eye(m, dtype=T.dtype, device=T.device)
    eye = V.reshape(-1)
    for _ in range(sweeps):
        for pp, qq, pq, qp in _jacobi_rounds(m, T.device):
            a = A.reshape(-1)
            app, aqq, apq = a[pp], a[qq], a[pq]
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(
                zero, torch.ones_like(apq), apq))
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(zero, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            J = eye.clone()
            J[pp] = c
            J[qq] = c
            J[pq] = s
            J[qp] = -s
            J = J.reshape(m, m)
            A = J.T @ A @ J
            V = V @ J
    return torch.diagonal(A)[:n], V[:n, :n]


def lanczos_lowest_mode(hvp, x_pad, v0_flat, free_mask_flat,
                        iters: int = 10):
    """Lowest-curvature direction at ``x_pad`` by Lanczos iteration with
    full reorthogonalization on Hessian-vector products.

    hvp: (x_pad [P, 3], v_pad [P, 3]) -> H v [P, 3]. Returns a unit [D]
    flat direction restricted to free DOFs; its sign is arbitrary. After
    a Krylov breakdown (fewer free DOFs than ``iters``) the remaining
    rows of the tridiagonal matrix are decoupled with a large diagonal.
    The tridiagonal matrix is diagonalised by ``eigh_jacobi``, which a
    captured graph can hold (``torch.linalg.eigh`` cannot), in both
    loops.
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
        alphas[k] = torch.where(alive, alpha, alpha.new_full((), BIG))
        betas[k] = torch.where(alive_next, beta_new, beta_new.new_zeros(()))
        q_prev, q, beta, alive = q, q_new, beta_new, alive_next
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w, U = eigh_jacobi(T)
    ritz = (Q.T @ _take(U.T, torch.argmin(w))) * fm
    return ritz / torch.clamp(torch.linalg.norm(ritz), min=1e-30)


LOOPS = ("device", "host")


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
    loop: str = "device",          # "device" (module docstring) | "host"
    on_cycle: Optional[Callable] = None,
    **_ignored,
) -> GsmResult:
    """The GSM MEP between two padded endpoints (Bohr) on their device,
    through the device loop (default) or the host loop (module
    docstring). ``callback`` is called as in the JAX package, after
    growth and at the end; ``on_cycle(cycle, perp_rms)``, host loop only,
    after every relaxation cycle with the overall perpendicular-force RMS
    that cycle read anyway."""
    if loop not in LOOPS:
        raise ValueError(f"loop={loop!r}: one of {LOOPS}")
    x0 = torch.as_tensor(x0_bohr_pad, dtype=torch.float64)
    x1 = torch.as_tensor(x1_bohr_pad, dtype=torch.float64,
                         device=x0.device)
    free_mask = torch.as_tensor(free_mask, device=x0.device).to(x0.dtype)
    M = max_nodes + 2
    kw = dict(
        fully_grown=M - 2 <= 2, max_step=max_step, scale_step=scale_step,
        perp_thresh=perp_thresh,
        max_micro_cycles=int(_ignored.get("max_micro_cycles", 10)),
        max_cycles=max_cycles, stop_in_when_full=stop_in_when_full,
        climb=climb, climb_rms=climb_rms, conv_perp_rms=conv_perp_rms,
        hvp_fn=(hvp_fn if climb_lanczos else None),
        lanczos_iters=lanczos_iters, fix_ends=fix_ends, callback=callback)
    if loop == "host":
        return _gsm_mep_host(eforce_batch_fn, _interp_linear(x0, x1, M),
                             free_mask, on_cycle=on_cycle, **kw)
    if on_cycle is not None:
        raise ValueError("on_cycle needs a host read every cycle: "
                         "loop='host'")
    if x0.is_cuda:
        shared = [name for name, f in (("eforce_batch_fn", eforce_batch_fn),
                                       ("hvp_fn", kw["hvp_fn"]))
                  if getattr(f, "collective", False)]
        if shared:
            raise ValueError(
                f"loop='device' on CUDA: {' and '.join(shared)} run "
                "collectives staged through host memory (atom-axis "
                "sharding, tensor-parallel parameters or a data axis), "
                "which a CUDA graph cannot capture; use loop='host'")
    return _gsm_mep_device(eforce_batch_fn, _interp_linear(x0, x1, M),
                           free_mask, **kw)


def _reinterp(imgs, nl, nr):
    """The ungrown interior re-interpolated linearly between the frontier
    nodes nl and M - 1 - nr (0-d integer tensors): the JAX package's
    documented deviation from pysisyphus, which extrapolates along the
    tangent."""
    M = imgs.shape[0]
    k = torch.arange(M, device=imgs.device)
    li, ri = nl, M - 1 - nr
    w = ((k - li).to(imgs.dtype)
         / torch.clamp(ri - li, min=1).to(imgs.dtype))[:, None, None]
    interior = ((k > li) & (k < ri))[:, None, None]
    interp = (1.0 - w) * _take(imgs, li)[None] + w * _take(imgs, ri)[None]
    return torch.where(interior, interp, imgs)


def _grow_update(perp_rms, nl, nr, stall, M, perp_thresh,
                 max_micro_cycles):
    """The frontiers after a growth cycle: grow a side once its
    perpendicular force has relaxed below ``perp_thresh`` (the pysisyphus
    growth criterion); after ``max_micro_cycles`` cycles without growth
    force the shorter side. 0-d tensors in, (nl, nr, stall) out."""
    grow_l = (_take(perp_rms, nl) < perp_thresh) & ((nl + nr) < M - 2)
    nl2 = nl + grow_l.to(nl.dtype)
    grow_r = (_take(perp_rms, M - 1 - nr) < perp_thresh) \
        & ((nl2 + nr) < M - 2)
    nr2 = nr + grow_r.to(nr.dtype)
    grew = grow_l | grow_r
    stall2 = torch.where(grew, torch.zeros_like(stall), stall + 1)
    force = (~grew) & (stall2 >= max_micro_cycles) & ((nl2 + nr2) < M - 2)
    nl3 = torch.where(force & (nl2 <= nr2), nl2 + 1, nl2)
    nr3 = torch.where(force & (nl2 > nr2), nr2 + 1, nr2)
    return nl3, nr3, torch.where(force, torch.zeros_like(stall2), stall2)


def _growth_cycle(step, M, perp_thresh, max_micro_cycles):
    """(cond, body) of the growth loop over (images, nl, nr, stall,
    cycles, E, n_max), JAX's ``make_device_growth`` cycle."""
    def cond(st):
        _, nl, nr, _, cyc, _, n_max = st
        return ((nl + nr) < (M - 2)) & (cyc < n_max)

    def body(st):
        imgs, nl, nr, stall, cyc, _, n_max = st
        k = torch.arange(M, device=imgs.device)
        gm = ((k <= nl) | (k >= M - 1 - nr)).to(imgs.dtype)
        off = torch.zeros((), dtype=torch.bool, device=imgs.device)
        imgs_new, E, perp_rms, _, _ = step(
            imgs, gm, off, torch.full_like(nl, M // 2),
            torch.zeros_like(imgs[0]), off)
        imgs2 = torch.where(gm[:, None, None] > 0, imgs_new, imgs)
        nl3, nr3, stall3 = _grow_update(perp_rms, nl, nr, stall, M,
                                        perp_thresh, max_micro_cycles)
        return (_reinterp(imgs2, nl3, nr3), nl3, nr3, stall3, cyc + 1, E,
                n_max)

    return cond, body


def make_device_growth(eforce_batch_fn, free_mask, max_step: float,
                       scale_step: str, perp_thresh: float,
                       max_micro_cycles: int, fix_ends: bool = True):
    """The double-ended growth phase as one device loop
    (``runtime.device_loop``): ``grow(images, n_left0, n_right0, n_max) ->
    (images, n_left, n_right, cycles, E)``, the JAX package's
    ``make_device_growth``. The string starts as given, as in both
    packages' host loops: JAX's device loop first re-interpolates its
    interior between the frontier nodes, which on the linear string
    ``gsm_mep`` starts from changes only the last bits, and those decide
    which of two mirror images climbs where their energies tie (Morse H3
    at ``max_nodes=8``). Starting as given, the device loop runs the host
    loop's cycles bit for bit. On CUDA the cycle is captured once per
    closure, settings and string shape and replayed."""
    step = make_macro_step(eforce_batch_fn, free_mask, max_step, scale_step,
                           fix_ends)

    def grow(images, nl0, nr0, n_max):
        from ..runtime import device_loop
        M, dev = images.shape[0], images.device
        i64 = dict(dtype=torch.int64, device=dev)
        nl0, nr0 = torch.as_tensor(nl0, **i64), torch.as_tensor(nr0, **i64)
        cond, body = _growth_cycle(step, M, perp_thresh, max_micro_cycles)
        st = (images, nl0, nr0,
              torch.zeros((), **i64), torch.zeros((), **i64),
              images.new_zeros(M), torch.as_tensor(n_max, **i64))
        key = ("gsm-growth", eforce_batch_fn, float(max_step), scale_step,
               float(perp_thresh), int(max_micro_cycles), bool(fix_ends),
               tuple(images.shape), str(dev))
        imgs, nl, nr, _, cyc, E, _ = device_loop.while_loop(cond, body, st,
                                                            key=key)
        return imgs, nl, nr, cyc, E

    return grow


def _relax_cycle(step, M, P, climb, climb_rms, conv_perp_rms, hvp_fn,
                 lanczos_iters, fm_flat):
    """(cond, body) of the relaxation loop over (images, cycles, climb_on,
    done, E_prev, rms, n_max), JAX's ``make_device_relax`` cycle: with
    ``hvp_fn`` the climbing image's tangent is the Lanczos direction of
    every cycle, used where ``climb_on`` holds."""
    def cond(st):
        return (~st[3]) & (st[1] < st[6])

    def body(st):
        images, cycle, climb_on, _, E_prev, _, n_max = st
        dev = images.device
        hei = _hei_device(E_prev)
        if hvp_fn is not None:
            v0 = (_take(images, torch.clamp(hei + 1, max=M - 1))
                  - _take(images, torch.clamp(hei - 1, min=0))).reshape(-1)
            tau_l = lanczos_lowest_mode(hvp_fn, _take(images, hei), v0,
                                        fm_flat, lanczos_iters
                                        ).reshape(P, 3)
            use_l = climb_on
        else:
            tau_l = images.new_zeros(P, 3)
            use_l = torch.zeros((), dtype=torch.bool, device=dev)
        imgs2, E, _, rms_all, hei_fmax = step(
            images, images.new_ones(M), climb_on, hei, tau_l, use_l)
        # reparametrize, keeping the climbing image where it stepped
        is_hei = (torch.arange(M, device=dev) == hei)[:, None, None]
        images2 = torch.where(is_hei & climb_on, imgs2,
                              _reparam_equal_arc(imgs2))
        if climb:
            climb_on2 = climb_on | (rms_all < climb_rms)
            climb_ok = climb_on & (hei_fmax < max(conv_perp_rms, climb_rms))
        else:
            climb_on2 = climb_on
            climb_ok = torch.ones_like(climb_on)
        done = (rms_all < conv_perp_rms) & climb_ok
        return (images2, cycle + 1, climb_on2, done, E, rms_all, n_max)

    return cond, body


class _Relax:
    """The relaxation's cycles over one set of buffers: ``plain`` without
    the Lanczos tangent (with an HVP: a no-op once ``climb_on`` is set),
    and ``lanczos``, captured when the climbing image first switches on."""

    def __init__(self, plain, make_lanczos):
        self.plain, self.make_lanczos, self.lanczos = plain, make_lanczos, \
            None

    def cycles(self):
        return tuple(c for c in (self.plain, self.lanczos) if c is not None)


def make_device_relax(eforce_batch_fn, free_mask, max_step: float,
                      scale_step: str, climb: bool, climb_rms: float,
                      conv_perp_rms: float, hvp_fn=None,
                      lanczos_iters: int = 10, fix_ends: bool = True):
    """The fully grown string's relaxation as a device loop
    (``runtime.device_loop``): ``relax(images, n_max) -> (images, E,
    cycles, done, rms)``, the JAX package's ``make_device_relax``,
    including its energy seed (one batched call before the loop).

    JAX branches on ``climb_on`` with ``lax.cond`` around the Lanczos
    tangent; one captured graph cannot. With an HVP the loop runs two
    cycles on the same buffers: the first without Lanczos, whose cycle is
    a no-op once ``climb_on`` is set (its flags: that cycle's condition,
    then the loop's), and the second with it, which the host switches to
    at its lagged read. That costs at most one no-op cycle at the switch;
    every cycle that takes effect is JAX's."""
    step = make_macro_step(eforce_batch_fn, free_mask, max_step, scale_step,
                           fix_ends)
    fm_flat = free_mask.repeat_interleave(3)

    def relax(images, n_max):
        from ..runtime import device_loop
        M, P, dev = images.shape[0], images.shape[1], images.device
        E0, _ = eforce_batch_fn(images)    # energy seed for the first HEI
        b = dict(dtype=torch.bool, device=dev)
        st = (images, torch.zeros((), dtype=torch.int64, device=dev),
              torch.zeros((), **b), torch.zeros((), **b), E0,
              images.new_full((), float("inf")),
              torch.as_tensor(n_max, dtype=torch.int64, device=dev))
        args = (M, P, climb, climb_rms, conv_perp_rms)
        cond, body_plain = _relax_cycle(step, *args, None, lanczos_iters,
                                        fm_flat)
        if hvp_fn is not None:
            def cond_plain(s):
                return cond(s) & ~s[2]

            def flags(s):
                return torch.stack([cond_plain(s), cond(s)])
        else:
            cond_plain, flags = cond, None
        key = ("gsm-relax", eforce_batch_fn, float(max_step), scale_step,
               bool(climb), float(climb_rms), float(conv_perp_rms), hvp_fn,
               int(lanczos_iters), bool(fix_ends), tuple(images.shape),
               str(dev))
        loops = device_loop.cached(key)
        if loops is None:
            plain = device_loop.Cycle(cond_plain, body_plain,
                                      tuple(t.clone() for t in st),
                                      flags=flags)

            def make_lanczos():
                _, body = _relax_cycle(step, *args, hvp_fn, lanczos_iters,
                                       fm_flat)
                return device_loop.Cycle(
                    cond, body, plain.state,
                    pool=plain.pool() if plain.cuda else None)

            loops = _Relax(plain, make_lanczos)
            if plain.cuda:
                device_loop.cache(key, loops)
        else:
            for buf, t in zip(loops.plain.state, st):
                buf.copy_(t)
        n, f = loops.plain.run()
        if hvp_fn is not None and f[1]:
            if loops.lanczos is None:
                loops.lanczos = loops.make_lanczos()
            n2, _ = loops.lanczos.run(first=[True])
            n += n2
        imgs, _, _, done, E, rms, _ = (t.clone() for t in loops.plain.state)
        return imgs, E, n, done, rms

    return relax


def _gsm_mep_device(eforce_batch_fn, images, free_mask, *, fully_grown,
                    max_step, scale_step, perp_thresh, max_micro_cycles,
                    max_cycles, stop_in_when_full, climb, climb_rms,
                    conv_perp_rms, hvp_fn, lanczos_iters, fix_ends,
                    callback) -> GsmResult:
    """The device-loop GSM: growth and relaxation each one device loop,
    one host read of its results a phase; force calls = growth cycles x M
    + (relaxation cycles + 1) x M, the energy seed included."""
    M = images.shape[0]
    force_calls = 0
    g_steps = 0
    if not fully_grown:
        grow = make_device_growth(eforce_batch_fn, free_mask, max_step,
                                  scale_step, perp_thresh, max_micro_cycles,
                                  fix_ends)
        images, nl, nr, g, E = grow(images, 1, 1, max_cycles)
        g_steps = int(g)
        force_calls += g_steps * M
        if callback and g_steps:
            callback(g_steps, E.cpu().numpy(), -1.0, int(nl + nr), False)
    budget = min(max_cycles - g_steps, stop_in_when_full)
    relax = make_device_relax(eforce_batch_fn, free_mask, max_step,
                              scale_step, climb, climb_rms, conv_perp_rms,
                              hvp_fn=hvp_fn, lanczos_iters=lanczos_iters,
                              fix_ends=fix_ends)
    images, E, n_relax, done, rms = relax(images, max(budget, 0))
    force_calls += (n_relax + 1) * M       # + 1: the energy seed
    cyc = g_steps + n_relax
    E = E.cpu().numpy()
    if callback:
        callback(cyc, E, -1.0, M - 2, True)
    return GsmResult(images=images.cpu().numpy(), energies=E,
                     hei_idx=select_hei_index(E), converged=bool(done),
                     cycles=cyc, force_calls=force_calls,
                     perp_rms=float(rms))


def _grow_cycle(core, images, E, F, nl, nr, stall, perp_thresh,
                max_micro_cycles):
    """One growth cycle of the host loop after its force call: step the
    grown images, move the frontiers, re-interpolate the ungrown interior
    (one host read: the new frontiers). Returns (images, nl, nr, stall),
    nl and nr host ints, stall a 0-d tensor."""
    M, dev = images.shape[0], images.device
    k = torch.arange(M, device=dev)
    gm = ((k <= nl) | (k >= M - 1 - nr)).to(images.dtype)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    imgs_new, _, perp_rms, _, _ = core(
        images, E, F, gm, off, torch.full((), M // 2, device=dev),
        torch.zeros_like(images[0]), off)
    imgs2 = torch.where(gm[:, None, None] > 0, imgs_new, images)
    i64 = dict(dtype=torch.int64, device=dev)
    nl3, nr3, stall3 = _grow_update(
        perp_rms, torch.full((), nl, **i64), torch.full((), nr, **i64),
        stall, M, perp_thresh, max_micro_cycles)
    nl, nr = torch.stack([nl3, nr3]).tolist()
    return _reinterp(imgs2, nl3, nr3), nl, nr, stall3


def _gsm_mep_host(eforce_batch_fn, images, free_mask, *, fully_grown,
                  max_step, scale_step, perp_thresh, max_micro_cycles,
                  max_cycles, stop_in_when_full, climb, climb_rms,
                  conv_perp_rms, hvp_fn, lanczos_iters, fix_ends,
                  callback, on_cycle=None) -> GsmResult:
    """The host-driven GSM loop: one batched force call, one epilogue and
    one small host read a macro cycle (the frontiers in growth; done,
    climbing and the next climbing-image index in relaxation)."""
    M, dev = images.shape[0], images.device
    core = make_macro_step(eforce_batch_fn, free_mask, max_step, scale_step,
                           fix_ends).core
    fm_flat = free_mask.repeat_interleave(3)
    force_calls = 0
    g_steps = 0
    E = None
    if not fully_grown:
        nl, nr = 1, 1
        stall = torch.zeros((), dtype=torch.int64, device=dev)
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
    gm = torch.ones(M, dtype=images.dtype, device=dev)
    E, _ = eforce_batch_fn(images)    # energy seed for the first HEI pick
    force_calls += M
    hei = _hei_device(E)
    climb_on = torch.zeros((), dtype=torch.bool, device=dev)
    climb_host, hei_host = False, None
    tau_off = images.new_zeros(images.shape[1], 3)
    conv = False
    rms = float("inf")
    n_relax = 0
    for _ in range(max(budget, 0)):
        E_new, F = eforce_batch_fn(images)
        use_l = hvp_fn is not None and climb_host
        tau_l = tau_off
        if use_l:
            v0 = (images[min(hei_host + 1, M - 1)]
                  - images[max(hei_host - 1, 0)]).reshape(-1)
            tau_l = lanczos_lowest_mode(hvp_fn, images[hei_host], v0,
                                        fm_flat, lanczos_iters
                                        ).reshape(-1, 3)
        imgs2, E, _, rms_all, hei_fmax = core(
            images, E_new, F, gm, climb_on, hei, tau_l,
            torch.full((), use_l, dtype=torch.bool, device=dev))
        # reparametrize, keeping the climbing image where it stepped
        is_hei = (torch.arange(M, device=dev) == hei)[:, None, None]
        images = torch.where(is_hei & climb_on, imgs2,
                             _reparam_equal_arc(imgs2))
        if climb:
            climb_ok = climb_on & (hei_fmax < max(conv_perp_rms, climb_rms))
            climb_on = climb_on | (rms_all < climb_rms)
        else:
            climb_ok = torch.ones_like(climb_on)
        done = (rms_all < conv_perp_rms) & climb_ok
        hei = _hei_device(E)
        # the cycle's one host read
        rms, climb_host, done, hei_host = torch.stack([
            rms_all, climb_on.to(E.dtype), done.to(E.dtype),
            hei.to(E.dtype)]).tolist()
        climb_host, hei_host = bool(climb_host), int(hei_host)
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
