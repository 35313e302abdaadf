"""Harmonic distance restraints as energy-function wrappers.

Counterpart of ``pdb2reaction_tpu/engines/bias.py``:
E_bias = sum_m 1/2 k_m (r_m - t_m)^2, k in eV/Angstrom^2, targets in
Angstrom, added to a potential ``energy_fn(coords, system, params)``.
The wrapped params are ``{"base": <base params>, "targets": [M],
"k": [M]}``, so the targets of a calculator can be swapped by assigning
``calc.params`` without rebuilding it. ``dist_freeze_pairs`` gives the
targets of ``--dist-freeze``: the pairs' current distances.

``biased_calculator`` wraps a calculator's force-path ``energy_fn`` (the
hand-written kernels on the card) and, apart, its ``energy_fn_hessian``
(the all-plain variant the Hessians and HVPs differentiate) with the same
restraint: the kernels stay on the force path, and no second derivative
reaches a kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..mlip.calculator import Calculator


def make_biased_energy_fn(base_energy_fn: Callable,
                          pairs_ij: Sequence[Tuple[int, int]]) -> Callable:
    """``base_energy_fn`` plus M harmonic distance wells on the atom pairs
    ``pairs_ij``; params ``{"base", "targets" [M] Angstrom,
    "k" [M] eV/Angstrom^2}``."""
    idx_i = [int(i) for i, _ in pairs_ij]
    idx_j = [int(j) for _, j in pairs_ij]
    index = {}

    def fn(coords, system, params):
        e = base_energy_fn(coords, system, params["base"])
        dev = coords.device
        if dev not in index:
            index[dev] = (torch.as_tensor(idx_i, device=dev),
                          torch.as_tensor(idx_j, device=dev))
        ii, jj = index[dev]
        r = coords[ii] - coords[jj]
        d = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-24))
        dev_ = d - params["targets"].to(d)
        return e + 0.5 * torch.sum(params["k"].to(d) * dev_ * dev_)

    return fn


def bias_params(targets_ang, k_evAA, base_params: Any = None,
                device="cpu") -> Dict[str, Any]:
    t = torch.as_tensor(np.asarray(targets_ang, dtype=np.float64),
                        device=device)
    k = torch.broadcast_to(torch.as_tensor(k_evAA, dtype=torch.float64,
                                           device=device), t.shape)
    return {"base": base_params, "targets": t, "k": k.clone()}


def dist_freeze_pairs(coords_ang: np.ndarray,
                      pairs_ij: Sequence[Tuple[int, int]]):
    """Targets for ``--dist-freeze``: the listed pairs restrained at their
    current distances."""
    c = np.asarray(coords_ang, dtype=np.float64)
    return [float(np.linalg.norm(c[i] - c[j])) for i, j in pairs_ij]


def biased_calculator(base: Calculator, pairs_ij, targets_ang,
                      k_evAA) -> Calculator:
    """A calculator of ``base``'s structure, freeze list, padding, device
    and Hessian settings whose potential is ``base``'s plus the
    restraints: its ``energy_fn`` wraps ``base.energy_fn`` and its
    ``energy_fn_hessian`` wraps ``base.energy_fn_hessian`` (when ``base``
    has one)."""
    fn_h = base.energy_fn_hessian
    calc = Calculator(
        base.structure, make_biased_energy_fn(base.energy_fn, pairs_ij),
        params=bias_params(targets_ang, k_evAA, base.params, base.device),
        hessian_calc_mode=base.hessian_calc_mode,
        return_partial_hessian=base.return_partial_hessian,
        hessian_double=base.hessian_double, fd_step=base.fd_step,
        pad_multiple=base.n_pad, device=base.device, dtype=base.dtype,
        weights_source=base.weights_source,
        energy_fn_hessian=(make_biased_energy_fn(fn_h, pairs_ij)
                           if fn_h is not None else None),
        mesh=base.mesh)
    calc.spatial = base.spatial
    if hasattr(base, "cfg"):
        calc.cfg = base.cfg
    return calc
