"""Convergence threshold presets and the convergence test.

Forces in Hartree/Bohr, steps in Bohr. ``baker`` uses the composite rule
max|F| < 3e-4 AND (|dE| < 1e-6 OR max|step| < 3e-4).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


class Thresholds(NamedTuple):
    max_force: float
    rms_force: float
    max_step: float
    rms_step: float
    baker: bool = False
    never: bool = False


PRESETS: Dict[str, Thresholds] = {
    "gau_loose":  Thresholds(2.5e-3, 1.7e-3, 1.0e-2, 6.7e-3),
    "gau":        Thresholds(4.5e-4, 3.0e-4, 1.8e-3, 1.2e-3),
    "gau_tight":  Thresholds(1.5e-5, 1.0e-5, 6.0e-5, 4.0e-5),
    "gau_vtight": Thresholds(2.0e-6, 1.0e-6, 6.0e-6, 4.0e-6),
    "baker":      Thresholds(3.0e-4, math.inf, 3.0e-4, math.inf, baker=True),
    "never":      Thresholds(0.0, 0.0, 0.0, 0.0, never=True),
}


def get_thresholds(name: str) -> Thresholds:
    if name not in PRESETS:
        raise KeyError(f"Unknown threshold preset {name!r}; "
                       f"choose from {sorted(PRESETS)}")
    return PRESETS[name]


def converged(th: Thresholds, forces: torch.Tensor, step: torch.Tensor,
              dE: float, n_free_dof) -> bool:
    """Convergence test over masked flat tensors (``forces`` and ``step``
    already zero on frozen/padded DOFs; ``n_free_dof`` normalizes RMS)."""
    if th.never:
        return False
    n = max(float(n_free_dof), 1.0)
    max_f = float(forces.abs().max())
    rms_f = math.sqrt(float((forces * forces).sum()) / n)
    max_s = float(step.abs().max())
    rms_s = math.sqrt(float((step * step).sum()) / n)
    if th.baker:
        return (max_f < th.max_force) and (
            abs(dE) < 1.0e-6 or max_s < th.max_step)
    return (max_f < th.max_force and rms_f < th.rms_force
            and max_s < th.max_step and rms_s < th.rms_step)
