"""Covalent bond-change detection between two geometries.

Counterpart of ``pdb2reaction_tpu/bio/bonds.py``: a pair (i < j) is
bonded when its distance is at most ``bond_factor (r_i + r_j)`` less a
margin of ``margin_fraction`` of that threshold, and a bond counts as
formed or broken only where the distance changed by at least
``delta_fraction`` of the threshold. Distances are
``sqrt(max(d.d, 1e-24))`` in Bohr with the covalent radii in Bohr. The
masks are computed in float64 on the given device (the calculator's,
when path-search calls it), as the JAX package computes them in one
jitted program on its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import elements
from ..constants import BOHR2ANG

Pair = Tuple[int, int]


@dataclass
class BondChangeResult:
    formed_covalent: Set[Pair]
    broken_covalent: Set[Pair]
    distances_1: Optional[np.ndarray] = None
    distances_2: Optional[np.ndarray] = None

    @property
    def any_change(self) -> bool:
        return bool(self.formed_covalent or self.broken_covalent)


def _bond_masks(R1, R2, cov, bond_factor, margin_fraction, delta_fraction):
    def dists(R):
        d = R[:, None, :] - R[None, :, :]
        return torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-24))

    D1, D2 = dists(R1), dists(R2)
    T = bond_factor * (cov[:, None] + cov[None, :])
    eps = margin_fraction * T
    N = R1.shape[0]
    up = torch.triu(torch.ones((N, N), dtype=torch.bool, device=R1.device),
                    diagonal=1)
    A1 = (D1 <= (T - eps)) & up
    A2 = (D2 <= (T - eps)) & up
    need = ((D2 - D1).abs() >= delta_fraction * T) & up
    formed = ~A1 & A2 & need
    broken = A1 & ~A2 & need
    return formed, broken, D1, D2


def compare_structures(
    numbers: Sequence[int],
    coords1_bohr,
    coords2_bohr,
    *,
    bond_factor: float = 1.20,
    margin_fraction: float = 0.05,
    delta_fraction: float = 0.05,
    device="cpu",
) -> BondChangeResult:
    """Formed and broken covalent bonds from ``coords1`` to ``coords2``
    ([N, 3] or [3N] Bohr; arrays or tensors), with both distance
    matrices (Bohr) on the host."""
    Z = np.asarray(numbers, dtype=int)

    def put(c):
        if isinstance(c, torch.Tensor):
            c = c.detach()
        return torch.as_tensor(c, dtype=torch.float64,
                               device=device).reshape(-1, 3)

    R1, R2 = put(coords1_bohr), put(coords2_bohr)
    if R1.shape != R2.shape or R1.shape[0] != Z.size:
        raise ValueError(f"coordinates {tuple(R1.shape)} / "
                         f"{tuple(R2.shape)} for {Z.size} atoms")
    cov = torch.as_tensor(elements.covalent_radii_of(Z, unit="bohr"),
                          dtype=torch.float64, device=R1.device)
    formed, broken, D1, D2 = _bond_masks(
        R1, R2, cov, bond_factor, margin_fraction, delta_fraction)
    return BondChangeResult(
        formed_covalent={(int(i), int(j))
                         for i, j in formed.nonzero().cpu().tolist()},
        broken_covalent={(int(i), int(j))
                         for i, j in broken.nonzero().cpu().tolist()},
        distances_1=D1.cpu().numpy(), distances_2=D2.cpu().numpy())


def summarize_changes(numbers: Sequence[int], result: BondChangeResult,
                      one_based: bool = True) -> str:
    """Formed and broken bonds with their lengths in Angstrom."""
    syms = elements.symbols_from_numbers(np.asarray(numbers, int))

    def tag(i):
        return f"{syms[i]}{i + 1 if one_based else i}"

    lines: List[str] = []
    for title, pairs in (("Covalent bonds formed:", result.formed_covalent),
                         ("Covalent bonds broken:", result.broken_covalent)):
        if not pairs:
            continue
        lines.append(title)
        for i, j in sorted(pairs):
            d1 = result.distances_1[i, j] * BOHR2ANG
            d2 = result.distances_2[i, j] * BOHR2ANG
            lines.append(f"  {tag(i)}-{tag(j)}: {d1:.3f} Å → {d2:.3f} Å")
    if not lines:
        lines.append("No covalent bond changes detected.")
    return "\n".join(lines)
