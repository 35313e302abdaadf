"""Cheap analytic potentials with the padded ``energy_fn`` protocol.

Counterpart of ``pdb2reaction_tpu/mlip/potentials.py``: the deterministic
test backends the engine tests run on, in eV given Angstrom coordinates
[P, 3] of a padded system. Pure PyTorch on any device, in the dtype of the
coordinates, and twice differentiable (Hessians, HVPs).
"""

from __future__ import annotations

from functools import partial

import torch

from .. import elements
from ..core.neighbors import pairwise_distances
from ..core.structure import PaddedSystem
from .so3 import _const


def _pair_mask(system: PaddedSystem, dtype):
    m = system.atom_mask.to(dtype)
    P = m.shape[0]
    eye = torch.eye(P, dtype=dtype, device=m.device)
    return (m[:, None] * m[None, :]) * (1.0 - eye)


def lennard_jones(coords, system: PaddedSystem, epsilon: float = 0.1,
                  sigma: float = 2.5) -> torch.Tensor:
    """Simple homogeneous LJ fluid; eps in eV, sigma in Angstrom."""
    d = pairwise_distances(coords)
    pair = _pair_mask(system, coords.dtype)
    d_safe = torch.where(pair > 0, d, torch.full_like(d, 1e3))
    sr6 = (sigma / d_safe) ** 6
    e = 4.0 * epsilon * (sr6 * sr6 - sr6)
    return 0.5 * (e * pair).sum()


def morse(coords, system: PaddedSystem, De: float = 4.0, a: float = 2.0,
          re_scale: float = 1.0) -> torch.Tensor:
    """Pairwise Morse with equilibrium distance from covalent radii sums:
    bonded wells at r_cov_i + r_cov_j. De in eV, a in 1/Angstrom."""
    radii = _const("covalent_radii", lambda: elements.COVALENT_RADII_ANG,
                   coords.dtype, coords.device)[system.numbers]
    re = (radii[:, None] + radii[None, :]) * re_scale
    d = pairwise_distances(coords)
    pair = _pair_mask(system, coords.dtype)
    d_safe = torch.where(pair > 0, d, re + 50.0)
    x = torch.exp(-a * (d_safe - re))
    # pure Morse, no cutoff: a hard cutoff would put force discontinuities
    # in every optimizer test
    e = De * (x * x - 2.0 * x)
    return 0.5 * (e * pair).sum()


def harmonic_wells(coords, system: PaddedSystem, centers, k: float = 5.0):
    """Each atom tethered to a center: E = 0.5 k sum |r - c|^2 (eV, Ang)."""
    d = coords - centers
    return 0.5 * k * ((d * d).sum(-1) * system.atom_mask.to(d.dtype)).sum()


def _potential(fn, **kw):
    """The Calculator's ``fn(coords, system, params)`` (params unused)."""
    f = partial(fn, **kw)

    def energy_fn(coords, system, params=None):
        return f(coords, system)

    return energy_fn


def make_lj(epsilon: float = 0.1, sigma: float = 2.5):
    return _potential(lennard_jones, epsilon=epsilon, sigma=sigma)


def make_morse(De: float = 4.0, a: float = 2.0, re_scale: float = 1.0):
    return _potential(morse, De=De, a=a, re_scale=re_scale)
