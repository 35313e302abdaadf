"""Radial basis functions with smooth cutoff envelopes (counterpart of
``pdb2reaction_tpu/mlip/radial.py``)."""

from __future__ import annotations

import numpy as np
import torch


def cosine_envelope(d, cutoff):
    """Smooth cutoff: 0.5*(cos(pi d/rc)+1) inside, 0 outside."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    return torch.where(x < 1.0, 0.5 * (torch.cos(np.pi * x) + 1.0),
                       torch.zeros_like(x))


def bessel_basis(d, cutoff, n: int):
    """Sinc-like spherical Bessel basis (DimeNet):
    sqrt(2/rc) sin(n pi d/rc) / d."""
    dn = torch.clamp(d, min=1e-8)
    freqs = torch.arange(1, n + 1, dtype=d.dtype, device=d.device) \
        * (np.pi / cutoff)
    return (np.sqrt(2.0 / cutoff) * torch.sin(dn[..., None] * freqs)
            / dn[..., None])


def gaussian_basis(d, cutoff, n: int, width_scale: float = 1.0):
    centers = torch.linspace(0.0, cutoff, n, dtype=d.dtype, device=d.device)
    width = width_scale * cutoff / n
    return torch.exp(-((d[..., None] - centers) ** 2) / (2.0 * width * width))
