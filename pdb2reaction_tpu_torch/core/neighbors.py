"""Nearest-K-within-cutoff neighbour lists in dense per-atom layout.

Each atom gets a ``[K]`` row of neighbour indices and a ``[K]`` mask, so
gathers are plain ``x[idx]`` and the K-sum is a reduction over one axis.

Tie order: the JAX package takes the K nearest with ``jax.lax.top_k``,
which keeps the lower index first among equal distances. ``torch.topk``
promises no order among ties, so this module sorts distances with a
STABLE sort (equal keys keep their index order) and takes the first K.
"""

from __future__ import annotations

import torch


def dense_neighbors_rows(coords, atom_mask, cutoff, max_neighbors: int,
                         i0: int, n_rows: int):
    """Neighbour indices/mask for the ``n_rows`` atoms starting at row
    ``i0``. Padding atoms and self-pairs are excluded; atoms with more
    than K neighbours inside the cutoff keep the K nearest.

    Returns idx [n_rows, K] int64 (0 where masked) and mask [n_rows, K]
    float32."""
    P = coords.shape[0]
    rows = coords[i0:i0 + n_rows]
    mask_rows = atom_mask[i0:i0 + n_rows]
    diff = rows[:, None, :] - coords[None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))
    valid = (atom_mask[None, :] > 0) & (mask_rows[:, None] > 0)
    col = torch.arange(P, device=coords.device)[None, :]
    self_pair = col == (i0 + torch.arange(n_rows, device=coords.device))[:, None]
    within = valid & (~self_pair) & (d <= cutoff)
    d_masked = torch.where(within, d, torch.full_like(d, float("inf")))
    k = min(max_neighbors, P)
    vals, order = torch.sort(d_masked, dim=-1, stable=True)
    vals, idx = vals[:, :k], order[:, :k]
    mask = torch.isfinite(vals).to(torch.float32)
    idx = torch.where(mask > 0, idx, torch.zeros_like(idx))
    if k < max_neighbors:
        pad = max_neighbors - k
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return idx, mask


def neighbor_vectors(coords, idx, mask, origin=None):
    """Edge vectors r_j - r_i [P, K, 3] and distances [P, K]; masked slots
    get a safe distance of 1.0 so nothing downstream divides by zero."""
    if origin is None:
        origin = coords
    vec = coords[idx] - origin[:, None, :]
    dist = torch.sqrt(torch.clamp((vec * vec).sum(-1), min=1e-24))
    dist = torch.where(mask > 0, dist, torch.ones_like(dist))
    return vec, dist
