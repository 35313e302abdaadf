"""Nearest-K-within-cutoff neighbour lists in dense per-atom layout.

Each atom gets a ``[K]`` row of neighbour indices and a ``[K]`` mask, so
gathers are plain ``x[idx]`` and the K-sum is a reduction over one axis.

Tie order: the JAX package takes the K nearest with ``jax.lax.top_k``,
which keeps the lower index first among equal distances. ``torch.topk``
promises no order among ties, so this module sorts distances with a
STABLE sort (equal keys keep their index order) and takes the first K.

``radius_query`` serves the pocket extraction (``bio/extract.py``): every
atom within a cutoff of any of a set of centres.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_distances(coords):
    """[P, 3] -> [P, P] Euclidean distances (safe gradient at 0 via eps)."""
    diff = coords[:, None, :] - coords[None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))


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


def dense_neighbors_images(coords, atom_mask, cutoff, max_neighbors: int):
    """``dense_neighbors_rows`` of every image of ``coords`` [B, P, 3] (one
    system's ``atom_mask`` [P]) at once, for the B images stacked along
    the atom axis: idx [B*P, K] into the stacked rows (image b's
    neighbours offset by b*P; masked slots point at the image's row 0)
    and mask [B*P, K]. Each image's lists are the ones
    ``dense_neighbors_rows`` gives it alone."""
    B, P, _ = coords.shape
    dev = coords.device
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))
    live = atom_mask > 0
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    within = (live[None, :] & live[:, None] & ~eye)[None] & (d <= cutoff)
    d_masked = torch.where(within, d, torch.full_like(d, float("inf")))
    k = min(max_neighbors, P)
    vals, order = torch.sort(d_masked, dim=-1, stable=True)
    vals, idx = vals[..., :k], order[..., :k]
    mask = torch.isfinite(vals).to(torch.float32)
    base = (torch.arange(B, device=dev) * P)[:, None, None]
    idx = torch.where(mask > 0, idx, torch.zeros_like(idx)) + base
    if k < max_neighbors:
        pad = max_neighbors - k
        idx = torch.cat([idx, base.expand(B, P, pad)], -1)
        mask = torch.nn.functional.pad(mask, (0, pad))
    return idx.reshape(B * P, -1), mask.reshape(B * P, -1)


def neighbor_vectors(coords, idx, mask, origin=None):
    """Edge vectors r_j - r_i [P, K, 3] and distances [P, K]; masked slots
    get a safe distance of 1.0 so nothing downstream divides by zero."""
    if origin is None:
        origin = coords
    vec = coords[idx] - origin[:, None, :]
    dist = torch.sqrt(torch.clamp((vec * vec).sum(-1), min=1e-24))
    dist = torch.where(mask > 0, dist, torch.ones_like(dist))
    return vec, dist


def radius_query(coords, centers, cutoff: float, device="cuda",
                 chunk: int = 256):
    """Every (atom, centre) pair with dx*dx + dy*dy + dz*dz <= cutoff^2,
    as an [H, 2] int64 numpy array (atom, centre), in float64 on
    ``device`` in chunks of ``chunk`` centres. The squares are summed in
    that order, as the JAX package's native cell list does; there is no
    |a|^2 + |b|^2 - 2ab expansion (its rounding would move atoms across
    the boundary). Row order is not part of the result's meaning. CUDA
    without a card raises (``mlip.calculator.resolve_device``)."""
    from ..mlip.calculator import resolve_device
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(coords, dtype=np.float64).reshape(-1, 3),
                        device=dev)
    c = torch.as_tensor(np.asarray(centers, dtype=np.float64).reshape(-1, 3),
                        device=dev)
    c2 = float(cutoff) * float(cutoff)
    hits = []
    for c0 in range(0, c.shape[0], chunk):
        cc = c[c0:c0 + chunk]
        dx = a[None, :, 0] - cc[:, None, 0]
        dy = a[None, :, 1] - cc[:, None, 1]
        dz = a[None, :, 2] - cc[:, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        q, i = torch.nonzero(d2 <= c2, as_tuple=True)
        hits.append(torch.stack([i, q + c0], dim=1))
    if not hits:
        return np.zeros((0, 2), dtype=np.int64)
    return torch.cat(hits).cpu().numpy()
