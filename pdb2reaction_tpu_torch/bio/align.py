"""Rigid alignment and freeze-guided refinement (numpy only).

Counterpart of ``pdb2reaction_tpu/bio/align.py``: row-vector Kabsch,
special 1-anchor (translation) and 2-anchor (axis) modes on the union of
freeze atoms, stepwise anchor dragging toward the reference with
relaxation and final exact coincidence, and the pair/sequence wrappers
run before every MEP.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.structure import Structure


def kabsch(P: np.ndarray, Q: np.ndarray,
           weights: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal rotation R and translation t with row vectors:
    P @ R + t ≈ Q (minimizing weighted RMSD)."""
    P = np.asarray(P, dtype=float)
    Q = np.asarray(Q, dtype=float)
    w = (np.ones(len(P)) if weights is None
         else np.asarray(weights, dtype=float))
    w = w / w.sum()
    pc = (P * w[:, None]).sum(0)
    qc = (Q * w[:, None]).sum(0)
    P0 = P - pc
    Q0 = Q - qc
    H = (P0 * w[:, None]).T @ Q0
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    t = qc - pc @ R
    return R, t


def rmsd(P, Q) -> float:
    d = np.asarray(P) - np.asarray(Q)
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def align_coords(mobile: np.ndarray, ref: np.ndarray,
                 idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Rigid-align ``mobile`` onto ``ref`` using the subset ``idx``.

    Anchor-count special cases:
    0/None -> all atoms; 1 -> translation only; 2 -> translate midpoint +
    rotate pair axis into coincidence; >=3 -> full Kabsch.
    """
    mobile = np.asarray(mobile, dtype=float)
    ref = np.asarray(ref, dtype=float)
    ids = list(range(len(mobile))) if not idx else list(idx)
    if len(ids) == 1:
        t = ref[ids[0]] - mobile[ids[0]]
        return mobile + t
    if len(ids) == 2:
        i, j = ids
        mm = 0.5 * (mobile[i] + mobile[j])
        rm = 0.5 * (ref[i] + ref[j])
        a = mobile[j] - mobile[i]
        b = ref[j] - ref[i]
        a = a / max(np.linalg.norm(a), 1e-12)
        b = b / max(np.linalg.norm(b), 1e-12)
        v = np.cross(a, b)
        c = float(np.dot(a, b))
        if np.linalg.norm(v) < 1e-12:
            R = np.eye(3) if c > 0 else -np.eye(3)
        else:
            vx = np.array([[0, -v[2], v[1]],
                           [v[2], 0, -v[0]],
                           [-v[1], v[0], 0]])
            R = np.eye(3) + vx + vx @ vx / (1.0 + c)
        return (mobile - mm) @ R.T + rm
    R, t = kabsch(mobile[ids], ref[ids])
    return mobile @ R + t


def align_pair(mobile: Structure, ref: Structure,
               idx: Optional[Sequence[int]] = None) -> None:
    """In-place rigid alignment of ``mobile`` onto ``ref``."""
    mobile.coords = align_coords(mobile.coords, ref.coords, idx)


def refine_to_anchor_coincidence(
    struct: Structure,
    ref_anchor_coords: np.ndarray,        # [n_anchor, 3] target positions
    anchor_idx: Sequence[int],
    relax_fn: Optional[Callable] = None,  # (Structure, extra_freeze) -> coords
    n_steps: int = 4,
) -> None:
    """Drag anchor atoms stepwise onto reference positions, relaxing the
    rest between steps, ending in exact coincidence.

    ``relax_fn(struct, pinned_idx)`` should relax the structure with
    ``pinned_idx`` frozen and return new coordinates. When None, only the
    final exact snap is applied.
    """
    anchor_idx = list(anchor_idx)
    start = struct.coords[anchor_idx].copy()
    target = np.asarray(ref_anchor_coords, dtype=float)
    if relax_fn is None or n_steps <= 1:
        struct.coords[anchor_idx] = target
        return
    for k in range(1, n_steps + 1):
        w = k / n_steps
        struct.coords[anchor_idx] = (1 - w) * start + w * target
        new = relax_fn(struct, anchor_idx)
        if new is not None:
            struct.coords = np.asarray(new, dtype=float).reshape(-1, 3)
            struct.coords[anchor_idx] = (1 - w) * start + w * target
    struct.coords[anchor_idx] = target


def align_sequence_inplace(
    structures: List[Structure],
    anchor_idx: Optional[Sequence[int]] = None,
    relax_fn: Optional[Callable] = None,
    refine: bool = True,
) -> None:
    """Align structures[1:] sequentially onto structures[0] using the union
    of freeze atoms (or ``anchor_idx``), then optionally drag-refine each so
    the anchors coincide exactly."""
    if not structures:
        return
    if anchor_idx is None:
        union = set()
        for s in structures:
            union.update(s.freeze)
        anchor_idx = sorted(union)
    ref = structures[0]
    for s in structures[1:]:
        align_pair(s, ref, anchor_idx if anchor_idx else None)
        if refine and anchor_idx:
            refine_to_anchor_coincidence(
                s, ref.coords[list(anchor_idx)], anchor_idx, relax_fn)
