"""Vibrational analysis: mass-weighting, TR projection, PHVA, frequencies.

Counterpart of ``pdb2reaction_tpu/engines/vib.py``:

- full Hessian: mass-weight, project out translations and rotations,
  diagonalize;
- partial-Hessian vibrational analysis (PHVA, frozen atoms): reduce to
  the active DOF block, mass-weight with the active masses, project the
  TR modes of the active atoms inside the active subspace, diagonalize,
  and embed the modes back into 3N with zeros on frozen DOFs;
- eigenvalues with |w^2| <= tol are dropped; negative ones map to
  negative (imaginary) wavenumbers.

The dense algebra is ``torch.linalg`` in float64 on the device of the
Hessian it is given: a numpy Hessian (what ``Calculator.get_hessian``
returns) is diagonalized on the CPU whatever the calculator's device, so
a card run and a CPU run pick their modes, and the signs of their
eigenvectors, from the same LAPACK routine. Eigenvector signs and the
bases of degenerate modes are arbitrary: compare modes up to sign and
degenerate ones as subspaces. Eigenvalues are Hartree/(Bohr^2 amu) and
convert through ``constants.NU_CM_FACTOR``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import elements
from ..constants import NU_CM_FACTOR


class VibResult(NamedTuple):
    freqs_cm: np.ndarray       # [n_modes] signed wavenumbers
    modes_mw: np.ndarray       # [n_modes, 3N] mass-weighted eigenvectors
    modes_cart: np.ndarray     # [n_modes, N, 3] Cartesian, normalized


def _as64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device or a.device, torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=device or "cpu")


def tr_basis(coords_bohr: torch.Tensor, masses_amu: torch.Tensor
             ) -> torch.Tensor:
    """Orthonormal mass-weighted translation + rotation basis [3N, k<=6]
    by SVD of the three translations and the three rotations about the
    centre of mass; null columns (linear molecules, one atom) are zeroed,
    not sliced."""
    N = coords_bohr.shape[0]
    dev = coords_bohr.device
    sqm = torch.sqrt(masses_amu)
    com = (coords_bohr * masses_amu[:, None]).sum(0) / masses_amu.sum()
    x = coords_bohr - com
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    vecs = [(eye[k].expand(N, 3) * sqm[:, None]).reshape(-1)
            for k in range(3)]
    vecs += [(torch.linalg.cross(x, eye[k].expand(N, 3))
              * sqm[:, None]).reshape(-1) for k in range(3)]
    B = torch.stack(vecs, dim=1)                 # [3N, 6]
    U, S, _ = torch.linalg.svd(B, full_matrices=False)
    keep = S > 1e-8 * torch.clamp(S[0], min=1e-30)
    return U * keep[None, :].to(U.dtype)


def _project_out(Hmw: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    P = torch.eye(Hmw.shape[0], dtype=Hmw.dtype, device=Hmw.device) \
        - Q @ Q.T
    Hp = P @ Hmw @ P
    return 0.5 * (Hp + Hp.T)


def _analyze(H_act, coords_act, masses_act):
    sqm = torch.sqrt(torch.repeat_interleave(masses_act, 3))
    Hmw = H_act / sqm[:, None] / sqm[None, :]
    Q = tr_basis(coords_act, masses_act)
    return torch.linalg.eigh(_project_out(Hmw, Q))


def frequencies_and_modes(
    H_au,                              # (3N, 3N) full or (3N_act,)^2 block
    numbers: Sequence[int],
    coords_bohr,                       # (N, 3) full geometry
    freeze_idx: Optional[Sequence[int]] = None,
    tol: float = 1e-6,
) -> VibResult:
    Z = np.asarray(numbers, dtype=int)
    N = Z.size
    masses = elements.masses_of(Z)
    coords = np.asarray(
        coords_bohr.detach().cpu().numpy()
        if isinstance(coords_bohr, torch.Tensor) else coords_bohr,
        dtype=np.float64).reshape(N, 3)

    freeze = sorted(set(int(i) for i in (freeze_idx or []) if 0 <= int(i) < N))
    active = [i for i in range(N) if i not in freeze]
    n_act = len(active)
    act_dof = np.repeat(np.isin(np.arange(N), active), 3)

    H = _as64(H_au)
    dev = H.device
    if freeze:
        if H.shape[0] == 3 * N:
            idx = torch.as_tensor(np.nonzero(act_dof)[0], device=dev)
            H_act = H[idx][:, idx]
        elif H.shape[0] == 3 * n_act:
            H_act = H
        else:
            raise ValueError(f"Hessian shape {tuple(H.shape)} matches "
                             f"neither 3N={3 * N} nor 3N_act={3 * n_act}")
        coords_act, masses_act = coords[active], masses[active]
    else:
        if H.shape[0] != 3 * N:
            raise ValueError(f"Hessian shape {tuple(H.shape)} != "
                             f"3N={3 * N}")
        H_act, coords_act, masses_act = H, coords, masses

    w2, V = _analyze(H_act, _as64(coords_act, dev), _as64(masses_act, dev))
    w2 = w2.cpu().numpy()
    V = V.cpu().numpy()
    sel = np.abs(w2) > tol
    w2, V = w2[sel], V[:, sel]
    freqs = np.sign(w2) * np.sqrt(np.abs(w2)) * NU_CM_FACTOR

    modes_mw = np.zeros((V.shape[1], 3 * N))
    modes_mw[:, act_dof] = V.T
    # Cartesian displacements: un-mass-weight and normalize
    cart = modes_mw / np.sqrt(np.repeat(masses, 3))[None, :]
    cart = cart / np.maximum(np.linalg.norm(cart, axis=1, keepdims=True),
                             1e-30)
    return VibResult(freqs_cm=freqs, modes_mw=modes_mw,
                     modes_cart=cart.reshape(-1, N, 3))


def free_block_modes(H_au, numbers, freeze_idx):
    """Unprojected mass-weighted free-block eigenpairs: the fallback when
    the active space is too small for the TR projection to leave a mode.
    Returns (eigenvalues in Ha/Bohr^2/amu, modes_mw [k, 3N] embedded), as
    numpy."""
    Z = np.asarray(numbers, dtype=int)
    N = Z.size
    sqm = np.sqrt(np.repeat(elements.masses_of(Z), 3))
    act = np.repeat(~np.isin(np.arange(N), list(freeze_idx or [])), 3)
    H = _as64(H_au)
    if H.shape[0] == 3 * N:
        idx = torch.as_tensor(np.nonzero(act)[0], device=H.device)
        H = H[idx][:, idx]
    s = _as64(sqm[act], H.device)
    w, V = torch.linalg.eigh(H / s[:, None] / s[None, :])
    modes = np.zeros((V.shape[1], 3 * N))
    modes[:, act] = V.T.cpu().numpy()
    return w.cpu().numpy(), modes


def free_block_wavenumbers(H_au, numbers, freeze_idx):
    """Signed wavenumbers of the unprojected free block and the Cartesian
    unit vector [N, 3] of its lowest mode (None without a mode): the
    report a tiny active space falls back to when PHVA leaves no mode."""
    w, modes = free_block_modes(H_au, numbers, freeze_idx)
    freqs = np.sign(w) * np.sqrt(np.abs(w)) * NU_CM_FACTOR
    if not len(w):
        return freqs, None
    sqm = np.sqrt(np.repeat(elements.masses_of(np.asarray(numbers, int)),
                            3))
    m = modes[int(np.argmin(freqs))] / sqm
    return freqs, (m / max(np.linalg.norm(m), 1e-30)).reshape(-1, 3)


def count_imaginary(freqs_cm: np.ndarray, thresh_cm: float = 5.0) -> int:
    """Number of imaginary modes below -thresh."""
    return int(np.sum(np.asarray(freqs_cm) < -abs(thresh_cm)))


def mode_animation_frames(coords_ang: np.ndarray, mode_cart: np.ndarray,
                          amplitude_ang: float = 0.3,
                          n_frames: int = 20) -> List[np.ndarray]:
    """Displaced geometries along a normal mode, for a .trj animation."""
    phases = np.sin(np.linspace(0, 2 * np.pi, n_frames, endpoint=False))
    return [coords_ang + amplitude_ang * p * mode_cart for p in phases]
