"""Free-DOF gather and scatter between the padded [P, 3] layout and the
compact [Df] space the dense-Hessian engines (RFO, vib) work in.

Counterpart of ``pdb2reaction_tpu/engines/dof.py``. The freeze list is
fixed for a run, so the index maps are built once on the host; ``gather``
and ``scatter`` run on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


class DofMap:
    def __init__(self, free_mask_pad, n_atoms: int):
        if isinstance(free_mask_pad, torch.Tensor):
            free_mask_pad = free_mask_pad.detach().cpu().numpy()
        free = np.asarray(free_mask_pad) > 0
        self.n_pad = free.shape[0]
        self.n_atoms = n_atoms
        dof_free = np.repeat(free, 3)
        self.free_idx = np.nonzero(dof_free)[0]          # into padded flat
        self.n_free = int(self.free_idx.size)
        # free DOFs among the real (3N) ones, for Hessian compaction
        self.free_in_real = np.nonzero(dof_free[: 3 * n_atoms])[0]
        self._idx = {}

    def _index(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._idx:
            self._idx[key] = torch.as_tensor(self.free_idx, device=device)
        return self._idx[key]

    def gather(self, x_pad3: torch.Tensor) -> torch.Tensor:
        """[P, 3] -> [Df]."""
        return x_pad3.reshape(-1)[self._index(x_pad3.device)]

    def scatter(self, x_free: torch.Tensor, base_pad3: torch.Tensor
                ) -> torch.Tensor:
        """[Df] written over the free DOFs of a copy of ``base_pad3``."""
        flat = base_pad3.reshape(-1).clone()
        flat[self._index(flat.device)] = x_free.to(flat.dtype)
        return flat.reshape(-1, 3)

    def compact_hessian(self, H_3N: np.ndarray) -> np.ndarray:
        """Full (3N, 3N) real-atom Hessian -> (Df, Df) free block."""
        return np.asarray(H_3N)[np.ix_(self.free_in_real, self.free_in_real)]

    def expand_vector(self, v_free) -> np.ndarray:
        """[Df] -> [3N] real-atom flat with zeros on frozen DOFs."""
        if isinstance(v_free, torch.Tensor):
            v_free = v_free.detach().cpu().numpy()
        out = np.zeros(3 * self.n_atoms)
        out[self.free_in_real] = np.asarray(v_free)
        return out
