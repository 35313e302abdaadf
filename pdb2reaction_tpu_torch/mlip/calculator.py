"""Calculator: the unit-converting, freeze-aware facade over a potential.

Same contract as ``pdb2reaction_tpu/mlip/calculator.py``:

- ``get_energy(coords_bohr)``  -> {"energy": Hartree}
- ``get_forces(coords_bohr)``  -> {"energy", "forces"}: forces flat 3N in
  Hartree/Bohr, frozen atoms zeroed
- ``get_forces_batch(coords [B, 3N])`` -> {"energy" [B], "forces" [B, 3N]}

The potential is ``energy_fn(coords_ang [P, 3], system, params) -> eV``
over a padded system on the calculator's device; forces are autograd
gradients. ``force_calls`` counts every force evaluation, batched images
included. The analytic Hessian is not ported yet (``get_hessian`` raises).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ..constants import BOHR2ANG, EV2AU, F_EVAA_2_AU
from ..core.structure import Structure, pad_to


class Calculator:
    """Freeze-aware, unit-converting calculator over a padded potential."""

    def __init__(
        self,
        structure: Structure,
        energy_fn: Callable,
        *,
        params: Any = None,
        freeze_atoms=None,
        pad_multiple: int = 8,
        device="cpu",
        dtype: torch.dtype = torch.float64,
        weights_source: str = "analytic",
    ):
        if freeze_atoms is not None:
            structure = structure.copy()
            structure.freeze = sorted(set(int(i) for i in freeze_atoms))
        self.structure = structure
        self.device = torch.device(device)
        self.system = pad_to(structure, multiple=pad_multiple,
                             device=self.device)
        self.n_atoms = structure.n_atoms
        self.n_pad = self.system.n_pad
        self.energy_fn = energy_fn
        self.params = params
        # dtype of the coordinates handed to the potential (the model may
        # compute in its own dtype); Hartree/Bohr results are float64
        self.dtype = dtype
        self.weights_source = str(weights_source)
        self.force_calls = 0
        self.energy_calls = 0

    # -- helpers ------------------------------------------------------------
    def _to_pad_ang(self, coords_bohr) -> torch.Tensor:
        c = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3) * BOHR2ANG
        assert c.shape[0] == self.n_atoms, (c.shape, self.n_atoms)
        out = np.zeros((self.n_pad, 3), dtype=np.float64)
        out[: self.n_atoms] = c
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    def _eforce_ang(self, coords_ang: torch.Tensor):
        """(E eV, F eV/Angstrom [P, 3] with frozen and padding rows zero)."""
        c = coords_ang.detach().requires_grad_(True)
        e = self.energy_fn(c, self.system, self.params)
        (g,) = torch.autograd.grad(e, c)
        f = -g * self.system.free_mask[:, None].to(g.dtype)
        return e.detach(), f

    # -- public API (Bohr/Hartree) -------------------------------------------
    def get_energy(self, coords_bohr) -> Dict[str, Any]:
        with torch.no_grad():
            e_ev = self.energy_fn(self._to_pad_ang(coords_bohr), self.system,
                                  self.params)
        self.energy_calls += 1
        return {"energy": float(e_ev) * EV2AU}

    def get_forces(self, coords_bohr) -> Dict[str, Any]:
        e_ev, f = self._eforce_ang(self._to_pad_ang(coords_bohr))
        self.force_calls += 1
        f = f.double().cpu().numpy()[: self.n_atoms] * F_EVAA_2_AU
        return {"energy": float(e_ev) * EV2AU, "forces": f.reshape(-1)}

    def get_forces_batch(self, coords_bohr_batch) -> Dict[str, Any]:
        """B images, one after another: [B, 3N] or [B, N, 3] Bohr."""
        cb = np.asarray(coords_bohr_batch, dtype=np.float64)
        cb = cb.reshape(cb.shape[0], -1)
        es, fs = [], []
        for c in cb:
            r = self.get_forces(c)
            es.append(r["energy"])
            fs.append(r["forces"])
        return {"energy": np.asarray(es), "forces": np.stack(fs)}

    def get_hessian(self, coords_bohr) -> Dict[str, Any]:
        raise NotImplementedError(
            "the analytic Hessian (double backward through the plain path) "
            "is the next port item: see ROADMAP.md")

    # -- padded Bohr conveniences used by engines -------------------------------
    def au_energy_force_fn(self):
        """coords_bohr_pad [P, 3] tensor -> (E Hartree float, F Hartree/Bohr
        [P, 3] float64 tensor, frozen and padding rows zero). Every call
        counts as a force call."""
        def fn(coords_bohr_pad):
            c = coords_bohr_pad.to(self.dtype) * BOHR2ANG
            e_ev, f = self._eforce_ang(c)
            self.force_calls += 1
            return float(e_ev) * EV2AU, f.double() * F_EVAA_2_AU
        return fn

    def pad_bohr(self, coords_bohr) -> torch.Tensor:
        """[N, 3] or [3N] Bohr -> padded [P, 3] float64 tensor on device."""
        c = np.asarray(coords_bohr, dtype=np.float64).reshape(-1, 3)
        out = np.zeros((self.n_pad, 3), dtype=np.float64)
        out[: self.n_atoms] = c
        return torch.as_tensor(out, device=self.device)

    def unpad(self, coords_pad) -> np.ndarray:
        if isinstance(coords_pad, torch.Tensor):
            coords_pad = coords_pad.detach().cpu().numpy()
        return np.asarray(coords_pad, dtype=np.float64)[: self.n_atoms]
