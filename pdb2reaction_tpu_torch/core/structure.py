"""Structure containers.

- :class:`Structure` — host-side, numpy, variable length, with chemistry
  metadata (charge, spin, frozen atoms). Same fields as the JAX package's.
- :class:`PaddedSystem` — fixed-shape padded tensors on one device. Frozen
  atoms become a per-atom ``free_mask`` and padding an ``atom_mask``, both
  float {0, 1} so they multiply straight into forces and sums.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..constants import ANG2BOHR
from .. import elements

if TYPE_CHECKING:
    from .io_gjf import GjfTemplate


@dataclass
class Structure:
    """A molecular structure in Angstrom with chemistry metadata."""

    numbers: np.ndarray                 # [N] int
    coords: np.ndarray                  # [N, 3] float64, Angstrom
    charge: int = 0
    spin: int = 1                       # multiplicity (2S+1)
    freeze: List[int] = field(default_factory=list)   # 0-based frozen atoms
    comment: str = ""
    pdb_atoms: Optional[List[Dict[str, Any]]] = None
    source_path: Optional[str] = None
    input_suffix: Optional[str] = None
    gjf_template: Optional["GjfTemplate"] = None  # a .gjf/.com input's

    def __post_init__(self):
        self.numbers = np.asarray(self.numbers, dtype=np.int32)
        self.coords = np.asarray(self.coords, dtype=np.float64).reshape(-1, 3)
        assert self.numbers.shape[0] == self.coords.shape[0]

    @classmethod
    def from_symbols(cls, symbols: Sequence[str], coords, **kw) -> "Structure":
        return cls(elements.numbers_from_symbols(symbols), np.asarray(coords),
                   **kw)

    @property
    def n_atoms(self) -> int:
        return int(self.numbers.shape[0])

    @property
    def symbols(self) -> List[str]:
        return elements.symbols_from_numbers(self.numbers)

    @property
    def masses(self) -> np.ndarray:
        return elements.masses_of(self.numbers)

    @property
    def coords_bohr(self) -> np.ndarray:
        return self.coords * ANG2BOHR

    @property
    def free_mask(self) -> np.ndarray:
        m = np.ones(self.n_atoms, dtype=bool)
        if self.freeze:
            m[np.asarray(self.freeze, dtype=int)] = False
        return m

    def copy(self, coords=None) -> "Structure":
        return dataclasses.replace(
            self,
            numbers=self.numbers.copy(),
            coords=(np.asarray(coords, dtype=np.float64).reshape(-1, 3).copy()
                    if coords is not None else self.coords.copy()),
            freeze=list(self.freeze),
            pdb_atoms=([dict(a) for a in self.pdb_atoms]
                       if self.pdb_atoms else None),
        )


@dataclass(frozen=True)
class PaddedSystem:
    """Fixed-shape tensors of one structure (Angstrom) on one device."""

    numbers: torch.Tensor    # [P] int64, 0 = padding
    coords: torch.Tensor     # [P, 3] float64
    atom_mask: torch.Tensor  # [P] float32
    free_mask: torch.Tensor  # [P] float32
    masses: torch.Tensor     # [P] float64, 0 for padding

    @property
    def n_pad(self) -> int:
        return int(self.numbers.shape[0])


def pad_to(struct: Structure, n_pad: Optional[int] = None,
           multiple: int = 8, device="cpu") -> PaddedSystem:
    """Pad a Structure to a fixed size (next multiple of ``multiple``)."""
    n = struct.n_atoms
    if n_pad is None:
        n_pad = -(-n // multiple) * multiple
    assert n_pad >= n
    numbers = np.zeros(n_pad, dtype=np.int64)
    numbers[:n] = struct.numbers
    coords = np.zeros((n_pad, 3), dtype=np.float64)
    coords[:n] = struct.coords
    atom_mask = np.zeros(n_pad, dtype=np.float32)
    atom_mask[:n] = 1.0
    free_mask = np.zeros(n_pad, dtype=np.float32)
    free_mask[:n] = struct.free_mask.astype(np.float32)
    masses = np.zeros(n_pad, dtype=np.float64)
    masses[:n] = struct.masses
    return PaddedSystem(
        numbers=torch.as_tensor(numbers, device=device),
        coords=torch.as_tensor(coords, device=device),
        atom_mask=torch.as_tensor(atom_mask, device=device),
        free_mask=torch.as_tensor(free_mask, device=device),
        masses=torch.as_tensor(masses, device=device),
    )
