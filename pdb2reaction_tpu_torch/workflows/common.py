"""Shared workflow plumbing the ported ``opt`` needs: input loading
(.xyz/.trj), charge/spin resolution, freeze lists, the calculator factory
and output writing."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import BOHR2ANG
from ..core import io_xyz
from ..core.structure import Structure
from ..mlip.calculator import Calculator
from ..mlip.uma import make_uma_calculator


def load_structure(path) -> Structure:
    p = Path(path)
    suf = p.suffix.lower()
    if suf not in (".xyz", ".trj"):
        raise NotImplementedError(
            f"input format {suf!r}: this port reads .xyz/.trj; PDB and GJF "
            "inputs are ROADMAP.md queue 1 item 10")
    st = io_xyz.read_xyz(p)
    st.input_suffix = suf
    return st


def resolve_charge_spin(struct: Structure, charge: Optional[int],
                        spin: Optional[int]) -> Tuple[int, int]:
    """CLI/caller values; a missing charge raises, spin defaults to 1."""
    if charge is None:
        raise ValueError("Charge (-q/--charge) is required for this input")
    return int(charge), int(spin if spin is not None else 1)


def merge_freeze(struct: Structure, extra: Sequence[int]) -> List[int]:
    """Sorted union of the structure's own and the extra freeze indices
    (link-atom detection needs PDB input, a later port item)."""
    return sorted(set(int(i) for i in list(struct.freeze) + list(extra)))


def make_calculator(struct: Structure, *, calc_mode: str = "uma",
                    charge: int = 0, spin: int = 1,
                    freeze_atoms: Sequence[int] = (),
                    model: str = "escn-md", device="cuda",
                    **calc_kw) -> Calculator:
    mode = (calc_mode or "uma").lower()
    if mode != "uma":
        raise NotImplementedError(
            f"calc_mode {calc_mode!r}: the analytic test potentials are a "
            "later port item (ROADMAP.md queue 1 item 4)")
    return make_uma_calculator(struct, model=model, charge=charge,
                               spin=spin, freeze_atoms=freeze_atoms,
                               device=device, **calc_kw)


def write_outputs(out_dir: Path, name: str, struct: Structure,
                  coords_bohr: np.ndarray,
                  energy: Optional[float] = None) -> List[Path]:
    """Write ``<name>.xyz`` (Angstrom, energy in the comment line)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    st = struct.copy(coords=np.asarray(coords_bohr).reshape(-1, 3)
                     * BOHR2ANG)
    xyz = out_dir / f"{name}.xyz"
    io_xyz.write_xyz(xyz, st, energy=energy)
    return [xyz]
