"""Shared workflow plumbing the ported ``opt`` and ``path-opt`` need:
input loading (.xyz/.trj), charge/spin resolution, freeze lists, the
calculator factory (UMA-class models or the analytic test potentials)
and output writing (.xyz frames and .trj trajectories)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import BOHR2ANG
from ..core import io_xyz
from ..core.structure import Structure
from ..mlip import potentials
from ..mlip.calculator import Calculator
from ..mlip.uma import make_uma_calculator

# calculator options the analytic potentials take
_POTENTIAL_KW = ("hessian_calc_mode", "fd_step", "return_partial_hessian",
                 "hessian_double", "pad_multiple")


def load_structure(path) -> Structure:
    p = Path(path)
    suf = p.suffix.lower()
    if suf not in (".xyz", ".trj"):
        raise NotImplementedError(
            f"input format {suf!r}: this port reads .xyz/.trj; PDB and GJF "
            "inputs are ROADMAP.md queue 1 item 6")
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
                    model: str = "uma-s-1p1", device="cuda",
                    **calc_kw) -> Calculator:
    """The UMA-class calculator (``calc_mode="uma"``) or an analytic test
    potential ("morse", "lj"), which runs every workflow without weights."""
    mode = (calc_mode or "uma").lower()
    if mode == "uma":
        return make_uma_calculator(struct, model=model, charge=charge,
                                   spin=spin, freeze_atoms=freeze_atoms,
                                   device=device, **calc_kw)
    fns = {"morse": potentials.make_morse, "lj": potentials.make_lj}
    if mode not in fns:
        raise ValueError(f"Unknown calc mode {calc_mode!r}")
    if int(calc_kw.get("spatial", 1)) > 1:
        raise ValueError(f"calc_mode={mode!r}: the analytic potentials run "
                         "unsharded; atom-axis sharding (spatial > 1) is "
                         "for the UMA-class models")
    return Calculator(struct, fns[mode](), freeze_atoms=freeze_atoms,
                      device=device,
                      **{k: v for k, v in calc_kw.items()
                         if k in _POTENTIAL_KW})


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


def write_trajectory(out_dir: Path, name: str, struct: Structure,
                     frames_bohr: Sequence[np.ndarray],
                     energies: Optional[Sequence[float]] = None
                     ) -> List[Path]:
    """Write ``<name>.trj`` (Angstrom, each frame's energy in its comment
    line). PDB mirroring comes with PDB input (ROADMAP.md queue 1 item 6)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = [struct.copy(coords=np.asarray(c).reshape(-1, 3) * BOHR2ANG)
              for c in frames_bohr]
    trj = out_dir / f"{name}.trj"
    io_xyz.write_trj(trj, frames, energies=energies)
    return [trj]
