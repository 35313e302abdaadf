"""PDB reading and writing in the fixed-column format.

Counterpart of ``pdb2reaction_tpu/core/io_pdb.py``, numpy only: ATOM and
HETATM records parsed with every column's metadata (the first MODEL
only), records written back with the same column widths, a template's
metadata with new coordinates (``overlay_coords_on_template``) and
multi-MODEL trajectories. The written text is the JAX package's byte for
byte on the same records.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import elements
from .structure import Structure

# PDB fixed columns (0-based, end exclusive)
# record 0:6, serial 6:11, name 12:16, altloc 16, resname 17:20(sometimes 17:21),
# chain 21, resseq 22:26, icode 26, x 30:38, y 38:46, z 46:54,
# occupancy 54:60, bfactor 60:66, segid 72:76, element 76:78, charge 78:80


def _guess_element_from_name(name: str, resname: str) -> str:
    """Infer the element from the atom-name column, PDB conventions."""
    name = name.strip()
    if not name:
        return ""
    # Two-character elements occupy columns 13-14 (name left-justified at 12)
    stripped = name.lstrip("0123456789")
    if len(name) >= 2 and name[:2].capitalize() in elements.NUMBERS and name[0].isalpha():
        two = name[:2].capitalize()
        # Avoid misreading e.g. "CA" (alpha carbon) as calcium in amino acids
        if two in ("Ca", "Cd", "Ce", "Co", "Cs", "Cr", "Cu", "Nd", "Ne", "Ni",
                   "Na", "Nb", "Os", "Se", "Sn", "Sr", "Si", "Sb", "Sc", "Hg",
                   "Ho", "Hf", "He", "Pb", "Pd", "Pt"):
            from ..bio.residues import STANDARD_RESNAMES
            if resname.strip() in STANDARD_RESNAMES:
                return stripped[0].capitalize()
            return two
        return two
    ch = stripped[0] if stripped else name[0]
    return ch.capitalize()


def parse_pdb_atoms(path) -> List[Dict[str, Any]]:
    """Parse ATOM/HETATM records into per-atom metadata dicts."""
    atoms: List[Dict[str, Any]] = []
    model_seen = 0
    for raw in Path(path).read_text().splitlines():
        rec = raw[0:6]
        if rec.strip() == "MODEL":
            model_seen += 1
            if model_seen > 1:
                break  # only the first model
        if rec not in ("ATOM  ", "HETATM"):
            continue
        line = raw.ljust(80)
        name = line[12:16]
        resname = line[17:21].strip() or line[17:20].strip()
        elem = line[76:78].strip()
        if not elem or elem.isdigit():
            elem = _guess_element_from_name(name, resname)
        try:
            serial = int(line[6:11])
        except ValueError:
            serial = len(atoms) + 1
        try:
            resseq = int(line[22:26])
        except ValueError:
            resseq = 0
        def _f(s, default=0.0):
            try:
                return float(s)
            except ValueError:
                return default
        atoms.append(dict(
            record=rec.strip(),
            serial=serial,
            name=name.strip(),
            rawname=name,
            altloc=line[16],
            resname=resname,
            chain=line[21],
            resseq=resseq,
            icode=line[26],
            x=_f(line[30:38]), y=_f(line[38:46]), z=_f(line[46:54]),
            occupancy=_f(line[54:60], 1.0),
            bfactor=_f(line[60:66], 0.0),
            segid=line[72:76].strip(),
            element=elem.capitalize() if elem else "",
            charge_field=line[78:80].strip(),
        ))
    return atoms


def read_pdb(path) -> Structure:
    atoms = parse_pdb_atoms(path)
    if not atoms:
        raise ValueError(f"No ATOM/HETATM records found in {path}")
    numbers = []
    coords = np.empty((len(atoms), 3), dtype=np.float64)
    for i, a in enumerate(atoms):
        el = a["element"] or _guess_element_from_name(a["rawname"], a["resname"])
        numbers.append(elements.z_of(el))
        coords[i] = (a["x"], a["y"], a["z"])
    st = Structure(np.array(numbers, dtype=np.int32), coords, pdb_atoms=atoms)
    st.source_path = str(path)
    return st


def format_pdb_line(a: Dict[str, Any], coords) -> str:
    x, y, z = coords
    name = a.get("rawname")
    if not name:
        nm = a.get("name", "")
        el = a.get("element", "")
        # element right-aligned into cols 13-14 when single-char
        name = f" {nm:<3s}" if len(el) == 1 and len(nm) <= 3 else f"{nm:<4s}"
    resname = a.get("resname", "UNK")[:4]
    elem = a.get("element", "")[:2]
    return (
        f"{a.get('record', 'ATOM'):<6s}"[:6]
        + f"{int(a.get('serial', 0)) % 100000:>5d} "
        + f"{name:<4s}"[:4]
        + f"{a.get('altloc', ' ') or ' '}"
        + f"{resname:<4s}"[:4]
        + f"{a.get('chain', ' ') or ' '}"[:1]
        + f"{int(a.get('resseq', 0)) % 10000:>4d}"
        + f"{a.get('icode', ' ') or ' '}"
        + "   "
        + f"{x:8.3f}{y:8.3f}{z:8.3f}"
        + f"{a.get('occupancy', 1.0):6.2f}{a.get('bfactor', 0.0):6.2f}"
        + "      "
        + f"{a.get('segid', ''):<4s}"[:4]
        + f"{elem.upper() if len(elem) == 1 else elem.capitalize():>2s}"
    )


def write_pdb(path, struct: Structure, remark: Optional[str] = None) -> None:
    lines: List[str] = []
    if remark:
        lines.append(f"REMARK   1 {remark}")
    atoms = struct.pdb_atoms
    if atoms is None:
        atoms = [
            dict(record="ATOM", serial=i + 1, name=s, resname="MOL",
                 chain="A", resseq=1, element=s)
            for i, s in enumerate(struct.symbols)
        ]
    for a, xyz in zip(atoms, struct.coords):
        lines.append(format_pdb_line(a, xyz))
    lines.append("END")
    Path(path).write_text("\n".join(lines) + "\n")


def overlay_coords_on_template(template_pdb, coords_ang, out_path,
                               remark: Optional[str] = None) -> None:
    """Write a PDB with the template's metadata but new coordinates; the
    atom count must match the template's."""
    tmpl = read_pdb(template_pdb)
    coords = np.asarray(coords_ang, dtype=np.float64).reshape(-1, 3)
    if coords.shape[0] != tmpl.n_atoms:
        raise ValueError(
            f"Coordinate count {coords.shape[0]} != template atoms {tmpl.n_atoms}"
        )
    st = tmpl.copy(coords=coords)
    write_pdb(out_path, st, remark=remark)


def write_pdb_frames(path, template_struct: Structure,
                     frames: Sequence[np.ndarray],
                     energies: Optional[Sequence[float]] = None) -> None:
    """Multi-MODEL PDB trajectory using the template's metadata."""
    atoms = template_struct.pdb_atoms
    if atoms is None:
        atoms = [
            dict(record="ATOM", serial=i + 1, name=s, resname="MOL",
                 chain="A", resseq=1, element=s)
            for i, s in enumerate(template_struct.symbols)
        ]
    lines: List[str] = []
    for k, coords in enumerate(frames):
        lines.append(f"MODEL     {k + 1:>4d}")
        if energies is not None:
            lines.append(f"REMARK   1 ENERGY_HARTREE {energies[k]:.12f}")
        for a, xyz in zip(atoms, np.asarray(coords).reshape(-1, 3)):
            lines.append(format_pdb_line(a, xyz))
        lines.append("ENDMDL")
    lines.append("END")
    Path(path).write_text("\n".join(lines) + "\n")
