"""PDB element-column repair (``add-elem-info`` subcommand).

Counterpart of ``pdb2reaction_tpu/bio/add_elem.py``: existing element
fields normalized against the periodic table, missing or invalid ones
inferred from the atom name by residue class (ions by residue name,
protein / nucleic / water H and D rules, selenium in MSE and SEC,
two-letter ligand prefixes), and a whole file repaired with a summary.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

from .. import elements
from . import residues as RES

_TWO_LETTER = {s.upper(): s for s in elements.SYMBOLS.values()
               if len(s) == 2}


def normalize_element(raw: str) -> Optional[str]:
    """Validate/normalize an element field against the periodic table."""
    s = (raw or "").strip()
    if not s:
        return None
    cap = s.capitalize()
    if cap in elements.NUMBERS:
        return cap
    if s.upper() in _TWO_LETTER:
        return _TWO_LETTER[s.upper()]
    return None


def guess_element(atom_name: str, resname: str) -> str:
    """Element of an atom from its name and its residue's class."""
    name = atom_name.strip().upper()
    resname = resname.strip().upper()

    # monatomic ions: element == resname conventions
    if resname in RES.ION:
        cand = normalize_element(resname.rstrip("+-0123456789"))
        if cand:
            return cand
    # waters
    if resname in RES.WATER_RESNAMES:
        return "H" if name.startswith(("H", "D", "1H", "2H")) else "O"
    # deuterium
    if name.startswith("D") and resname in RES.AMINO_ACIDS:
        return "H"
    # selenium residues
    if resname in ("MSE",) and name == "SE":
        return "Se"
    if resname in ("SEC",) and name in ("SE", "SEG"):
        return "Se"

    stripped = name.lstrip("0123456789")
    if not stripped:
        return "H"   # pure-numeric names are hydrogens like "1HB"
    known_res = (resname in RES.AMINO_ACIDS
                 or resname in RES.NUCLEIC_RESNAMES)
    if known_res:
        return stripped[0].capitalize()
    # ligands: honour two-letter element prefixes (FE1, CL2, ...)
    if len(stripped) >= 2 and stripped[:2] in _TWO_LETTER:
        return _TWO_LETTER[stripped[:2]]
    return stripped[0].capitalize()


def assign_elements(input_path, output_path=None,
                    verbose: bool = True) -> Dict[str, Any]:
    """Fill/repair element columns 77-78; returns a summary dict."""
    input_path = Path(input_path)
    output_path = Path(output_path) if output_path else input_path
    text = input_path.read_text().splitlines()
    fixed = 0
    kept = 0
    counts: Dict[str, int] = {}
    out_lines: List[str] = []
    for raw in text:
        if raw[0:6] in ("ATOM  ", "HETATM"):
            line = raw.ljust(80)
            existing = normalize_element(line[76:78])
            if existing is None:
                elem = guess_element(line[12:16], line[17:21])
                fixed += 1
            else:
                elem = existing
                kept += 1
            counts[elem] = counts.get(elem, 0) + 1
            e_field = (f"{elem.upper():>2s}" if len(elem) == 1
                       else f"{elem.capitalize():>2s}")
            raw = line[:76] + e_field + line[78:].rstrip()
        out_lines.append(raw)
    output_path.write_text("\n".join(out_lines) + "\n")
    summary = {"fixed": fixed, "kept": kept, "elements": counts,
               "output": str(output_path)}
    if verbose:
        print(f"[add-elem-info] fixed {fixed}, kept {kept}: {counts}")
    return summary


def pdb_needs_elem_fix(path) -> bool:
    """True if any ATOM/HETATM record lacks a valid element field (the
    preflight of ``all``)."""
    for raw in Path(path).read_text().splitlines():
        if raw[0:6] in ("ATOM  ", "HETATM"):
            if normalize_element(raw.ljust(80)[76:78]) is None:
                return True
    return False
