"""Pocket <-> full-structure atom mapping and the full-system merge.

Counterpart of ``pdb2reaction_tpu/bio/merge.py``: atoms matched by
identity keys (chain, residue number, insertion code, name, occurrence),
full-structure indices remapped into a pocket, and pocket coordinates
merged back into the full protein template after a Kabsch fit on the
matched atoms (``bio/align.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.structure import Structure
from .align import kabsch
from .residues import LINK_H_RESNAME

AtomKey = Tuple[str, int, str, str, int]   # chain, resseq, icode, name, occurrence


def atom_keys(atoms: Sequence[dict]) -> List[AtomKey]:
    """Identity keys, duplicate names told apart by their occurrence."""
    seen: Dict[Tuple, int] = {}
    keys = []
    for a in atoms:
        base = (a["chain"], a["resseq"], a["icode"].strip(),
                a["name"].upper())
        n = seen.get(base, 0)
        seen[base] = n + 1
        keys.append(base + (n,))
    return keys


def map_full_to_pocket(full_atoms: Sequence[dict],
                       pocket_atoms: Sequence[dict]) -> Dict[int, int]:
    """full-structure atom index -> pocket atom index (where present)."""
    pk = {k: i for i, k in enumerate(atom_keys(pocket_atoms))}
    out = {}
    for i, k in enumerate(atom_keys(full_atoms)):
        if k in pk:
            out[i] = pk[k]
    return out


def remap_indices(indices: Sequence[int], full_atoms, pocket_atoms
                  ) -> List[int]:
    """Remap 0-based full-structure indices into pocket indices, raising on
    atoms that were not extracted."""
    m = map_full_to_pocket(full_atoms, pocket_atoms)
    out = []
    for i in indices:
        if int(i) not in m:
            raise ValueError(f"Atom index {i} of the full structure is not "
                             "present in the extracted pocket")
        out.append(m[int(i)])
    return out


def merge_pocket_into_full(full_struct: Structure,
                           pocket_struct: Structure,
                           pocket_coords_ang: np.ndarray,
                           full_coords_ang: np.ndarray = None) -> Structure:
    """Overlay pocket coordinates onto the full structure.

    Pocket atoms (link hydrogens excluded) are matched into the template by
    identity key; the pocket frame is first rigid-aligned onto the template
    using the matched atoms (Kabsch), then matched template atoms take the
    pocket coordinates.

    ``full_coords_ang`` overrides the template background coordinates:
    multi-template merges blend the backgrounds of the pair's two
    templates per frame (``workflows/path_search.py``)."""
    assert full_struct.pdb_atoms is not None
    assert pocket_struct.pdb_atoms is not None
    pocket_coords = np.asarray(pocket_coords_ang, dtype=float).reshape(-1, 3)
    bg = (full_struct.coords if full_coords_ang is None
          else np.asarray(full_coords_ang, dtype=float).reshape(-1, 3))

    real = [i for i, a in enumerate(pocket_struct.pdb_atoms)
            if a["resname"] != LINK_H_RESNAME]
    p_atoms = [pocket_struct.pdb_atoms[i] for i in real]
    p_xyz = pocket_coords[real]

    fmap = map_full_to_pocket(full_struct.pdb_atoms, p_atoms)
    if not fmap:
        raise ValueError("No pocket atoms matched the full structure")
    f_idx = np.array(sorted(fmap))
    p_idx = np.array([fmap[i] for i in f_idx])

    R, t = kabsch(p_xyz[p_idx], bg[f_idx])
    aligned = p_xyz @ R + t

    merged = full_struct.copy()
    merged.coords = bg.copy()
    merged.coords[f_idx] = aligned[p_idx]
    return merged
