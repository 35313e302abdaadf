"""XYZ / multi-frame TRJ reading and writing.

Coordinates in Angstrom; a written frame's comment line carries its
energy in Hartree when one is given.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .structure import Structure


def read_xyz_frames(path) -> List[Structure]:
    """Read one or more XYZ frames from a .xyz/.trj file."""
    lines = Path(path).read_text().splitlines()
    frames: List[Structure] = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line.split()[0])
        comment = lines[i + 1] if i + 1 < len(lines) else ""
        symbols = []
        coords = np.empty((n, 3), dtype=np.float64)
        for k in range(n):
            parts = lines[i + 2 + k].split()
            symbols.append(parts[0])
            coords[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
        st = Structure.from_symbols(symbols, coords, comment=comment.strip())
        st.source_path = str(path)
        frames.append(st)
        i += 2 + n
    return frames


def read_xyz(path) -> Structure:
    return read_xyz_frames(path)[0]


def parse_energy_comment(comment: str) -> Optional[float]:
    """Extract an energy (Hartree) from an XYZ comment line if present."""
    if not comment:
        return None
    # bare float first token, or "E = x" / "energy: x" styles
    for pat in (r"^\s*([-+]?\d+\.\d+(?:[eE][-+]?\d+)?)\s*$",
                r"[Ee]nergy\s*[:=]?\s*([-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)",
                r"E\s*=\s*([-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)"):
        m = re.search(pat, comment)
        if m:
            try:
                return float(m.group(1))
            except ValueError:
                continue
    # fall back: first parseable float token
    for tok in comment.split():
        try:
            return float(tok)
        except ValueError:
            continue
    return None


def format_xyz(struct: Structure, comment: Optional[str] = None) -> str:
    lines = [str(struct.n_atoms),
             comment if comment is not None else struct.comment]
    for s, (x, y, z) in zip(struct.symbols, struct.coords):
        lines.append(f"{s} {x:.15f} {y:.15f} {z:.15f}")
    return "\n".join(lines) + "\n"


def write_xyz(path, struct: Structure, comment: Optional[str] = None,
              energy: Optional[float] = None) -> None:
    if energy is not None:
        comment = f"{energy:.12f}"
    Path(path).write_text(format_xyz(struct, comment))


def write_trj(path, frames: Sequence[Structure],
              energies: Optional[Sequence[float]] = None) -> None:
    """Frames one after another; each comment line carries its energy
    (Hartree) when ``energies`` is given."""
    blocks = []
    for k, st in enumerate(frames):
        comment = f"{energies[k]:.12f}" if energies is not None else st.comment
        blocks.append(format_xyz(st, comment))
    Path(path).write_text("".join(blocks))
