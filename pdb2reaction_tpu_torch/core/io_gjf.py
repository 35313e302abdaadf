"""Gaussian input (.gjf/.com) templates: parse and render.

Counterpart of ``pdb2reaction_tpu/core/io_gjf.py``: the link0, route,
title, charge/spin and atom sections are parsed and the text after the
atoms kept, so a template re-renders with new coordinates. The charge
and spin of a template seed the workflow's (``workflows/common.py``
``resolve_charge_spin``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from .structure import Structure


@dataclass
class GjfTemplate:
    link0: List[str] = field(default_factory=list)
    route: List[str] = field(default_factory=list)
    title: str = "Title"
    charge: int = 0
    spin: int = 1
    symbols: List[str] = field(default_factory=list)
    coords: Optional[np.ndarray] = None
    tail: List[str] = field(default_factory=list)   # anything after coords

    @classmethod
    def parse(cls, path) -> "GjfTemplate":
        lines = Path(path).read_text().splitlines()
        t = cls()
        i = 0
        # link0 (%...) and route (#...)
        while i < len(lines) and lines[i].strip().startswith("%"):
            t.link0.append(lines[i])
            i += 1
        while i < len(lines) and lines[i].strip().startswith("#"):
            t.route.append(lines[i])
            i += 1
        # blank, title, blank
        while i < len(lines) and not lines[i].strip():
            i += 1
        title_lines = []
        while i < len(lines) and lines[i].strip():
            title_lines.append(lines[i])
            i += 1
        t.title = "\n".join(title_lines) or "Title"
        while i < len(lines) and not lines[i].strip():
            i += 1
        # charge spin
        if i < len(lines):
            parts = lines[i].split()
            if len(parts) >= 2:
                t.charge, t.spin = int(parts[0]), int(parts[1])
            i += 1
        # atoms
        syms, coords = [], []
        while i < len(lines) and lines[i].strip():
            p = lines[i].split()
            if len(p) >= 4:
                syms.append(p[0])
                coords.append([float(p[1]), float(p[2]), float(p[3])])
            i += 1
        t.symbols = syms
        t.coords = np.asarray(coords, dtype=np.float64)
        t.tail = lines[i:]
        return t

    def render(self, coords: Optional[np.ndarray] = None) -> str:
        c = self.coords if coords is None else np.asarray(coords).reshape(-1, 3)
        out = list(self.link0)
        out += self.route or ["#p"]
        out += ["", self.title, "", f"{self.charge} {self.spin}"]
        for s, (x, y, z) in zip(self.symbols, c):
            out.append(f" {s:<4s} {x:>14.8f} {y:>14.8f} {z:>14.8f}")
        out.append("")
        out += self.tail
        text = "\n".join(out)
        if not text.endswith("\n"):
            text += "\n"
        return text


def read_gjf(path) -> Structure:
    t = GjfTemplate.parse(path)
    return Structure.from_symbols(t.symbols, t.coords, charge=t.charge,
                                  spin=t.spin, source_path=str(path),
                                  gjf_template=t)


def write_gjf(path, struct: Structure,
              template: Optional[GjfTemplate] = None) -> None:
    t = template or struct.gjf_template
    if t is None:
        t = GjfTemplate(symbols=struct.symbols, coords=struct.coords,
                        charge=struct.charge, spin=struct.spin)
    Path(path).write_text(t.render(struct.coords))
