"""Energy profiles from trajectories: the part of
``pdb2reaction_tpu/workflows/trj2fig.py`` that path-search uses.

``read_trj_energies`` reads the per-frame energies from the comment
lines of a ``.trj``; ``plot_profile`` draws the dE profile with the
highest image marked (and writes a CSV beside it on request). matplotlib
is imported inside ``plot_profile`` only. The ``trj2fig`` subcommand is
ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..constants import AU2KCALPERMOL
from ..core import io_xyz


def read_trj_energies(trj_path) -> List[Optional[float]]:
    frames = io_xyz.read_xyz_frames(trj_path)
    return [io_xyz.parse_energy_comment(f.comment) for f in frames]


def plot_profile(out_path, energies_au: Sequence[float], *,
                 reference: str = "first", unit: str = "kcal",
                 title: str = "", csv_path=None,
                 reverse_x: bool = False) -> Path:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    E = np.asarray([e for e in energies_au if e is not None], dtype=float)
    if reference == "min":
        e0 = E.min()
    elif reference == "last":
        e0 = E[-1]
    elif reference == "none":
        e0 = 0.0
    else:
        e0 = E[0]
    conv = AU2KCALPERMOL if unit == "kcal" else 1.0
    rel = (E - e0) * conv

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(len(rel)), rel, "o-", ms=4, color="#2C3E50")
    hei = int(np.argmax(rel))
    ax.plot([hei], [rel[hei]], "o", ms=7, color="#C0392B")
    ax.annotate(f"{rel[hei]:.1f}", (hei, rel[hei]),
                textcoords="offset points", xytext=(0, 8), ha="center")
    ax.set_xlabel("image")
    ax.set_ylabel(f"dE ({'kcal/mol' if unit == 'kcal' else 'au'})")
    if title:
        ax.set_title(title)
    ax.spines[["top", "right"]].set_visible(False)
    if reverse_x:       # last frame on the left
        ax.invert_xaxis()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    if csv_path:
        np.savetxt(csv_path, np.column_stack([np.arange(len(E)), E, rel]),
                   delimiter=",", header="image,energy_au,rel_" + unit,
                   comments="")
    return Path(out_path)
