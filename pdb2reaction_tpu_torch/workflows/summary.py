"""Summary writers and the compressed energy diagram of path-search.

Counterpart of the part of ``pdb2reaction_tpu/workflows/summary.py``
that path-search uses: ``summary.yaml``, the human ``summary.log``
(per-segment barriers and bond-change blocks; the TS frequency blocks
and the output tree come with the stage-4 workflows, ROADMAP.md queue 1
items 5-6) and the compressed R -> TS1 -> IM1_1 -> ... -> P diagram.

Neither PyYAML nor matplotlib is a dependency. ``summary.yaml`` is
written as JSON with an indent of 2, which is valid YAML and reads back
equal under ``yaml.safe_load``. matplotlib is imported inside the
drawing function only; where it is missing the caller skips the PNG with
a warning (``path_search.run_path_search``), and the diagram's labels,
energies and chain still go into ``summary.yaml``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..constants import AU2KCALPERMOL


def write_summary_yaml(path, summary: Dict[str, Any]) -> Path:
    path = Path(path)
    path.write_text(json.dumps(summary, indent=2, ensure_ascii=False)
                    + "\n")
    return path


def write_summary_log(path, summary: Dict[str, Any], *,
                      elapsed: str = "") -> Path:
    """The human summary: segment table (barrier, dE, E_TS) and each
    segment's bond changes."""
    lines: List[str] = []
    bar = "=" * 72
    lines += [bar, "pdb2reaction-tpu summary", bar, ""]
    segs = summary.get("segments", [])
    lines.append(f"Segments: {len(segs)} "
                 f"({sum(1 for s in segs if s.get('reactive'))} reactive)")
    lines.append("")
    lines.append(f"{'seg':>4} {'type':>9} {'barrier':>10} {'dE':>10} "
                 f"{'E_TS (au)':>16}")
    lines.append(f"{'':>4} {'':>9} {'kcal/mol':>10} {'kcal/mol':>10} {'':>16}")
    for s in segs:
        typ = "kink" if s.get("kink") else (
            "reactive" if s.get("reactive") else "segment")
        lines.append(f"{s['index']:>4} {typ:>9} {s['barrier_kcal']:>10.2f} "
                     f"{s['delta_e_kcal']:>10.2f} {s['e_ts_au']:>16.8f}")
    lines.append("")
    for s in segs:
        if s.get("bond_changes"):
            lines += [f"--- segment {s['index']} bond changes ---",
                      s["bond_changes"], ""]
    if elapsed:
        lines.append(f"Elapsed: {elapsed}")
    path = Path(path)
    path.write_text("\n".join(lines) + "\n")
    return path


def build_levels_diagram(path, names: List[str], levels_au: List[float],
                         *, unit: str = "kcal", title: str = ""):
    """Stationary-point level diagram from (name, energy_au) pairs,
    relative to the first level. Needs matplotlib (imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    conv = AU2KCALPERMOL if unit == "kcal" else 1.0
    e0 = levels_au[0]
    levels = [(e - e0) * conv for e in levels_au]

    fig, ax = plt.subplots(figsize=(1.2 * len(levels) + 2, 4.5))
    w = 0.36
    for i, (lv, nm) in enumerate(zip(levels, names)):
        ax.hlines(lv, i - w, i + w, lw=2.5,
                  color="#C0392B" if nm.startswith("TS") else "#2C3E50")
        ax.annotate(f"{nm}\n{lv:.1f}", (i, lv), textcoords="offset points",
                    xytext=(0, 6), ha="center", fontsize=9)
        if i:
            ax.plot([i - 1 + w, i - w], [levels[i - 1], lv], ls="--",
                    lw=1, color="#7F8C8D")
    ax.set_ylabel(f"dE ({'kcal/mol' if unit == 'kcal' else 'au'})")
    if title:
        ax.set_title(title)
    ax.set_xticks([])
    ax.spines[["top", "right", "bottom"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return Path(path)


def _seg_kind(seg) -> str:
    k = getattr(seg, "kind", None)
    if k:
        return k
    return "kink" if getattr(seg, "is_kink", False) else "seg"


def compressed_diagram(segments) -> Dict[str, Any]:
    """Compressed stationary-point diagram from segment-level dE and
    barrier accumulation:

    - only plain bond-change segments (kind ``seg``, covalent change)
      open a ``TS{n}`` group: TS level = running state energy + segment
      barrier, first intermediate = running + segment dE;
    - non-bond-change segments before the first TS group fold their dE
      into the running reactant-side energy;
    - ``bridge`` segments inside a group with a barrier above 1e-3
      kcal/mol add diagram-only peaks ``IM{n}_TS`` (then ``IM{n}_TS_2``,
      ...);
    - any non-bond-change dE inside a group accumulates into a second
      intermediate ``IM{n}_2``, joined with the ``-|-->`` chain token;
    - the last TS group goes straight to ``P``, whose level is the
      running accumulated energy; with no TS group the diagram is R -> P
      on the last frame's absolute energy;
    - absolute (au) energies anchor at the first frame of the first
      bond-change segment.

    A bridge never opens a TS group, even with a covalent change in it.
    Returns ``{"labels", "energies_kcal", "energies_au", "chain"}``."""
    def _is_bc(s):
        return _seg_kind(s) == "seg" and s.is_reactive

    bc_segs = [s for s in segments if _is_bc(s)]
    E0_au = float((bc_segs[0] if bc_segs else segments[0]).energies[0])

    ts_groups: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    E = 0.0  # running state energy relative to R, kcal/mol
    for s in segments:
        b = float(s.barrier_au) * AU2KCALPERMOL
        d = float(s.delta_e_au) * AU2KCALPERMOL
        if _is_bc(s):
            cur = {"ts": E + (b if np.isfinite(b) else 0.0),
                   "im1": E + (d if np.isfinite(d) else 0.0),
                   "extra": False, "idx": len(ts_groups) + 1, "peaks": []}
            ts_groups.append(cur)
            E = cur["im1"]
            cur["tail"] = E
        else:
            if cur is None:
                if np.isfinite(d):
                    E += d
                continue
            if _seg_kind(s) == "bridge" and np.isfinite(b) and b > 1.0e-3:
                suffix = "" if not cur["peaks"] else f"_{len(cur['peaks']) + 1}"
                cur["peaks"].append({"label": f"IM{cur['idx']}_TS{suffix}",
                                     "energy": E + b})
            if np.isfinite(d):
                E += d
                cur["tail"] = E
                cur["extra"] = True

    if not ts_groups:
        labels = ["R", "P"]
        EP_au = float(segments[-1].energies[-1])
        ek = [0.0, (EP_au - E0_au) * AU2KCALPERMOL]
        chain = ["R", "-->", "P"]
    else:
        labels, ek, chain = ["R"], [0.0], ["R"]
        for i, g in enumerate(ts_groups, start=1):
            labels.append(f"TS{i}")
            ek.append(float(g["ts"]))
            chain += ["-->", f"TS{i}"]
            if i == len(ts_groups):
                continue
            labels.append(f"IM{i}_1")
            ek.append(float(g["im1"]))
            chain += ["-->", f"IM{i}_1"]
            for p in g["peaks"]:
                labels.append(p["label"])
                ek.append(float(p["energy"]))
                chain += ["-->", p["label"]]
            if g["extra"]:
                labels.append(f"IM{i}_2")
                ek.append(float(g["tail"]))
                chain += ["-|-->", f"IM{i}_2"]
        labels.append("P")
        ek.append(E)
        chain += ["-->", "P"]

    return {"labels": labels,
            "energies_kcal": ek,
            "energies_au": [E0_au + e / AU2KCALPERMOL for e in ek],
            "chain": " ".join(chain)}


def build_energy_diagram(path, segments):
    """Draw :func:`compressed_diagram` to ``path`` (needs matplotlib) and
    return it."""
    diag = compressed_diagram(segments)
    build_levels_diagram(path, list(diag["labels"]), diag["energies_au"])
    return diag
