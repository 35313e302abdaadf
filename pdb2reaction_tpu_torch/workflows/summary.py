"""Summary writers and energy diagrams.

Counterpart of ``pdb2reaction_tpu/workflows/summary.py``:
``summary.yaml``, the human ``summary.log`` (per-segment barriers,
bond-change blocks, each segment's TS frequencies with the imaginary-mode
warnings of ``_freq_warnings``, the output tree), the compressed
R -> TS1 -> IM1_1 -> ... -> P diagram, level diagrams and the merged IRC
plot.

Neither PyYAML nor matplotlib is a dependency. ``summary.yaml`` is
written as JSON with an indent of 2 (``yaml_json``: lists of scalars on
one line, every exponent float with a '.' in its mantissa, as YAML 1.1
reads floats), which is valid YAML and reads back equal under
``yaml.safe_load``. matplotlib is imported inside the
drawing functions only; where it is missing the callers skip the PNG
with a warning (``path_search.run_path_search``,
``allflow.run_all``), and the diagram's labels, energies and chain still
go into ``summary.yaml``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..constants import AU2KCALPERMOL


_TOKEN = re.compile(r'"(?:[^"\\]|\\.)*"|(?<![0-9.])-?[0-9]+[eE][-+][0-9]+')


def _scalar(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _emit(obj, pad: str) -> str:
    inner = pad + "  "
    if isinstance(obj, dict) and obj:
        body = ",\n".join(f"{inner}{json.dumps(str(k), ensure_ascii=False)}"
                          f": {_emit(v, inner)}" for k, v in obj.items())
        return "{\n" + body + "\n" + pad + "}"
    if isinstance(obj, (list, tuple)) and obj \
            and not all(_scalar(v) for v in obj):
        body = ",\n".join(inner + _emit(v, inner) for v in obj)
        return "[\n" + body + "\n" + pad + "]"
    return json.dumps(obj, ensure_ascii=False)


def yaml_json(doc) -> str:
    """``doc`` as JSON that YAML 1.1 reads back equal (see the module
    docstring): 1e-09 is written 1.0e-09, which both read as a float."""
    def fix(m):
        t = m.group(0)
        if t[0] == '"':
            return t
        mant, exp = re.split("[eE]", t)
        return f"{mant}.0e{exp}"
    return _TOKEN.sub(fix, _emit(doc, "")) + "\n"


def write_summary_yaml(path, summary: Dict[str, Any]) -> Path:
    path = Path(path)
    path.write_text(yaml_json(summary))
    return path


def _freq_warnings(freqs_cm: Optional[Sequence[float]]) -> List[str]:
    """TS quality diagnostics: no imaginary mode, more than one, or a
    shallow one (|nu| < 50 cm-1); a mode counts as imaginary below -5
    cm-1."""
    if freqs_cm is None or len(freqs_cm) == 0:
        return []
    freqs = np.asarray(freqs_cm)
    n_imag = int((freqs < -5.0).sum())
    warns = []
    if n_imag == 0:
        warns.append("WARNING: no imaginary mode — structure may not be a TS")
    elif n_imag > 1:
        warns.append(f"WARNING: {n_imag} imaginary modes — higher-order "
                     "saddle; consider tsopt flattening")
    if n_imag >= 1 and abs(float(freqs.min())) < 50.0:
        warns.append("WARNING: |imaginary frequency| < 50 cm-1 — shallow "
                     "TS, barrier may be unreliable")
    return warns


def write_summary_log(path, summary: Dict[str, Any], *,
                      elapsed: str = "", command: str = "",
                      freq_blocks: Optional[Dict[int, Sequence[float]]] = None,
                      tree_root: Optional[Path] = None) -> Path:
    """The human summary: the command, the segment table (barrier, dE,
    E_TS), each segment's bond changes and, from ``freq_blocks``, its TS
    frequencies with warnings, then the tree under ``tree_root``."""
    lines: List[str] = []
    bar = "=" * 72
    lines += [bar, "pdb2reaction-tpu summary", bar, ""]
    if command:
        lines += [f"Command: {command}", ""]
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
        if freq_blocks and s["index"] in freq_blocks:
            freqs = freq_blocks[s["index"]]
            lines.append(f"--- segment {s['index']} TS frequencies ---")
            imag = [f for f in freqs if f < 0]
            lines.append("imaginary: " +
                         (", ".join(f"{f:.1f}" for f in imag) or "none"))
            lines += _freq_warnings(freqs)
            lines.append("")
    if tree_root is not None and Path(tree_root).exists():
        lines += ["--- output tree ---"]
        root = Path(tree_root)
        for p in sorted(root.rglob("*")):
            rel = p.relative_to(root)
            indent = "  " * (len(rel.parts) - 1)
            lines.append(f"{indent}{rel.name}")
        lines.append("")
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


def build_energy_diagram(path, segments, *, unit: str = "kcal",
                         labels: Optional[List[str]] = None):
    """Draw :func:`compressed_diagram` to ``path`` (needs matplotlib),
    ``labels`` replacing its first names, and return it."""
    diag = compressed_diagram(segments)
    names = list(diag["labels"])
    if labels:
        names = labels[: len(names)] + names[len(labels):]
    build_levels_diagram(path, names, diag["energies_au"], unit=unit)
    return diag


def build_irc_overview(path, seg_profiles: Dict[int, List[float]],
                       *, unit: str = "kcal"):
    """Every segment's IRC energy profile on one axes (needs
    matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    conv = AU2KCALPERMOL if unit == "kcal" else 1.0
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for si, energies in sorted(seg_profiles.items()):
        if not energies:
            continue
        e = [(x - energies[0]) * conv for x in energies]
        ax.plot(range(len(e)), e, "-o", ms=3, label=f"segment {si}")
    ax.set_xlabel("IRC frame")
    ax.set_ylabel(f"dE ({'kcal/mol' if unit == 'kcal' else 'au'})")
    ax.legend()
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return Path(path)
