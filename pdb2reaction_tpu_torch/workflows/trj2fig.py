"""Energy profiles from trajectories (``trj2fig`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/trj2fig.py``:
``read_trj_energies`` reads the per-frame energies from the comment
lines of a ``.trj``; ``plot_profile`` draws the dE profile with the
highest image marked (and writes a CSV beside it on request);
``run_trj2fig`` takes the energies from the comments or recomputes them
with a calculator, and writes each requested output by its suffix
(``.csv`` a table, ``.html`` an interactive page, anything else a
matplotlib figure with a CSV beside the first). matplotlib and plotly
are imported inside the drawing functions only; without plotly the HTML
page embeds the matplotlib PNG.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..constants import AU2KCALPERMOL
from ..core import io_xyz
from . import common


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


def run_trj2fig(
    trj_path,
    *,
    out_path=None,
    reference: str = "first",
    unit: str = "kcal",
    recompute: bool = False,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    csv: bool = True,
    reverse_x: bool = False,
    extra_outputs: Optional[Sequence] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """The energy profile of ``trj_path``: energies from its comment
    lines, or recomputed on ``device`` when asked or when a frame carries
    none; one output per requested path, by suffix (default: the
    trajectory's name with .png)."""
    trj_path = Path(trj_path)
    energies = read_trj_energies(trj_path)
    if recompute or any(e is None for e in energies):
        frames = io_xyz.read_xyz_frames(trj_path)
        q, s = common.resolve_charge_spin(frames[0], charge, spin)
        calc = common.make_calculator(frames[0], calc_mode=calc_mode,
                                      charge=q, spin=s, model=model,
                                      device=device, **calc_kw)
        batch = np.stack([np.pad(f.coords_bohr,
                                 ((0, calc.n_pad - f.n_atoms), (0, 0)))
                          for f in frames])
        E, _ = calc.au_energy_force_batch_fn()(
            torch.as_tensor(batch, device=calc.device))
        energies = [float(e) for e in E.cpu().numpy()]
    requested = [Path(out_path)] if out_path else []
    requested += [Path(o) for o in (extra_outputs or [])]
    if not requested:
        requested = [trj_path.with_suffix(".png")]
    figure = None
    csv_path = None
    for path in requested:
        suf = path.suffix.lower()
        if suf == ".csv":
            E = np.asarray([e for e in energies if e is not None])
            np.savetxt(path, np.column_stack([np.arange(len(E)), E]),
                       delimiter=",", header="image,energy_au",
                       comments="")
            csv_path = csv_path or path
        elif suf == ".html":
            _write_html_profile(path, energies, reference=reference,
                                unit=unit, title=trj_path.name,
                                reverse_x=reverse_x)
            figure = figure or path
        else:
            auto_csv = path.with_suffix(".csv") if csv and figure is None \
                else None
            plot_profile(path, energies, reference=reference, unit=unit,
                         title=trj_path.name, csv_path=auto_csv,
                         reverse_x=reverse_x)
            if auto_csv is not None:
                csv_path = csv_path or auto_csv
            figure = figure or path
    return {"energies": energies, "figure": figure, "csv": csv_path,
            "extras": requested[1:]}


def _write_html_profile(path, energies_au, *, reference, unit, title,
                        reverse_x):
    """Interactive HTML output: plotly when importable, else a page that
    embeds the matplotlib PNG (base64)."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        go = None
    if go is not None:
        E = np.asarray([e for e in energies_au if e is not None])
        e0 = {"min": E.min(), "last": E[-1],
              "none": 0.0}.get(reference, E[0])
        conv = AU2KCALPERMOL if unit == "kcal" else 1.0
        rel = (E - e0) * conv
        fig = go.Figure(go.Scatter(x=list(range(len(rel))), y=list(rel),
                                   mode="lines+markers"))
        fig.update_layout(xaxis_title="image",
                          yaxis_title=f"dE ({unit})", title=title)
        if reverse_x:
            fig.update_xaxes(autorange="reversed")
        fig.write_html(path)
        return Path(path)
    import base64
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".png") as tmp:
        plot_profile(tmp.name, energies_au, reference=reference, unit=unit,
                     title=title, reverse_x=reverse_x)
        b64 = base64.b64encode(Path(tmp.name).read_bytes()).decode()
    Path(path).write_text(
        f"<html><body><h3>{title}</h3>"
        f'<img src="data:image/png;base64,{b64}"/></body></html>')
    return Path(path)
