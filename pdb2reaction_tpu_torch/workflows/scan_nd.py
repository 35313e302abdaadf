"""2-D and 3-D relaxed distance-grid scans (``scan2d``, ``scan3d``).

Counterpart of ``pdb2reaction_tpu/workflows/scan_nd.py``:

- each axis is a pair with ``{"end", "step"[, "start"]}`` (the start
  defaults to the pair's current distance; ``step`` is a maximum, so an
  axis takes ceil(|end - start| / step) intervals) or ``{"values"}``;
- the sweep is nested: when an outer axis advances, the structure is
  relaxed with only the axes up to that level biased (the inner wells
  get k = 0), warm-started from the previous point at the same level;
  at the innermost level every axis is biased;
- a relaxation is L-BFGS (``relax_mode="lbfgs"``) or RFO from the biased
  exact Hessian (``"rfo"``; the Hessian runs on the all-plain path), all
  through one biased calculator retargeted by assigning ``calc.params``;
- each relaxed grid point gets the unbiased energy (one energy call);
- ``surface.csv`` (``d1_ang,d2_ang[,d3_ang],energy_au``) is always
  written; ``surface_2d.png`` / ``surface_3d.png`` (and an HTML surface
  when plotly is installed) are drawn where matplotlib is installed and
  skipped with a warning where it is not; ``plot_only`` re-draws from an
  existing CSV.

The relaxations and energies run on the calculator's device (the card
unless ``device="cpu"``).
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import AU2KCALPERMOL, BOHR2ANG
from ..engines.bias import bias_params, biased_calculator
from ..engines.lbfgs import lbfgs_minimize
from ..engines.rfo import rfo_optimize
from . import common
from .config import format_elapsed
from .opt import optimize_structure


def grid_values(d0: float, spec: Dict[str, Any]) -> np.ndarray:
    """An axis' values from ``{"start", "end", "step"}`` (start defaults
    to ``d0``; ``step`` is the largest step allowed) or ``{"values"}``."""
    if "values" in spec:
        return np.asarray(spec["values"], dtype=float)
    start = float(spec.get("start", d0))
    end = float(spec["end"])
    step = abs(float(spec.get("step", 0.1))) or 0.1
    delta = abs(end - start)
    if delta < 1e-12:
        return np.array([start], dtype=float)
    return np.linspace(start, end, int(math.ceil(delta / step)) + 1)


def run_scan_nd(
    input_path,
    axes: Sequence[Dict[str, Any]],
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    bias_k: float = 10.0,
    relax_thresh: str = "gau_loose",
    relax_mode: str = "lbfgs",
    relax_max_cycles: int = 300,
    preopt: bool = False,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir=None,
    verbose: bool = True,
    plot_only: Optional[str] = None,
    baseline: str = "min",
    zmin: Optional[float] = None,
    zmax: Optional[float] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """The grid scan over 2 or 3 ``axes`` (``[{"pair": (i, j), ...}]``;
    see the module docstring). ``baseline`` ("min" or "first") sets the
    zero of the plotted surface, ``zmin`` / ``zmax`` its colour range in
    kcal/mol. ``mesh`` and ``spatial`` go to the calculator; over several
    ranks rank 0 writes ``out_dir`` (``common.rank_dir``)."""
    t0 = time.time()
    ndim = len(axes)
    if ndim not in (2, 3):
        raise ValueError(f"run_scan_nd takes 2 or 3 axes, got {ndim}")
    out = common.rank_dir(out_dir or f"./result_scan{ndim}d/")
    out.mkdir(parents=True, exist_ok=True)
    if plot_only:
        table = np.loadtxt(plot_only, delimiter=",", skiprows=1)
        fig = _plot_surface(out, table, ndim, baseline, zmin, zmax)
        return {"surface": table, "outputs": [fig] if fig else []}

    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    freeze = common.merge_freeze(
        struct, [common.resolve_atom_spec(f, struct) for f in freeze_atoms],
        auto_freeze_links)
    struct.freeze = freeze
    pairs = [(common.resolve_atom_spec(ax["pair"][0], struct),
              common.resolve_atom_spec(ax["pair"][1], struct)) for ax in axes]
    base = common.make_calculator(struct, calc_mode=calc_mode, charge=q,
                                  spin=s, freeze_atoms=freeze, model=model,
                                  device=device, mesh=mesh, **calc_kw)

    def distances():
        return [float(np.linalg.norm(struct.coords[i] - struct.coords[j]))
                for i, j in pairs]

    calc = biased_calculator(base, pairs, distances(), bias_k)
    x_init = np.asarray(struct.coords_bohr)

    def relax(coords_bohr, targets, ks):
        """The biased relaxation; a well with k = 0 leaves its pair free."""
        calc.params = bias_params(list(targets), list(ks), base.params,
                                  calc.device)
        x0 = calc.pad_bohr(coords_bohr)
        if relax_mode == "rfo":
            H0 = calc.get_hessian(np.asarray(coords_bohr).reshape(-1))
            res = rfo_optimize(calc.au_energy_force_fn(), x0,
                               calc.system.free_mask, calc.n_atoms,
                               hessian0=H0["hessian"], thresh=relax_thresh,
                               max_cycles=relax_max_cycles)
        else:
            res = lbfgs_minimize(calc.au_energy_force_fn(), x0,
                                 calc.system.free_mask, thresh=relax_thresh,
                                 max_cycles=relax_max_cycles, max_step=0.1)
        return calc.unpad(res.x)

    if preopt:
        coords, e0, conv0, _ = optimize_structure(
            struct, base, opt_mode=relax_mode, thresh=relax_thresh,
            max_cycles=relax_max_cycles)
        x_init = np.asarray(coords)
        struct.coords = x_init * BOHR2ANG
        if verbose:
            print(f"[scan{ndim}d] preopt: E = {e0:.6f} Ha "
                  f"({'conv' if conv0 else 'max cycles'})")
    d0 = distances()
    values = [grid_values(d0[k], axes[k]) for k in range(ndim)]
    energies = np.full(tuple(len(v) for v in values), np.nan)
    rows: List[List[float]] = []

    def sweep(level: int, idx_prefix: Tuple[int, ...],
              fixed: List[float], start: np.ndarray):
        coords_here = start
        for ii, val in enumerate(values[level]):
            targets = fixed + [val]
            ks = [bias_k] * (level + 1) + [0.0] * (ndim - level - 1)
            coords_here = relax(coords_here,
                                targets + [0.0] * (ndim - level - 1), ks)
            idx = idx_prefix + (ii,)
            if level < ndim - 1:
                sweep(level + 1, idx, targets, coords_here)
                continue
            e = float(base.get_energy(coords_here.reshape(-1))["energy"])
            energies[idx] = e
            rows.append(list(targets) + [e])
            if verbose:
                print(f"[scan{ndim}d] {idx}: d = "
                      + ", ".join(f"{t:.3f}" for t in targets)
                      + f" -> E = {e:.6f} Ha")

    sweep(0, (), [], x_init)
    header = ",".join(f"d{k + 1}_ang" for k in range(ndim)) + ",energy_au"
    table = np.asarray(rows)
    csv = out / "surface.csv"
    np.savetxt(csv, table, delimiter=",", header=header, comments="")
    fig = _plot_surface(out, table, ndim, baseline, zmin, zmax)
    if verbose:
        print(f"[scan{ndim}d] elapsed {format_elapsed(t0)}")
    return {"values": values, "energies": energies, "surface": table,
            "outputs": [csv] + ([fig] if fig else []), "structure": struct,
            "calculator": calc,
            "force_calls": base.force_calls + calc.force_calls,
            "energy_calls": base.energy_calls + calc.energy_calls}


def _levels(table: np.ndarray, ndim: int, baseline: str, zmin, zmax):
    """The surface in kcal/mol over its baseline and its colour range."""
    ref = (table[0, ndim] if baseline == "first"
           else np.nanmin(table[:, ndim]))
    E = (table[:, ndim] - ref) * AU2KCALPERMOL
    vmin = zmin if zmin is not None else float(np.nanmin(E))
    vmax = zmax if zmax is not None else float(np.nanmax(E))
    return E, vmin, vmax


def _plot_surface(out: Path, table: np.ndarray, ndim: int,
                  baseline: str = "min", zmin=None, zmax=None
                  ) -> Optional[Path]:
    """``surface_2d.png`` (RBF-smoothed filled contours over the grid
    points) or ``surface_3d.png`` (the points coloured by energy), and
    the HTML surface when plotly is installed. Without matplotlib the
    figures are skipped with a warning and None is returned, as they are
    for a 2-D grid of fewer than three points (no surface to draw)."""
    table = np.atleast_2d(table)
    if ndim == 2 and len(table) < 3:
        print(f"[scan2d] WARNING: surface_2d.png skipped: {len(table)} grid "
              "point(s)")
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"[scan{ndim}d] WARNING: surface_{ndim}d.png skipped: {e}")
        return None
    E, vmin, vmax = _levels(table, ndim, baseline, zmin, zmax)
    levels = np.linspace(vmin, max(vmax, vmin + 1e-9), 24)
    if ndim == 2:
        fig, ax = plt.subplots(figsize=(6, 5))
        x, y = table[:, 0], table[:, 1]
        try:
            from scipy.interpolate import RBFInterpolator
            XX, YY = np.meshgrid(np.linspace(x.min(), x.max(), 80),
                                 np.linspace(y.min(), y.max(), 80))
            Z = RBFInterpolator(np.column_stack([x, y]), E)(
                np.column_stack([XX.ravel(), YY.ravel()])).reshape(XX.shape)
            Z = np.clip(Z, vmin, vmax)
            pc = ax.contourf(XX, YY, Z, levels=levels, cmap="viridis")
            ax.contour(XX, YY, Z, levels=levels[::2], colors="w",
                       linewidths=0.4)
        except Exception:
            pc = ax.tricontourf(x, y, np.clip(E, vmin, vmax),
                                levels=levels, cmap="viridis")
        ax.plot(x, y, "k.", ms=2)
        fig.colorbar(pc, label="dE (kcal/mol)")
        ax.set_xlabel("d1 (Å)")
        ax.set_ylabel("d2 (Å)")
        path = out / "surface_2d.png"
    else:
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        sc = ax.scatter(table[:, 0], table[:, 1], table[:, 2], c=E,
                        cmap="viridis", s=30, vmin=vmin, vmax=vmax)
        fig.colorbar(sc, label="dE (kcal/mol)", shrink=0.7)
        ax.set_xlabel("d1 (Å)")
        ax.set_ylabel("d2 (Å)")
        ax.set_zlabel("d3 (Å)")
        path = out / "surface_3d.png"
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    _maybe_plotly_html(out, table, ndim, baseline, zmin, zmax)
    return path


def _maybe_plotly_html(out: Path, table: np.ndarray, ndim: int,
                       baseline: str = "min", zmin=None, zmax=None
                       ) -> Optional[Path]:
    """``surface_2d.html`` (a mesh over the grid points) or
    ``surface_3d.html`` (an isosurface) when plotly is installed; None
    otherwise."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    E, vmin, vmax = _levels(table, ndim, baseline, zmin, zmax)
    if ndim == 2:
        fig = go.Figure(data=go.Mesh3d(
            x=table[:, 0], y=table[:, 1], z=E, intensity=E,
            cmin=vmin, cmax=vmax, colorscale="Viridis"))
    else:
        fig = go.Figure(data=go.Isosurface(
            x=table[:, 0], y=table[:, 1], z=table[:, 2], value=E,
            isomin=vmin, isomax=vmax, surface_count=6,
            colorscale="Viridis", opacity=0.5))
    path = out / f"surface_{ndim}d.html"
    fig.write_html(path)
    return path
