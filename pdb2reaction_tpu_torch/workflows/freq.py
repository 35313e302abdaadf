"""Vibrational analysis and thermochemistry (``freq`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/freq.py``: the Hessian
(analytic by default, finite differences on request), PHVA over the
freeze list, ``frequencies_cm-1.txt``, mode animations as ``.trj`` and a
QRRHO thermochemistry block in ``thermoanalysis.yaml``. That file is
written as JSON, which every YAML reader takes, so the port needs no
YAML library. ``mesh`` splits the Hessian's tangents (or FD
displacements) over its data axis, ``spatial=n`` shards the Hessian over
n ranks; over several ranks rank 0 writes ``out_dir``
(``common.rank_dir``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..core import io_xyz
from ..engines.thermo import thermochemistry
from ..engines.vib import frequencies_and_modes, mode_animation_frames
from ..mlip.calculator import Calculator
from . import common
from .config import format_elapsed, pretty_block



def write_vib_outputs(out_dir, struct, vib, th, *, max_write_modes=10,
                      amplitude_ang=0.3, n_frames=20,
                      sort_modes="value"):
    """Write ``frequencies_cm-1.txt``, the animations of the lowest
    ``max_write_modes`` modes (by signed value, or by |value| with
    ``sort_modes="abs"``) and ``thermoanalysis.yaml``. ``struct.coords``
    in Angstrom. Returns the written paths, the frequencies file first."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    freq_txt = out / "frequencies_cm-1.txt"
    freq_txt.write_text("\n".join(f"{f:12.4f}" for f in vib.freqs_cm)
                        + "\n")
    order = np.argsort(np.abs(vib.freqs_cm) if sort_modes == "abs"
                       else vib.freqs_cm)
    wrote = []
    for rank, k in enumerate(order[:max_write_modes]):
        frames = mode_animation_frames(struct.coords, vib.modes_cart[k],
                                       amplitude_ang, n_frames)
        trj = out / f"mode_{rank:03d}_{vib.freqs_cm[k]:.1f}cm-1.trj"
        io_xyz.write_trj(trj, [struct.copy(coords=f) for f in frames])
        wrote.append(trj)
    (out / "thermoanalysis.yaml").write_text(
        json.dumps(th.as_dict(), indent=2) + "\n")
    return [freq_txt] + wrote


def run_freq(
    input_path,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    hessian_calc_mode: str = "auto",
    temperature: float = 298.15,
    pressure: float = 101325.0,
    max_write_modes: int = 10,
    amplitude_ang: float = 0.3,
    n_frames: int = 20,
    sort_modes: str = "value",   # "value" | "abs"
    device="cuda",
    mesh=None,
    out_dir="./result_freq/",
    verbose: bool = True,
    calculator: Optional[Calculator] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """Frequencies and thermochemistry of the structure in ``input_path``.
    ``calculator`` reuses a prepared calculator for that structure (its
    freeze list wins). ``auto_freeze_links`` freezes the parents of a
    PDB input's link hydrogens."""
    t0 = time.time()
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    if calculator is not None:
        freeze = list(calculator.structure.freeze or [])
    else:
        freeze = common.merge_freeze(
            struct, [common.resolve_atom_spec(f, struct)
                     for f in freeze_atoms], auto_freeze_links)
    struct.freeze = freeze
    calc = calculator or common.make_calculator(
        struct, calc_mode=calc_mode, charge=q, spin=s, freeze_atoms=freeze,
        model=model, device=device, hessian_calc_mode=hessian_calc_mode,
        mesh=mesh, **calc_kw)
    if verbose:
        print(pretty_block("freq", {
            "temperature": temperature, "pressure": pressure,
            "max_write": max_write_modes, "amplitude_ang": amplitude_ang,
            "n_frames": n_frames, "sort": sort_modes, "charge": q,
            "spin": s, "hessian_calc_mode": hessian_calc_mode,
            "calc_mode": calc_mode, "model": model,
            "device": str(calc.device)}))
    res = calc.get_hessian(struct.coords_bohr.reshape(-1))
    H, e0 = res["hessian"], res["energy"]
    vib = frequencies_and_modes(H, struct.numbers, struct.coords_bohr,
                                freeze_idx=freeze)
    th = thermochemistry(vib.freqs_cm, struct.numbers, struct.coords,
                         electronic_energy=e0, T=temperature,
                         pressure=pressure, multiplicity=s)
    outputs = write_vib_outputs(common.rank_dir(out_dir), struct, vib, th,
                                max_write_modes=max_write_modes,
                                amplitude_ang=amplitude_ang,
                                n_frames=n_frames, sort_modes=sort_modes)
    if verbose:
        n_imag = int((vib.freqs_cm < 0).sum())
        print(f"[freq] {len(vib.freqs_cm)} modes, {n_imag} imaginary; "
              f"ZPE = {th.zpe:.6f} Ha, G = {th.gibbs:.8f} Ha")
        print(f"[freq] elapsed {format_elapsed(t0)}")
    return {"freqs_cm": vib.freqs_cm, "modes_cart": vib.modes_cart,
            "thermo": th, "energy": e0, "hessian": H, "outputs": outputs,
            "structure": struct, "calculator": calc}
