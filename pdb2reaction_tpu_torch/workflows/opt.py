"""Single-structure geometry optimization (``opt`` subcommand), L-BFGS in
Cartesian coordinates.

RFO, delocalized internals, harmonic bias and distance-freeze restraints
are later port items and raise here.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..engines.lbfgs import lbfgs_minimize
from ..mlip.calculator import Calculator
from . import common
from .config import format_elapsed, normalize_choice, pretty_block

OPT_MODES = ("lbfgs", "rfo")
_LATER = "a later port item (ROADMAP.md queue 1 items 9 and 13)"


def optimize_structure(struct, calc: Calculator, *, opt_mode: str = "lbfgs",
                       coord_type: str = "cart", thresh: str = "gau",
                       max_cycles: int = 10000, max_step_lbfgs: float = 0.30,
                       callback=None, **engine_kw):
    """Minimize with a prepared calculator; returns
    (coords_bohr [N,3], energy, converged, cycles)."""
    if opt_mode != "lbfgs" or coord_type != "cart":
        raise NotImplementedError(
            f"opt_mode={opt_mode!r}, coord_type={coord_type!r}: {_LATER}")
    x0 = calc.pad_bohr(struct.coords_bohr)
    res = lbfgs_minimize(calc.au_energy_force_fn(), x0,
                         calc.system.free_mask, thresh=thresh,
                         max_cycles=max_cycles, max_step=max_step_lbfgs,
                         callback=callback, **engine_kw)
    return calc.unpad(res.x), float(res.e), bool(res.converged), \
        int(res.cycles)


def run_opt(
    input_path,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    opt_mode: str = "lbfgs",
    coord_type: str = "cart",
    thresh: str = "gau",
    max_cycles: int = 10000,
    freeze_atoms: Sequence = (),
    calc_mode: str = "uma",
    model: str = "escn-md",
    device="cuda",
    out_dir="./result_opt/",
    verbose: bool = True,
    calc: Optional[Calculator] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """Optimize the structure in ``input_path`` and write
    ``final_geometry.xyz`` under ``out_dir``. ``calc`` reuses a prepared
    calculator for that structure (weights, device) instead of building
    one from ``model``."""
    t0 = time.time()
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    freeze = common.merge_freeze(struct, [int(i) for i in freeze_atoms])
    struct.freeze = freeze
    opt_mode = normalize_choice(opt_mode, choices=OPT_MODES)
    engine_keys = {"keep_last", "beta", "gamma_mult", "line_search",
                   "max_step_lbfgs"}
    engine_kw = {k: calc_kw.pop(k) for k in list(calc_kw)
                 if k in engine_keys}
    if calc is None:
        calc = common.make_calculator(struct, calc_mode=calc_mode, charge=q,
                                      spin=s, freeze_atoms=freeze,
                                      model=model, device=device, **calc_kw)
    if verbose:
        print(pretty_block("opt", {
            "opt_mode": opt_mode, "coord_type": coord_type,
            "thresh": thresh, "max_cycles": max_cycles, "charge": q,
            "spin": s, "calc_mode": calc_mode, "model": model,
            "device": str(calc.device), "freeze_atoms": list(freeze)}))

    def cb(cyc, e, f):
        if verbose:
            print(f"[opt] cycle {cyc}: E = {e:.8f} Ha, "
                  f"max|F| = {np.abs(f).max():.2e}")

    calls0 = calc.force_calls
    coords, e, conv, cycles = optimize_structure(
        struct, calc, opt_mode=opt_mode, coord_type=coord_type,
        thresh=thresh, max_cycles=max_cycles, callback=cb, **engine_kw)
    paths = common.write_outputs(Path(out_dir), "final_geometry", struct,
                                 coords, energy=e)
    if verbose:
        print(f"[opt] {'converged' if conv else 'NOT converged'} in "
              f"{cycles} cycles; E = {e:.8f} Ha; "
              f"{calc.force_calls - calls0} force calls")
        print(f"[opt] wrote {[str(p) for p in paths]}")
        print(f"[opt] elapsed {format_elapsed(t0)}")
    return {
        "coords_bohr": np.asarray(coords),
        "energy": e, "converged": conv, "cycles": cycles,
        "force_calls": calc.force_calls - calls0, "outputs": paths,
        "structure": struct, "calculator": calc,
        "weights": calc.weights_source,
    }
