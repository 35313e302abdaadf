"""Single-structure geometry optimization (``opt`` subcommand): L-BFGS
("light") or RFO from an exact Hessian ("heavy") in Cartesian
coordinates, or L-BFGS in delocalized internals (``coord_type="dlc"``,
``engines/dlc.py``, whatever the mode, as in the JAX package; frozen
atoms run constrained delocalization), optionally under harmonic
distance restraints (``bias_pairs`` at given targets, ``dist_freeze`` at
the input's distances; ``engines/bias.py``). ``dump`` writes the start
and end geometries as ``opt.trj``; ``dump_restart=N`` dumps the L-BFGS
carry every N cycles under ``restart/`` and a rerun resumes from it
(Cartesian L-BFGS only, as in the JAX package).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engines.bias import biased_calculator, dist_freeze_pairs
from ..engines.dlc import dlc_lbfgs_minimize
from ..engines.lbfgs import lbfgs_minimize
from ..engines.rfo import RFO_KW, rfo_optimize
from ..mlip.calculator import Calculator
from ..parallel.distributed import is_main_rank
from . import common
from .config import format_elapsed, normalize_choice, pretty_block

OPT_MODES = ("lbfgs", "rfo")
COORD_TYPES = ("cart", "dlc")


def optimize_structure(struct, calc: Calculator, *, opt_mode: str = "lbfgs",
                       coord_type: str = "cart", thresh: str = "gau",
                       max_cycles: int = 10000, max_step_lbfgs: float = 0.30,
                       trust_radius: float = 0.10, callback=None,
                       **engine_kw):
    """Minimize with a prepared calculator; returns
    (coords_bohr [N,3], energy, converged, cycles). ``opt_mode="rfo"``
    starts from the exact Hessian at the input geometry;
    ``coord_type="dlc"`` runs DLC L-BFGS whatever ``opt_mode`` is."""
    coord_type = normalize_choice(coord_type, choices=COORD_TYPES)
    x0 = calc.pad_bohr(struct.coords_bohr)
    if coord_type == "dlc":
        res = dlc_lbfgs_minimize(calc.au_energy_force_fn(), x0,
                                 struct.numbers, calc.n_atoms,
                                 freeze=struct.freeze, thresh=thresh,
                                 max_cycles=max_cycles, callback=callback,
                                 **engine_kw)
    elif opt_mode == "rfo":
        H0 = calc.get_hessian(struct.coords_bohr.reshape(-1))["hessian"]
        res = rfo_optimize(calc.au_energy_force_fn(), x0,
                           calc.system.free_mask, calc.n_atoms, hessian0=H0,
                           thresh=thresh, max_cycles=max_cycles,
                           trust_radius=trust_radius, callback=callback,
                           **engine_kw)
    else:
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
    auto_freeze_links: bool = True,
    bias_pairs: Optional[List[Tuple[Any, Any, float]]] = None,
    bias_k: float = 10.0,
    dist_freeze: Optional[List[Tuple[Any, Any]]] = None,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_opt/",
    convert_files: bool = True,
    dump: bool = False,
    dump_restart: int = 0,
    verbose: bool = True,
    calc: Optional[Calculator] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """Optimize the structure in ``input_path`` and write
    ``final_geometry.xyz`` (and its .pdb / .gjf companions) under
    ``out_dir``. ``calc`` reuses a prepared calculator for that structure
    (weights, device) instead of building one from ``model``.
    ``bias_pairs`` (i, j, target Angstrom) and ``dist_freeze`` (i, j, held
    at the input's distance) add harmonic restraints of ``bias_k``
    eV/Angstrom^2; atoms may be indices or 'RES SEQ NAME' selectors.
    Over several ranks (``spatial=n`` in ``calc_kw``, a sharded ``calc``,
    or a ``mesh``, whose data axis splits the RFO Hessian's tangents)
    every rank runs the same loop on the same forces, and rank 0 alone
    logs and writes ``out_dir``; the restart dumps of the other ranks go
    to their scratch trees (``common.rank_dir``)."""
    t0 = time.time()
    writer = is_main_rank()
    verbose = verbose and writer
    common.set_convert_enabled(convert_files)
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    freeze = common.merge_freeze(
        struct, [common.resolve_atom_spec(f, struct) for f in freeze_atoms],
        auto_freeze_links)
    struct.freeze = freeze
    pairs, targets = [], []
    for (i, j, t) in bias_pairs or ():
        pairs.append((common.resolve_atom_spec(i, struct),
                      common.resolve_atom_spec(j, struct)))
        targets.append(float(t))
    if dist_freeze:
        df_pairs = [(common.resolve_atom_spec(i, struct),
                     common.resolve_atom_spec(j, struct))
                    for (i, j) in dist_freeze]
        pairs.extend(df_pairs)
        targets.extend(dist_freeze_pairs(struct.coords, df_pairs))
    opt_mode = normalize_choice(opt_mode, choices=OPT_MODES)
    engine_keys = (set(RFO_KW) - {"thresh", "max_cycles"}) | {
        "keep_last", "beta", "gamma_mult", "max_step_lbfgs", "trust_radius",
        "gdiis", "gdiis_thresh"}
    engine_kw = {k: calc_kw.pop(k) for k in list(calc_kw)
                 if k in engine_keys}
    if calc is None:
        calc = common.make_calculator(struct, calc_mode=calc_mode, charge=q,
                                      spin=s, freeze_atoms=freeze,
                                      model=model, device=device, mesh=mesh,
                                      **calc_kw)
    if pairs:
        calc = biased_calculator(calc, pairs, targets, bias_k)
    if verbose:
        print(pretty_block("opt", {
            "opt_mode": opt_mode, "coord_type": coord_type,
            "thresh": thresh, "max_cycles": max_cycles, "charge": q,
            "spin": s, "calc_mode": calc_mode, "model": model,
            "device": str(calc.device), "freeze_atoms": list(freeze),
            "dist_freeze": dist_freeze, "bias_k": bias_k}))

    def cb(cyc, e, f):
        if verbose:
            print(f"[opt] cycle {cyc}: E = {e:.8f} Ha, "
                  f"max|F| = {np.abs(f).max():.2e}")

    if dump_restart and opt_mode == "lbfgs" and coord_type == "cart":
        from ..runtime.checkpoint import CheckpointStore
        engine_kw["restart"] = {
            "store": CheckpointStore(common.rank_dir(out_dir) / "restart"),
            "name": "opt", "every": int(dump_restart)}
    calls0 = calc.force_calls
    coords, e, conv, cycles = optimize_structure(
        struct, calc, opt_mode=opt_mode, coord_type=coord_type,
        thresh=thresh, max_cycles=max_cycles, callback=cb, **engine_kw)
    paths = (common.write_outputs(Path(out_dir), "final_geometry", struct,
                                  coords, energy=e) if writer else [])
    if dump and writer:
        paths += common.write_trajectory(
            Path(out_dir), "opt", struct,
            [struct.coords_bohr, np.asarray(coords)])
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
