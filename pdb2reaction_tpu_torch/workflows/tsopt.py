"""Transition-state optimization (``tsopt`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/tsopt.py``, two modes:
"light" (the Hessian dimer: dimer translations from a Hessian-seeded
orientation, then the flatten loop) and "heavy" (RS-I-RFO, uphill mode
following from an exact Hessian, refreshed every ``hessian_recalc``
cycles); the TS mode's animation is written as ``imag_mode.trj``.
``coord_type="dlc"`` runs the heavy mode in constrained delocalized
internals (``engines/dlc.py``); the light mode runs Cartesian whatever it
is given, as in the JAX package.

``mesh`` splits the Hessians' tangents and the dimer's batches over its
data axis, ``spatial=n`` shards every evaluation, Hessians included,
over n ranks; over several ranks rank 0 writes ``out_dir``
(``common.rank_dir``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..constants import BOHR2ANG
from ..core import io_xyz
from ..engines.dimer import HESSIAN_DIMER_KW, hessian_dimer
from ..engines.dlc import dlc_rfo_optimize
from ..engines.rfo import RSIRFO_KW, rfo_optimize
from ..engines.vib import (count_imaginary, free_block_wavenumbers,
                           frequencies_and_modes, mode_animation_frames)
from ..mlip.calculator import Calculator
from ..runtime.checkpoint import CheckpointStore
from . import common
from .config import format_elapsed, pretty_block

TS_MODES = ("dimer", "rsirfo")
_TS_ALIASES = {"light": "dimer", "heavy": "rsirfo", "rs-i-rfo": "rsirfo",
               "hessian_dimer": "dimer"}
# the engine knobs the heavy mode hands to rfo_optimize / dlc_rfo_optimize
_RSIRFO_ENGINE = ("roots", "thresh", "trust_radius", "trust_max",
                  "trust_min", "hessian_update", "hessian_recalc",
                  "small_eigval_thresh")


def run_tsopt(
    input_path,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    opt_mode: str = "dimer",
    coord_type: str = "cart",
    thresh: str = "baker",
    max_cycles: int = 10000,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_tsopt/",
    verbose: bool = True,
    hessian_dimer_kw: Optional[Dict[str, Any]] = None,
    rsirfo_kw: Optional[Dict[str, Any]] = None,
    write_imag_mode: bool = True,
    dump_restart: int = 0,
    calculator: Optional[Calculator] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """Refine the TS guess in ``input_path``; writes
    ``final_geometry.xyz`` and ``imag_mode.trj`` under ``out_dir``.
    ``calculator`` reuses a prepared calculator for that structure (its
    freeze list wins). Keys of ``HESSIAN_DIMER_KW`` / ``RSIRFO_KW`` among
    ``calc_kw`` go to the engines. ``dump_restart=N`` makes the light mode
    restartable from ``out_dir/restart`` (carries dumped every N
    cycles)."""
    t0 = time.time()
    out = common.rank_dir(out_dir)
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    if calculator is not None:
        freeze = list(calculator.structure.freeze or [])
    else:
        freeze = common.merge_freeze(
            struct, [common.resolve_atom_spec(f, struct)
                     for f in freeze_atoms], auto_freeze_links)
    struct.freeze = freeze
    mode = str(opt_mode).strip().lower()
    mode = _TS_ALIASES.get(mode, mode)
    if mode not in TS_MODES:
        raise ValueError(f"Invalid opt_mode {opt_mode!r}; allowed: "
                         f"{sorted(TS_MODES + tuple(_TS_ALIASES))}")
    if coord_type == "dlc" and mode == "dimer":
        print("[tsopt] coord_type=dlc applies to the rsirfo mode only; "
              "dimer runs Cartesian")
        coord_type = "cart"
    hessian_dimer_kw = dict(hessian_dimer_kw or {})
    rsirfo_kw = dict(rsirfo_kw or {})
    for k in list(calc_kw):
        if k in HESSIAN_DIMER_KW:
            hessian_dimer_kw.setdefault(k, calc_kw.pop(k))
        elif k in RSIRFO_KW:
            rsirfo_kw.setdefault(k, calc_kw.pop(k))
    calc = calculator or common.make_calculator(
        struct, calc_mode=calc_mode, charge=q, spin=s, freeze_atoms=freeze,
        model=model, device=device, mesh=mesh, **calc_kw)
    if struct.n_atoms != calc.n_atoms:
        raise ValueError(f"calculator atom count {calc.n_atoms} != input "
                         f"{struct.n_atoms} ({input_path})")
    x0 = calc.pad_bohr(struct.coords_bohr)
    if verbose:
        print(pretty_block("tsopt", {
            "opt_mode": mode, "coord_type": coord_type, "thresh": thresh,
            "max_cycles": max_cycles, "charge": q, "spin": s,
            "calc_mode": calc_mode, "model": model,
            "device": str(calc.device), "hessian_dimer": hessian_dimer_kw,
            "rsirfo": rsirfo_kw}))

    if mode == "dimer":
        kw = {**HESSIAN_DIMER_KW, **hessian_dimer_kw}
        kw["thresh"] = thresh if thresh != "gau" else kw["thresh"]
        # an explicit engine-level budget wins over the workflow default
        if "max_cycles_total" not in hessian_dimer_kw:
            kw["max_cycles_total"] = max_cycles
        if dump_restart:
            kw["restart"] = {
                "store": CheckpointStore(out / "restart"),
                "name": "tsopt", "every": int(dump_restart)}
        res = hessian_dimer(calc, x0, **kw)
        coords, e, conv, cycles = (calc.unpad(res.x), res.e, res.converged,
                                   res.cycles)
        freqs, imode, n_imag = res.freqs_cm, res.imag_mode_cart, res.n_imag
    else:
        kw = {**RSIRFO_KW, **rsirfo_kw}
        kw["thresh"] = thresh or kw["thresh"]
        H0 = calc.get_hessian(struct.coords_bohr.reshape(-1))["hessian"]

        def hess_fn(xp):
            return calc.get_hessian(calc.unpad(xp).reshape(-1))["hessian"]

        eng_kw = {k: v for k, v in kw.items() if k in _RSIRFO_ENGINE}
        if coord_type == "dlc":
            r = dlc_rfo_optimize(calc.au_energy_force_fn(), x0,
                                 struct.numbers, calc.n_atoms,
                                 freeze=freeze, hessian0=H0, mode="ts",
                                 max_cycles=max_cycles, hessian_fn=hess_fn,
                                 **eng_kw)
        else:
            r = rfo_optimize(calc.au_energy_force_fn(), x0,
                             calc.system.free_mask, calc.n_atoms,
                             hessian0=H0, mode="ts", max_cycles=max_cycles,
                             hessian_fn=hess_fn, **eng_kw)
        coords, e, conv, cycles = calc.unpad(r.x), r.e, r.converged, r.cycles
        H = calc.get_hessian(coords.reshape(-1))["hessian"]
        vib = frequencies_and_modes(H, struct.numbers, coords, freeze)
        freqs = vib.freqs_cm
        imode = (vib.modes_cart[int(np.argmin(freqs))]
                 if len(freqs) else None)
        if len(freqs) == 0 and freeze:
            # PHVA's in-subspace TR projection can annihilate every mode
            # of a tiny active space: the unprojected free block instead
            freqs, imode = free_block_wavenumbers(H, struct.numbers, freeze)
        n_imag = count_imaginary(freqs)

    paths = common.write_outputs(out, "final_geometry", struct, coords,
                                 energy=e)
    if write_imag_mode and imode is not None:
        frames = mode_animation_frames(coords * BOHR2ANG, imode)
        trj = out / "imag_mode.trj"
        io_xyz.write_trj(trj, [struct.copy(coords=f) for f in frames])
        paths.append(trj)
    if verbose:
        print(f"[tsopt:{mode}] {'converged' if conv else 'NOT converged'} "
              f"in {cycles} cycles; E = {e:.8f} Ha; "
              f"{n_imag} imaginary mode(s); {calc.force_calls} force calls")
        if len(freqs):
            print(f"[tsopt] lowest mode: {np.min(freqs):.1f} cm-1")
        print(f"[tsopt] elapsed {format_elapsed(t0)}")
    return {"coords_bohr": coords, "energy": e, "converged": conv,
            "cycles": cycles, "freqs_cm": freqs, "n_imag": n_imag,
            "imag_mode_cart": imode, "outputs": paths,
            "structure": struct, "calculator": calc,
            "force_calls": calc.force_calls}
