"""IRC from a transition state (``irc`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/irc.py``: EulerPC over both
branches in Cartesian coordinates (another ``coord_type`` is ignored
with a note, as in the JAX package), the freeze list forwarded to the
calculator, and ``finished_irc.trj`` (backward reversed, the TS,
forward), ``forward_irc.trj``, ``backward_irc.trj`` and ``irc_data.npz``
(each branch's coordinates, energies, gradients and convergence, and the
TS) written under ``out_dir``. ``mesh`` splits the TS Hessian's
tangents over its data axis, ``spatial=n`` shards every evaluation over
n ranks; over several ranks rank 0 writes ``out_dir``
(``common.rank_dir``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..engines.irc import IRC_KW, eulerpc_irc
from ..mlip.calculator import Calculator
from ..runtime.checkpoint import CheckpointStore
from . import common
from .config import format_elapsed, pretty_block

# calculator options run_irc forwards to the calculator factory
_CALC_KEYS = ("hessian_calc_mode", "fd_step", "max_neigh", "radius", "seed",
              "checkpoint", "spatial")


def run_irc(
    input_path,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    coord_type: str = "cart",
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_irc/",
    verbose: bool = True,
    dump_restart: int = 0,
    calculator: Optional[Calculator] = None,
    **irc_kw,
) -> Dict[str, Any]:
    """Both IRC branches from the TS in ``input_path``. Keys of
    ``IRC_KW`` among ``irc_kw`` go to the engine, calculator options to
    the factory; ``calculator`` reuses a prepared calculator for that
    structure (its freeze list wins). ``dump_restart=N`` dumps each
    branch's carry every N cycles under ``out_dir/restart``."""
    t0 = time.time()
    out = common.rank_dir(out_dir)
    if coord_type != "cart":
        print(f"[irc] coord_type={coord_type!r} ignored: EulerPC runs "
              "Cartesian")
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    if calculator is not None:
        freeze = list(calculator.structure.freeze or [])
    else:
        freeze = common.merge_freeze(
            struct, [common.resolve_atom_spec(f, struct)
                     for f in freeze_atoms], auto_freeze_links)
    struct.freeze = freeze
    kw = {**IRC_KW, **{k: v for k, v in irc_kw.items() if k in IRC_KW}}
    calc = calculator or common.make_calculator(
        struct, calc_mode=calc_mode, charge=q, spin=s, freeze_atoms=freeze,
        model=model, device=device, mesh=mesh,
        **{k: v for k, v in irc_kw.items() if k in _CALC_KEYS})
    if verbose:
        print(pretty_block("irc", {**kw, "charge": q, "spin": s,
                                   "calc_mode": calc_mode, "model": model,
                                   "device": str(calc.device)}))
    if dump_restart:
        kw["restart"] = {
            "store": CheckpointStore(out / "restart"),
            "name": "irc", "every": int(dump_restart)}
    res = eulerpc_irc(calc, calc.pad_bohr(struct.coords_bohr), **kw)

    out.mkdir(parents=True, exist_ok=True)
    # finished = backward reversed + TS + forward
    frames, energies = [], []
    if res.backward:
        frames.extend(reversed(res.backward.coords))
        energies.extend(reversed(res.backward.energies))
    frames.append(res.ts_coords)
    energies.append(res.ts_energy)
    if res.forward:
        frames.extend(res.forward.coords)
        energies.extend(res.forward.energies)
    paths = common.write_trajectory(out, "finished_irc", struct, frames,
                                    energies)
    for name, br in (("forward", res.forward), ("backward", res.backward)):
        if br:
            paths += common.write_trajectory(out, f"{name}_irc", struct,
                                             br.coords, br.energies)
    data = {"ts_coords": res.ts_coords, "ts_energy": res.ts_energy}
    for name, br in (("forward", res.forward), ("backward", res.backward)):
        if br:
            data[f"{name}_coords"] = np.stack(br.coords)
            data[f"{name}_energies"] = np.asarray(br.energies)
            data[f"{name}_gradients"] = np.stack(br.gradients)
            data[f"{name}_converged"] = np.asarray(br.converged)
    np.savez_compressed(out / "irc_data.npz", **data)
    paths.append(out / "irc_data.npz")
    if verbose:
        nf = len(res.forward.coords) if res.forward else 0
        nb = len(res.backward.coords) if res.backward else 0
        print(f"[irc] forward {nf} steps, backward {nb} steps; "
              f"{calc.force_calls} force calls")
        print(f"[irc] elapsed {format_elapsed(t0)}")
    return {"result": res, "outputs": paths, "structure": struct,
            "calculator": calc, "frames_bohr": frames,
            "energies": energies, "force_calls": calc.force_calls}
