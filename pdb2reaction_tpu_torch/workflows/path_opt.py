"""Two-endpoint MEP workflow (``path-opt`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/path_opt.py``: the GSM string
(``mep_mode="gsm"``) or Direct Max Flux (``"dmf"``, ``engines/dmf.py``;
``dmf_kw`` or the keys of ``DMF_KW`` among the options) between two
endpoints, with optional per-endpoint preoptimization (L-BFGS or RFO),
freeze-guided Kabsch alignment before the MEP, the highest energy image
preferring internal maxima, and the trajectory and HEI written as
``final_geometries.trj`` and ``hei.xyz``.

``mesh`` splits the string's image batches over its data axis;
``spatial=n`` shards every evaluation, the climbing image's HVPs
included, over n ranks (``mlip/uma.py``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..bio.align import align_sequence_inplace
from ..constants import AU2KCALPERMOL, BOHR2ANG
from ..engines.dmf import DMF_KW, dmf_mep
from ..engines.gsm import GS_KW, STOPT_KW, gsm_mep
from ..engines.thresholds import get_thresholds
from . import common
from .config import format_elapsed, normalize_choice, pretty_block
from .opt import optimize_structure


def run_mep_between(
    structA, structB, calc, *, mep_mode: str = "gsm",
    gs_kw: Optional[Dict[str, Any]] = None,
    stopt_kw: Optional[Dict[str, Any]] = None,
    dmf_kw: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
):
    """One MEP segment between two aligned structures on a shared
    calculator; returns the ``GsmResult`` (or the ``DmfResult`` with
    ``mep_mode="dmf"``). The calculator's batched closure counts every
    image evaluation itself, so its ``force_calls`` rises by exactly
    ``res.force_calls`` here (the JAX package adds the engine's count
    afterwards instead). ``gs_kw``'s ``loop`` picks the GSM loop:
    ``"device"``, ``"host"`` or ``"auto"`` (the default), the calculator's
    ``gsm_loop_default``, as in the JAX package; on CUDA ``"auto"`` takes
    the host loop where the calculator's closures are collective (the
    device loop cannot capture them), and says so."""
    if mep_mode == "dmf":
        return dmf_mep(calc, calc.pad_bohr(structA.coords_bohr),
                       calc.pad_bohr(structB.coords_bohr),
                       verbose=verbose, **(dmf_kw or {}))
    kw = {**GS_KW, **(gs_kw or {})}
    skw = {**STOPT_KW, **(stopt_kw or {})}
    lanczos = bool(kw["climb"]) and bool(kw.get("climb_lanczos", True))
    eb = calc.au_energy_force_batch_fn()
    hvp = calc.au_hvp_fn() if lanczos else None
    loop = kw.get("loop", "auto")
    if loop == "auto":
        loop = getattr(calc, "gsm_loop_default", "device")
        if loop == "device" and str(getattr(calc, "device", "cpu")) \
                .startswith("cuda") and any(
                getattr(f, "collective", False) for f in (eb, hvp)):
            loop = "host"
            if verbose:
                print("[gsm] loop='auto': the host loop, as this "
                      "calculator's collectives (sharding, tensor-parallel "
                      "parameters or a data axis) cannot be captured in a "
                      "CUDA graph")

    def cb(cyc, E, rms, grown, climb):
        if verbose:
            print(f"[gsm] cycle {cyc}: grown {grown}, rms(F_perp) = "
                  f"{rms:.2e}, climb = {climb}")

    return gsm_mep(
        eb,
        calc.pad_bohr(structA.coords_bohr),
        calc.pad_bohr(structB.coords_bohr),
        calc.system.free_mask,
        max_nodes=kw["max_nodes"], perp_thresh=kw["perp_thresh"],
        max_cycles=skw["max_cycles"],
        stop_in_when_full=skw["stop_in_when_full"],
        scale_step=skw.get("scale_step", "global"),
        climb=kw["climb"], climb_rms=kw["climb_rms"],
        climb_lanczos=lanczos,
        fix_ends=bool(kw.get("fix_ends",
                             kw.get("fix_first", True)
                             and kw.get("fix_last", True))),
        hvp_fn=hvp,
        reparam_every=kw["reparam_every"],
        reparam_every_full=kw["reparam_every_full"],
        max_micro_cycles=kw.get("max_micro_cycles", 10),
        callback=cb if verbose else None,
        print_every=skw.get("print_every", 10),
        loop=loop,
    )


def route_engine_keys(calc_kw, mep_mode, tables, dmf_kw) -> None:
    """Move the engine keys among ``calc_kw`` (``--args-yaml`` sections
    arrive flat) into their dicts: the first of ``tables`` (pairs of a
    key table and its dict) that has a key takes it, and ``DMF_KW``
    comes after them, as in the JAX package, except under
    ``mep_mode="dmf"``, where it comes first: the ``dmf:`` section's
    ``max_cycles`` then caps DMF, not the string that does not run."""
    order = list(tables)
    order.insert(0 if mep_mode == "dmf" else len(order), (DMF_KW, dmf_kw))
    for k in list(calc_kw):
        for table, dst in order:
            if k in table:
                dst[k] = calc_kw.pop(k)
                break


def run_path_opt(
    input_paths: Sequence,                # two endpoint files
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    mep_mode: str = "gsm",
    preopt: bool = True,
    preopt_mode: str = "lbfgs",
    preopt_thresh: str = "gau_loose",
    preopt_max_cycles: int = 10000,
    thresh: Optional[str] = None,
    align: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_path_opt/",
    verbose: bool = True,
    gs_kw: Optional[Dict[str, Any]] = None,
    stopt_kw: Optional[Dict[str, Any]] = None,
    dmf_kw: Optional[Dict[str, Any]] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """GSM or DMF between the two endpoint files; writes
    ``final_geometries.trj`` and ``hei.xyz`` under ``out_dir``.
    ``thresh`` (a preset name) sets the string's perpendicular-force
    criteria and the endpoint preoptimization's threshold.
    ``auto_freeze_links`` freezes the parents of a PDB input's link
    hydrogens. Over several ranks rank 0 writes ``out_dir``
    (``common.rank_dir``)."""
    t0 = time.time()
    assert len(input_paths) == 2, "path-opt needs exactly two endpoints"
    mep_mode = normalize_choice(mep_mode, choices=("gsm", "dmf"))
    preopt_mode = normalize_choice(preopt_mode, choices=("lbfgs", "rfo"))
    gs_kw = dict(gs_kw or {})
    stopt_kw = dict(stopt_kw or {})
    dmf_kw = dict(dmf_kw or {})
    route_engine_keys(calc_kw, mep_mode, ((GS_KW, gs_kw),
                                          (STOPT_KW, stopt_kw)), dmf_kw)
    if thresh is not None:
        # one preset drives the string's perpendicular-force criteria and
        # the endpoint preoptimizations
        preset = get_thresholds(str(thresh))
        rms = float(preset.rms_force)
        if not math.isfinite(rms):          # baker: rms unchecked
            rms = float(preset.max_force)
        gs_kw.setdefault("perp_thresh", rms)
        gs_kw.setdefault("climb_rms", rms)
        gs_kw.setdefault("climb_lanczos_rms", rms)
        preopt_thresh = str(thresh)
    structs = [common.load_structure(p) for p in input_paths]
    q, s = common.resolve_charge_spin(structs[0], charge, spin)
    for st in structs:
        st.freeze = common.merge_freeze(
            st, [common.resolve_atom_spec(f, st) for f in freeze_atoms],
            auto_freeze_links)
    A, B = structs
    if A.n_atoms != B.n_atoms or list(A.numbers) != list(B.numbers):
        raise ValueError("Endpoints must share atom count and ordering")

    calc = common.make_calculator(A, calc_mode=calc_mode, charge=q, spin=s,
                                  freeze_atoms=A.freeze, model=model,
                                  device=device, mesh=mesh, **calc_kw)
    if verbose:
        print(pretty_block("path-opt", {
            "mep_mode": mep_mode, "preopt": preopt, "align": align,
            "charge": q, "spin": s, "calc_mode": calc_mode,
            "model": model, "device": str(calc.device), "gs": gs_kw,
            "sopt": stopt_kw, "dmf": dmf_kw}))
    if preopt:
        for st in structs:
            coords, e, conv, cyc = optimize_structure(
                st, calc, opt_mode=preopt_mode, thresh=preopt_thresh,
                max_cycles=preopt_max_cycles)
            st.coords = coords * BOHR2ANG
            if verbose:
                print(f"[path-opt] preopt endpoint: E = {e:.6f} Ha "
                      f"({'conv' if conv else 'max cycles'})")
    if align:
        align_sequence_inplace(structs)

    res = run_mep_between(A, B, calc, mep_mode=mep_mode, gs_kw=gs_kw,
                          stopt_kw=stopt_kw, dmf_kw=dmf_kw, verbose=verbose)

    out = common.rank_dir(out_dir)
    n = calc.n_atoms
    frames = [img[:n] for img in res.images]
    hei = res.hei_idx
    paths = common.write_trajectory(out, "final_geometries", A, frames,
                                    res.energies)
    paths += common.write_outputs(out, "hei", A, frames[hei],
                                  energy=res.energies[hei])
    if verbose:
        Erel = (res.energies - res.energies[0]) * AU2KCALPERMOL
        print(f"[path-opt] HEI = image {hei}; barrier = "
              f"{Erel[hei]:.2f} kcal/mol; converged = {res.converged}; "
              f"{res.cycles} cycles, {res.force_calls} "
              f"{mep_mode.upper()} force calls")
        print(f"[path-opt] elapsed {format_elapsed(t0)}")
    return {"images_bohr": frames, "energies": np.asarray(res.energies),
            "hei_idx": hei, "converged": res.converged,
            "cycles": res.cycles, "mep_force_calls": res.force_calls,
            "outputs": paths, "structures": structs, "calculator": calc,
            "force_calls": calc.force_calls}
