"""End-to-end pipeline (``all`` subcommand, the CLI's default).

Counterpart of ``pdb2reaction_tpu/workflows/allflow.py``, with its stage
layout under ``out_dir``:

- preflight: a PDB input without valid element columns is repaired into
  ``elem_fixed_<name>.pdb`` (``bio/add_elem.py``);
- stage 1, ``stage1_extract/pocket_<stem>.pdb``: the pocket around
  ``center`` for PDB inputs (``bio/extract.py``, radius queries on the
  calculator's device); its total charge, rounded, is the workflow's
  charge when none is given;
- stage 1b, ``stage1b_scan/`` for one input with ``scan_stages``: the
  staged scan (``workflows/scan.py``, preopt and endopt on unless
  ``scan_kw`` says otherwise) of the input (its pocket, the stages'
  full-structure indices remapped onto it), whose result
  ``scan_product.xyz`` becomes the second endpoint of stage 2;
- stage 2, ``stage2_path/``: the recursive path search
  (``workflows/path_search.py``; GSM segments, or DMF ones with
  ``mep_mode="dmf"``) over the pockets, with the inputs as the
  full-system templates of the merge (or ``full_template``);
- stage 3, ``stage3_merged/``: copies of the merged full-system PDBs;
- stage 4, ``stage4_seg_NNN/`` for each reactive segment when ``tsopt``
  or ``do_freq`` is on: the TS refined from the HEI (``hei_guess.xyz``,
  ``tsopt/``, ``ts_final.xyz``; RS-I-RFO for the default post mode), the
  endpoints re-minimized under tsopt (``reactant_opt.xyz``,
  ``product_opt.xyz``), the IRC from the TS with its endpoints matched
  to the minima (``irc.trj``), and frequencies with thermochemistry of
  R, TS and P (``freq/{reactant,ts,product}/``); a failed tsopt, IRC or
  freq of a segment goes into its summary entry as ``{"error": ...}``
  and the run goes on, as in the JAX package; with ``do_dft`` the DFT
  single points of R, TS and P (``workflows/dft.py``; ``dft_kw``, under
  ``dft_<tag>/``), a missing engine kept as ``{"skipped": ...}``, any
  other failure as ``{"error": ...}``;
- ``summary.yaml`` (JSON, which YAML readers take), ``summary.log`` and
  the diagrams (PNGs only where matplotlib is installed).

A single input without scan stages runs the TSOPT-only mode with
``tsopt``. One calculator, built by the path search, serves stages 2 to
4 (the scan builds its own). ``ForceCallMeter`` phases time every stage
with its force and energy calls (``results["force_call_phases"]``; the
scan's calls are booked in its phase). ``mesh`` splits the image
batches, Hessian tangents and FD displacements of every stage over its
data axis, ``spatial=n`` shards every evaluation over n ranks; over
several ranks rank 0 writes ``out_dir`` and every other rank the same
tree in its scratch directory, so the stages' hand-offs read back alike
(``common.rank_dir``).
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..bio.add_elem import assign_elements, pdb_needs_elem_fix
from ..bio.align import rmsd
from ..bio.bonds import compare_structures
from ..bio.extract import extract_api
from ..bio.merge import remap_indices
from ..constants import BOHR2ANG
from ..core import io_pdb, io_xyz
from ..engines.gsm import GS_KW
from ..engines.irc import eulerpc_irc
from ..engines.thermo import thermochemistry
from ..engines.vib import frequencies_and_modes
from ..runtime.profiling import ForceCallMeter
from . import common
from .config import format_elapsed, normalize_choice, pretty_block
from .dft import run_dft
from .freq import run_freq, write_vib_outputs
from .irc import run_irc
from .opt import optimize_structure
from .path_search import SEARCH_KW, run_path_search, segments_summary
from .scan import run_scan
from .summary import (build_energy_diagram, build_irc_overview,
                      build_levels_diagram, compressed_diagram,
                      write_summary_log, write_summary_yaml)
from .trj2fig import plot_profile
from .tsopt import run_tsopt

def _resolve_override_dir(default: Path, override) -> Path:
    """A per-stage output override: absolute overrides are taken as they
    are (through ``common.rank_dir``, so each rank's hand-offs stay its
    own), relative ones resolve against the default's parent."""
    if override is None:
        return default
    override = Path(override)
    if override.is_absolute():
        return common.rank_dir(override)
    return default.parent / override


def _ts_mode(opt_post_kw) -> str:
    """The tsopt mode of the post-processing optimizer mode: heavy (rfo)
    is RS-I-RFO, light the Hessian dimer."""
    m = str(opt_post_kw.get("opt_mode", "rfo")).lower()
    return "rsirfo" if m in ("rfo", "rsirfo", "heavy") else "dimer"


def round_charge(value: float, verbose=True) -> int:
    """The extraction's pocket charge rounded to the workflow charge,
    with a note when it was not an integer."""
    q = int(round(value))
    if verbose and abs(value - q) > 1e-6:
        print(f"[all] NOTE: pocket charge {value} rounded to {q}")
    return q


def _png(what: str, draw, *args, **kw) -> None:
    """Draw one figure; without matplotlib it is skipped with a warning."""
    try:
        draw(*args, **kw)
    except ImportError as e:
        print(f"[all] WARNING: {what} skipped: {e}")


def run_all(
    input_paths: Sequence,
    *,
    center: Optional[str] = None,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    ligand_charge=None,
    scan_stages: Optional[Sequence] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    refine_path: bool = True,
    tsopt: bool = False,
    do_irc: bool = True,
    do_freq: bool = False,
    do_dft: bool = False,
    opt_mode: str = "light",
    thresh: Optional[str] = None,
    max_cycles: int = 300,
    preopt: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    mep_mode: str = "gsm",
    device="cuda",
    mesh=None,
    out_dir="./result_all/",
    verbose: bool = True,
    full_template=None,
    extract_kw: Optional[Dict[str, Any]] = None,
    search_kw: Optional[Dict[str, Any]] = None,
    gs_kw: Optional[Dict[str, Any]] = None,
    scan_kw: Optional[Dict[str, Any]] = None,
    opt_post_kw: Optional[Dict[str, Any]] = None,
    tsopt_kw: Optional[Dict[str, Any]] = None,
    irc_kw: Optional[Dict[str, Any]] = None,
    freq_kw: Optional[Dict[str, Any]] = None,
    dft_kw: Optional[Dict[str, Any]] = None,
    scan_out_dir=None,
    tsopt_out_dir=None,
    freq_out_dir=None,
    dft_out_dir=None,
    **calc_kw,
) -> Dict[str, Any]:
    """The pipeline over ``input_paths`` (two or more structures in
    reaction order, or one with ``scan_stages`` or ``tsopt``); see the
    module docstring. ``max_cycles`` caps each string's cycles;
    ``scan_kw`` goes to ``run_scan``; ``opt_post_kw`` (default RFO to
    the baker threshold) drives the stage-4 TS mode and endpoint
    minimizations (its ``max_cycles`` caps the latter); ``tsopt_kw``'s
    ``max_cycles_total`` caps tsopt; ``irc_kw`` goes to the IRC engine,
    ``dft_kw`` to ``run_dft``; ``gs_kw`` (its GSM ``loop`` included)
    reaches path-search's strings. Search and string keys may also come
    flat in ``calc_kw``."""
    t0 = time.time()
    mep_mode = normalize_choice(mep_mode, choices=("gsm", "dmf"))
    search_kw = dict(search_kw or {})
    gs_kw = dict(gs_kw or {})
    for k in list(calc_kw):
        for table, dst in ((SEARCH_KW, search_kw), (GS_KW, gs_kw)):
            if k in table:
                dst[k] = calc_kw.pop(k)
                break
    opt_post_kw = {"opt_mode": "rfo", "thresh": "baker",
                   **(opt_post_kw or {})}
    tsopt_kw = dict(tsopt_kw or {})
    irc_kw = dict(irc_kw or {})
    freq_kw = dict(freq_kw or {})
    dft_kw = dict(dft_kw or {})
    scan_kw = dict(scan_kw or {})
    input_paths = [Path(p) for p in input_paths]
    if len(input_paths) < 2 and not (
            len(input_paths) == 1 and (scan_stages or tsopt)):
        raise ValueError(
            "Provide at least two structures with -i/--input in reaction "
            "order, or use a single structure with --scan-lists, or a "
            "single structure with --tsopt True.")
    out = common.rank_dir(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    is_pdb = all(p.suffix.lower() == ".pdb" for p in input_paths)
    meter = ForceCallMeter()

    # ---- preflight: element repair -----------------------------------------
    with meter.phase("preflight"):
        fixed_inputs = []
        for p in input_paths:
            if p.suffix.lower() == ".pdb" and pdb_needs_elem_fix(p):
                fixed = out / f"elem_fixed_{p.name}"
                assign_elements(p, fixed, verbose=verbose)
                fixed_inputs.append(fixed)
            else:
                fixed_inputs.append(p)

    # ---- stage 1: extraction ------------------------------------------
    charge_summary = None
    full_templates = None
    work_inputs = fixed_inputs
    if center and is_pdb:
        with meter.phase("extract"):
            stage1 = out / "stage1_extract"
            stage1.mkdir(exist_ok=True)
            pockets = [stage1 / f"pocket_{p.stem}.pdb"
                       for p in fixed_inputs]
            res = extract_api(fixed_inputs, center, pockets,
                              ligand_charge=ligand_charge, verbose=verbose,
                              device=device, **(extract_kw or {}))
        charge_summary = res["charge_summary"]
        if charge is None:
            charge = round_charge(charge_summary["total_charge"], verbose)
        work_inputs = pockets
        full_templates = fixed_inputs
    if charge is None:
        raise ValueError("Charge is required (give -q or extract a pocket)")
    spin = spin or 1

    if verbose:
        print(pretty_block("all", {
            "inputs": [str(p) for p in input_paths], "center": center,
            "charge": charge, "spin": spin, "mep_mode": mep_mode,
            "refine_path": refine_path, "tsopt": tsopt, "irc": do_irc,
            "freq": do_freq, "dft": do_dft, "calc_mode": calc_mode,
            "model": model, "device": str(device),
            "scan_stages": scan_stages,
            "opt_mode": opt_mode, "thresh": thresh,
            "max_cycles": max_cycles, "preopt": preopt,
            "opt_mode_post": opt_post_kw["opt_mode"],
            "thresh_post": opt_post_kw["thresh"]}))
    results: Dict[str, Any] = {"charge": charge, "spin": spin,
                               "charge_summary": charge_summary}
    stage_kw = dict(charge=charge, spin=spin, calc_mode=calc_mode,
                    model=model, device=device, mesh=mesh, verbose=verbose)

    # ---- stage 1b: the staged scan makes the second endpoint ---------------
    scan_calls = (0, 0)
    if scan_stages and len(work_inputs) == 1:
        if full_templates is not None:
            full_atoms = io_pdb.parse_pdb_atoms(full_templates[0])
            pocket_atoms = io_pdb.parse_pdb_atoms(work_inputs[0])
            scan_stages = [
                [tuple(remap_indices([i, j], full_atoms, pocket_atoms))
                 + (t,) for (i, j, t) in stage] for stage in scan_stages]
        scan_dir = _resolve_override_dir(out / "stage1b_scan", scan_out_dir)
        with meter.phase("scan"):
            scan_res = run_scan(
                work_inputs[0], scan_stages, charge=charge, spin=spin,
                calc_mode=calc_mode, model=model, device=device, mesh=mesh,
                freeze_atoms=freeze_atoms,
                auto_freeze_links=auto_freeze_links, out_dir=scan_dir,
                verbose=verbose, **{"preopt": True, "endopt": True,
                                    **scan_kw, **calc_kw})
        scan_calls = (scan_res["force_calls"], scan_res["energy_calls"])
        meter.phases["scan"]["calls"] += scan_calls[0]
        meter.phases["scan"]["energy_calls"] += scan_calls[1]
        prod = scan_dir / "scan_product.xyz"
        io_xyz.write_xyz(prod, scan_res["structure"].copy(
            coords=scan_res["coords_bohr"] * BOHR2ANG))
        work_inputs = [work_inputs[0], prod]
        results["scan"] = {"stages": len(scan_stages)}

    # ---- TSOPT-only mode: one input, no scan -------------------------------
    if len(work_inputs) == 1 and not scan_stages:
        ts_out = _resolve_override_dir(out / "tsopt", tsopt_out_dir)
        with meter.phase("tsopt"):
            res_ts = run_tsopt(
                work_inputs[0], freeze_atoms=freeze_atoms,
                auto_freeze_links=auto_freeze_links,
                opt_mode=_ts_mode(opt_post_kw),
                thresh=opt_post_kw["thresh"],
                max_cycles=int(tsopt_kw.get("max_cycles_total") or 10000),
                out_dir=ts_out, hessian_dimer_kw=tsopt_kw,
                **stage_kw, **calc_kw)
        meter.calc = res_ts["calculator"]
        results["tsopt"] = {"converged": bool(res_ts["converged"]),
                            "energy_au": float(res_ts["energy"]),
                            "n_imag": int(res_ts["n_imag"])}
        ts_geom = ts_out / "final_geometry.xyz"
        if do_freq and ts_geom.exists():
            with meter.phase("freq"):
                run_freq(ts_geom, freeze_atoms=freeze_atoms,
                         auto_freeze_links=False,
                         out_dir=_resolve_override_dir(out / "freq",
                                                       freq_out_dir),
                         calculator=res_ts["calculator"], **stage_kw,
                         **freq_kw)
        if do_irc and ts_geom.exists():
            with meter.phase("irc"):
                run_irc(ts_geom, freeze_atoms=freeze_atoms,
                        auto_freeze_links=False, out_dir=out / "irc",
                        calculator=res_ts["calculator"], **stage_kw,
                        **irc_kw)
        write_summary_yaml(out / "summary.yaml", results)
        if verbose:
            print(f"[all] TSOPT-only mode complete; elapsed "
                  f"{format_elapsed(t0)}")
        results["out_dir"] = out
        results["force_call_phases"] = meter.phases
        return results

    # ---- stage 2: the path search -----------------------------------------
    skw2 = dict(search_kw)
    skw2["refine_path"] = refine_path
    skw2.setdefault("opt_mode",
                    "rfo" if str(opt_mode).lower() in ("heavy", "rfo")
                    else "lbfgs")
    skw2.setdefault("preopt", bool(preopt))
    if thresh is not None:
        skw2.setdefault("opt_thresh", str(thresh))
    if full_template is None and full_templates:
        full_template = (full_templates if len(full_templates) > 1
                         else full_templates[0])
    with meter.phase("path_search"):
        ps = run_path_search(
            work_inputs, stopt_kw={"max_cycles": int(max_cycles)},
            charge=charge, spin=spin, calc_mode=calc_mode, model=model,
            mep_mode=mep_mode, device=device, mesh=mesh,
            out_dir=out / "stage2_path",
            full_template=full_template, freeze_atoms=freeze_atoms,
            auto_freeze_links=auto_freeze_links, verbose=verbose,
            gs_kw=gs_kw, search_kw=skw2, **calc_kw)
        meter.calc = calc = ps["calculator"]
    segments = ps["segments"]
    pocket_struct = ps["structures"][0]
    results["path"] = segments_summary(segments)

    # ---- stage 3: mirrors of the merged full-system products -----------
    if full_templates is not None:
        with meter.phase("merge"):
            stage3 = out / "stage3_merged"
            stage3.mkdir(exist_ok=True)
            stage2 = out / "stage2_path"
            mirrors = [stage2 / "mep_full.pdb"]
            mirrors += sorted(
                stage2.glob("seg_*_mep/final_geometries_full.pdb"))
            mirrors += sorted(stage2.glob("seg_*_mep/hei_full.pdb"))
            for src in mirrors:
                if not src.exists():
                    continue
                name = (src.name if src.parent == stage2
                        else f"{src.parent.name}_{src.name}")
                shutil.copy2(src, stage3 / name)

    # ---- stage 4: each reactive segment ------------------------------------
    seg_results = []
    freq_blocks: Dict[int, Any] = {}
    irc_profiles: Dict[int, Any] = {}
    run_stage4 = tsopt or do_freq
    for si, seg in enumerate(segments):
        if not run_stage4:
            break
        if not seg.is_reactive:
            continue
        seg_out = out / f"stage4_seg_{si:03d}"
        seg_out.mkdir(exist_ok=True)
        entry: Dict[str, Any] = {"segment": si}
        hei_x = seg.images_bohr[seg.hei_idx]
        ts_x = hei_x
        ts_e = seg.energies[seg.hei_idx]
        if tsopt:
            with meter.phase(f"tsopt_seg{si}"):
                try:
                    hei_path = seg_out / "hei_guess.xyz"
                    io_xyz.write_xyz(hei_path, pocket_struct.copy(
                        coords=hei_x * BOHR2ANG), energy=ts_e)
                    tres = run_tsopt(
                        hei_path, opt_mode=_ts_mode(opt_post_kw),
                        thresh=opt_post_kw["thresh"],
                        max_cycles=int(tsopt_kw.get("max_cycles_total")
                                       or 10000),
                        calculator=calc, out_dir=seg_out / "tsopt",
                        hessian_dimer_kw={"flatten_max_iter": 10,
                                          **tsopt_kw},
                        **stage_kw)
                    ts_x = tres["coords_bohr"]
                    ts_e = float(tres["energy"])
                    entry["tsopt"] = {"converged": bool(tres["converged"]),
                                      "energy_au": float(ts_e),
                                      "n_imag": int(tres["n_imag"])}
                    common.write_outputs(seg_out, "ts_final", pocket_struct,
                                         ts_x, energy=ts_e)
                except Exception as e:
                    print(f"[all] WARNING: tsopt failed on segment {si}: "
                          f"{e}")
                    entry["tsopt"] = {"error": str(e)}

        # under tsopt the endpoints are re-minimized; for freq alone the
        # MEP endpoints are taken as they are
        minima = []
        with meter.phase(f"endpoints_seg{si}"):
            for tag, xg in (("reactant", seg.images_bohr[0]),
                            ("product", seg.images_bohr[-1])):
                if tsopt:
                    st = pocket_struct.copy(coords=np.asarray(xg)
                                            * BOHR2ANG)
                    coords, e, conv, _ = optimize_structure(st, calc,
                                                            **opt_post_kw)
                    common.write_outputs(seg_out, f"{tag}_opt",
                                         pocket_struct, coords, energy=e)
                else:
                    coords = np.asarray(xg)
                    e = float(seg.energies[0 if tag == "reactant" else -1])
                minima.append((tag, coords, e))
        entry["endpoints"] = {t: float(e) for t, _, e in minima}

        if tsopt and do_irc:
            with meter.phase(f"irc_seg{si}"):
                try:
                    ircres = eulerpc_irc(calc, calc.pad_bohr(ts_x), **irc_kw)
                    frames, energies = [], []
                    if ircres.backward:
                        frames += list(reversed(ircres.backward.coords))
                        energies += list(reversed(
                            ircres.backward.energies))
                    frames.append(ircres.ts_coords)
                    energies.append(ircres.ts_energy)
                    if ircres.forward:
                        frames += ircres.forward.coords
                        energies += ircres.forward.energies
                    common.write_trajectory(seg_out, "irc", pocket_struct,
                                            frames, energies)
                    irc_profiles[si] = list(map(float, energies))
                    _png(f"irc_plot.png of segment {si}", plot_profile,
                         seg_out / "irc_plot.png", energies,
                         title=f"IRC segment {si}")
                    entry["irc"] = {
                        "endpoints_au": [float(energies[0]),
                                         float(energies[-1])],
                        "matches_minima": _match_irc(
                            frames, minima, pocket_struct, calc),
                    }
                except Exception as e:
                    print(f"[all] WARNING: IRC failed on segment {si}: {e}")
                    entry["irc"] = {"error": str(e)}

        if do_freq:
            with meter.phase(f"freq_seg{si}"):
                try:
                    freq_base = _resolve_override_dir(seg_out / "freq",
                                                      freq_out_dir)
                    gibbs = {}
                    for tag, coords, e in minima + [("ts", ts_x, ts_e)]:
                        H = calc.get_hessian(
                            np.asarray(coords).reshape(-1))["hessian"]
                        vib = frequencies_and_modes(
                            H, pocket_struct.numbers, coords,
                            pocket_struct.freeze)
                        th = thermochemistry(
                            vib.freqs_cm, pocket_struct.numbers,
                            np.asarray(coords) * BOHR2ANG,
                            electronic_energy=float(e), multiplicity=spin,
                            T=freq_kw.get("temperature", 298.15),
                            pressure=freq_kw.get("pressure", 101325.0))
                        write_vib_outputs(
                            freq_base / tag,
                            pocket_struct.copy(
                                coords=np.asarray(coords) * BOHR2ANG),
                            vib, th,
                            max_write_modes=freq_kw.get("max_write_modes",
                                                        10),
                            amplitude_ang=freq_kw.get("amplitude_ang", 0.3),
                            n_frames=freq_kw.get("n_frames", 20),
                            sort_modes=freq_kw.get("sort_modes", "value"))
                        gibbs[tag] = {"G_au": float(th.gibbs),
                                      "ZPE_au": float(th.zpe),
                                      "n_imag": int(th.n_imag)}
                        if tag == "ts":
                            freq_blocks[si] = vib.freqs_cm.tolist()
                    entry["thermo"] = gibbs
                except Exception as e:
                    print(f"[all] WARNING: freq failed on segment {si}: "
                          f"{e}")
                    entry["thermo"] = {"error": str(e)}

        if do_dft:
            with meter.phase(f"dft_seg{si}"):
                try:
                    dft_base = _resolve_override_dir(seg_out / "dft",
                                                     dft_out_dir)
                    for tag, coords, _ in minima + [("ts", ts_x, ts_e)]:
                        p = seg_out / f"{tag}_dft.xyz"
                        io_xyz.write_xyz(p, pocket_struct.copy(
                            coords=np.asarray(coords) * BOHR2ANG))
                        entry.setdefault("dft", {})[tag] = run_dft(
                            p, charge=charge, spin=spin, device=device,
                            out_dir=dft_base.parent
                            / f"{dft_base.name}_{tag}", verbose=verbose,
                            **dft_kw)["energy_au"]
                except ImportError as e:
                    print(f"[all] WARNING: DFT skipped on segment {si}: "
                          f"{e}")
                    entry["dft"] = {"skipped": str(e)}
                except Exception as e:
                    print(f"[all] WARNING: DFT failed on segment {si}: {e}")
                    entry["dft"] = {"error": str(e)}

        _png(f"energy_diagram.png of segment {si}", build_levels_diagram,
             seg_out / "energy_diagram.png", ["R", "TS", "P"],
             [minima[0][2], ts_e, minima[1][2]],
             title=f"segment {si} (UMA)")
        seg_results.append(entry)

    results["segments"] = seg_results
    if verbose:
        print("[all] per-phase force-call accounting:")
        print(meter.report())
    results["force_call_phases"] = meter.phases

    # ---- aggregation: diagrams and summaries -------------------------------
    summary = segments_summary(segments)
    summary["stage4"] = seg_results
    summary["weights"] = (calc.weights_source if calc_mode == "uma"
                          else f"analytic:{calc_mode}")
    diag = compressed_diagram(segments)
    summary["diagram"] = {"labels": diag["labels"],
                          "energies_kcal": [round(float(e), 6)
                                            for e in diag["energies_kcal"]],
                          "chain": diag["chain"]}
    if verbose:
        print(f"[diagram] State label sequence: {diag['chain']}")
    _png("energy_diagram_all.png", build_energy_diagram,
         out / "energy_diagram_all.png", segments)
    write_summary_yaml(out / "summary.yaml", summary)
    write_summary_log(out / "summary.log", summary,
                      elapsed=format_elapsed(t0), freq_blocks=freq_blocks,
                      tree_root=out)

    def _chain(value_of):
        """R -> TS1 -> IM1 -> ... -> P over the reactive segments."""
        names, levels = [], []
        for k, entry in enumerate(seg_results):
            vals = value_of(entry)
            if vals is None:
                return None, None
            r, ts, p = vals
            if k == 0:
                names.append("R")
                levels.append(r)
            names.append(f"TS{k + 1}")
            levels.append(ts)
            names.append("P" if k == len(seg_results) - 1 else f"IM{k + 1}")
            levels.append(p)
        return names, levels

    def refined(e):
        return ((e["endpoints"]["reactant"], e["tsopt"]["energy_au"],
                 e["endpoints"]["product"])
                if "endpoints" in e and isinstance(e.get("tsopt"), dict)
                and "energy_au" in e["tsopt"] else None)

    def has(e, key):
        return isinstance(e.get(key), dict) and "reactant" in e[key]

    def dft_gibbs(e):
        """DFT electronic energies plus the UMA thermal correction G - E
        of each state."""
        uma = refined(e)
        if uma is None or not (has(e, "dft") and has(e, "thermo")):
            return None
        return tuple(e["dft"][t] + e["thermo"][t]["G_au"] - u
                     for t, u in zip(("reactant", "ts", "product"), uma))

    diagram_sets = {
        "energy_diagram_refined_all.png": ("UMA (refined)", refined),
        "energy_diagram_gibbs_all.png": ("Gibbs (UMA + QRRHO)", lambda e: (
            tuple(e["thermo"][t]["G_au"] for t in ("reactant", "ts",
                                                   "product"))
            if has(e, "thermo") else None)),
        "energy_diagram_dft_all.png": ("DFT//UMA", lambda e: (
            tuple(e["dft"][t] for t in ("reactant", "ts", "product"))
            if has(e, "dft") else None)),
        "energy_diagram_dft_gibbs_all.png": ("DFT//UMA + UMA thermal",
                                             dft_gibbs),
    }
    if seg_results:
        for fname, (title, value_of) in diagram_sets.items():
            names, levels = _chain(value_of)
            if names:
                _png(fname, build_levels_diagram, out / fname, names,
                     levels, title=title)
    if irc_profiles:
        _png("irc_all.png", build_irc_overview, out / "irc_all.png",
             irc_profiles)

    if verbose:
        print(f"[all] pipeline complete: {len(seg_results)} reactive "
              f"segment(s); elapsed {format_elapsed(t0)}")
    results["out_dir"] = out
    results["calculator"] = calc
    results["force_calls"] = calc.force_calls + scan_calls[0]
    results["energy_calls"] = calc.energy_calls + scan_calls[1]
    return results


def _match_irc(frames, minima, struct, calc) -> Dict[str, str]:
    """The optimized minimum each IRC endpoint reaches: no bond change
    between them, then the smallest RMSD; else "unmatched"."""
    out = {}
    for side, frame in (("backward", frames[0]), ("forward", frames[-1])):
        best = None
        best_r = np.inf
        for tag, coords, _ in minima:
            bc = compare_structures(struct.numbers, frame.reshape(-1, 3),
                                    np.asarray(coords).reshape(-1, 3),
                                    device=calc.device)
            r = rmsd(frame.reshape(-1, 3), np.asarray(coords))
            if not bc.any_change and r < best_r:
                best, best_r = tag, r
        out[side] = best or "unmatched"
    return out
