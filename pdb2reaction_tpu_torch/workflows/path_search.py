"""Recursive multi-step MEP search (``path-search`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/path_search.py``. For each
adjacent pair of inputs: run a GSM (or, with ``mep_mode="dmf"``, a DMF)
segment, optimize the images beside its highest-energy image (HEI +- 1,
or the nearest path minima with ``refine_mode="minima"``) and classify
the gap between them:

- no covalent change between the optimized minima: a **kink**, up to
  ``kink_max_nodes`` interpolated nodes each optimized, no recursion,
  and an abort after ``max_consecutive_kinks`` kinks in a row;
- else a refinement MEP between the minima, then a recursion on the
  left and right sides that still change bonds, down to ``max_depth``;
- the segments are stitched: a duplicated boundary image is dropped,
  and an interface gap gets a bridge MEP.

``refine_path=False`` in ``search_kw`` runs one MEP a pair instead, with
no recursion.

Then ``mep.trj``, one ``seg_NNN_mep/`` per segment (its trajectory, its
HEI for a reactive segment and a segment-level ``summary.yaml``), the
compressed R -> TS -> IM -> P diagram, ``summary.yaml`` and
``summary.log``. With ``full_template`` (one full-system PDB, or one per
input in reaction order) every pocket frame is merged back into the full
structure (``bio/merge.py``; the background blended from the pair's two
templates across each merged set of frames): ``mep_full.pdb``,
``seg_NNN_mep/final_geometries_full.pdb`` and, for a reactive segment,
``seg_NNN_mep/hei_full.pdb``. Every finished MEP is memoized under
``<out_dir>/checkpoint`` by a content key of its endpoints, so a second
run in the same ``out_dir`` restores its segments.

Every force evaluation is the calculator's (``force_calls``); the kink
endpoints' energies are ``energy_calls``. The optimizations run L-BFGS
or, with ``opt_mode="rfo"``, RFO from an exact Hessian. ``mesh``
splits the strings' image batches over its data axis, ``spatial=n``
shards every evaluation over n ranks; over several ranks rank 0 writes
``out_dir`` and the memo it read is every rank's (``common.rank_dir``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..bio import merge as bio_merge
from ..bio.align import align_sequence_inplace, kabsch, rmsd
from ..bio.bonds import compare_structures, summarize_changes
from ..constants import AU2KCALPERMOL, BOHR2ANG
from ..core import io_pdb
from ..engines.gsm import GS_KW, STOPT_KW
from ..runtime.checkpoint import CheckpointStore, content_key
from . import common
from .config import format_elapsed, normalize_choice, pretty_block
from .opt import optimize_structure
from .path_opt import route_engine_keys, run_mep_between
from .summary import (build_energy_diagram, compressed_diagram,
                      write_summary_log, write_summary_yaml)

SEARCH_KW: Dict[str, Any] = {
    "max_depth": 3,            # recursion depth cap
    "refine_mode": "hei",      # "hei" (HEI +- 1) | "minima"
    "kink_max_nodes": 5,
    "rmsd_dedup_thresh": 1e-3,  # Bohr RMSD for stitch dedup
    "bridge_rmsd_thresh": 0.1,  # Bohr RMSD gap needing a bridge MEP
    "max_consecutive_kinks": 2,
    "opt_thresh": "gau",
    "opt_mode": "lbfgs",
    "preopt": True,
    "preopt_thresh": "gau_loose",
}

BOND_KW: Dict[str, Any] = {
    "bond_factor": 1.20,
    "margin_fraction": 0.05,
    "delta_fraction": 0.05,
}


@dataclass
class SegmentReport:
    images_bohr: List[np.ndarray]      # [n_img][N, 3]
    energies: List[float]
    hei_idx: int
    is_reactive: bool
    is_kink: bool = False
    bond_summary: str = ""
    converged: bool = True
    pair_index: int = 0                # which adjacent-input pair made it
    # "seg" | "bridge" | "kink": only plain reactive "seg"s open TS groups
    # in the compressed diagram, "bridge" barriers become diagram-only
    # peaks
    kind: str = "seg"

    @property
    def barrier_au(self) -> float:
        return float(self.energies[self.hei_idx] - self.energies[0])

    @property
    def delta_e_au(self) -> float:
        return float(self.energies[-1] - self.energies[0])


class PathSearch:
    def __init__(self, calc, numbers, *, mep_mode="gsm", gs_kw=None,
                 stopt_kw=None, dmf_kw=None, search_kw=None, bond_kw=None,
                 verbose=True, store=None):
        self.calc = calc
        self.numbers = np.asarray(numbers, int)
        self.n = calc.n_atoms
        self.mep = dict(mep_mode=mep_mode, gs_kw=gs_kw, stopt_kw=stopt_kw,
                        dmf_kw=dmf_kw)
        self.kw = {**SEARCH_KW, **(search_kw or {})}
        self.bond_kw = {**BOND_KW, **(bond_kw or {})}
        self.verbose = verbose
        self.kink_streak = 0
        self.segments_run = 0
        self.store = store          # CheckpointStore: per-segment MEP memo

    # -- helpers ------------------------------------------------------------
    def _log(self, msg):
        if self.verbose:
            print(f"[path-search] {msg}")

    def _bond_change(self, cA, cB):
        return compare_structures(self.numbers, cA, cB,
                                  device=self.calc.device, **self.bond_kw)

    def _optimize(self, coords_bohr, thresh=None):
        st = self.calc.structure.copy(coords=np.asarray(coords_bohr)
                                      * BOHR2ANG)
        coords, e, conv, cyc = optimize_structure(
            st, self.calc, opt_mode=self.kw.get("opt_mode", "lbfgs"),
            thresh=thresh or self.kw["opt_thresh"])
        return np.asarray(coords), float(e)

    def _mep(self, cA_bohr, cB_bohr):
        """One MEP segment (images, energies, hei, converged), from the
        memo when the same endpoints ran before."""
        key = None
        if self.store is not None:
            key = "mep_" + content_key(cA_bohr, cB_bohr,
                                       extra=str(self.mep["mep_mode"]))
            hit = self.store.load(key)
            if hit is not None:
                meta, arrays = hit
                self._log(f"resume: segment {key} restored from checkpoint")
                return ([arrays["images"][k]
                         for k in range(arrays["images"].shape[0])],
                        list(meta["energies"]), int(meta["hei_idx"]),
                        bool(meta["converged"]))
        stA = self.calc.structure.copy(coords=cA_bohr * BOHR2ANG)
        stB = self.calc.structure.copy(coords=cB_bohr * BOHR2ANG)
        self.segments_run += 1
        res = run_mep_between(stA, stB, self.calc, verbose=False,
                              **self.mep)
        images = [img[: self.n] for img in res.images]
        energies = list(map(float, res.energies))
        if key is not None:
            self.store.save(key, {"energies": energies,
                                  "hei_idx": int(res.hei_idx),
                                  "converged": bool(res.converged)},
                            {"images": np.stack(images)})
        return images, energies, res.hei_idx, res.converged

    def _segment(self, images, energies, hei, conv) -> SegmentReport:
        bc = self._bond_change(images[0], images[-1])
        return SegmentReport(images_bohr=images, energies=energies,
                             hei_idx=hei, is_reactive=bc.any_change,
                             bond_summary=summarize_changes(self.numbers, bc),
                             converged=conv)

    def _kink_guard(self, msg):
        self.kink_streak += 1
        if self.kink_streak > self.kw["max_consecutive_kinks"]:
            raise RuntimeError(msg)

    # -- the recursion --------------------------------------------------------
    def build(self, cA_bohr, cB_bohr, depth: int = 0) -> List[SegmentReport]:
        bc_ab = self._bond_change(cA_bohr, cB_bohr)
        if not bc_ab.any_change:
            # a conformational gap: a kink of interpolated optimized nodes
            self._kink_guard("Aborting: too many consecutive kink segments "
                             "— check input structures")
            return [self._kink_segment(cA_bohr, cB_bohr)]

        images, energies, hei, conv = self._mep(cA_bohr, cB_bohr)
        self._log(f"depth {depth}: segment HEI {hei}, "
                  f"barrier {(energies[hei] - energies[0]) * AU2KCALPERMOL:.2f}"
                  " kcal/mol")

        # the flanking geometries
        if self.kw["refine_mode"] == "minima":
            left_i = self._nearest_min(energies, hei, -1)
            right_i = self._nearest_min(energies, hei, +1)
        else:
            left_i, right_i = max(hei - 1, 0), min(hei + 1, len(images) - 1)

        left_min, eL = self._optimize(images[left_i])
        right_min, eR = self._optimize(images[right_i])

        if not self._bond_change(left_min, right_min).any_change:
            # the reaction collapsed to a kink at this refinement level
            self._kink_guard("Aborting: too many consecutive kink segments")
            center = [self._kink_segment(left_min, right_min)]
        else:
            self.kink_streak = 0
            imgs, es, h, cv = self._mep(left_min, right_min)
            center = [self._segment(imgs, es, h, cv)]

        out: List[SegmentReport] = []
        out += self._side(cA_bohr, left_min, depth)
        out += center
        out += self._side(right_min, cB_bohr, depth)
        return self._stitch(out)

    def _side(self, c_from, c_to, depth) -> List[SegmentReport]:
        bc = self._bond_change(c_from, c_to)
        if bc.any_change:
            if depth + 1 <= self.kw["max_depth"]:
                return self.build(c_from, c_to, depth + 1)
            self._log(f"depth cap {self.kw['max_depth']} reached; bridging "
                      "reactive gap with a single MEP segment")
            imgs, es, h, cv = self._mep(c_from, c_to)
            return [self._segment(imgs, es, h, cv)]
        if rmsd(c_from, c_to) > self.kw["bridge_rmsd_thresh"]:
            # non-reactive but geometrically distinct: a bridge
            imgs, es, h, cv = self._mep(c_from, c_to)
            seg = self._segment(imgs, es, h, cv)
            seg.is_kink = True
            seg.kind = "bridge"
            return [seg]
        return []

    def _kink_segment(self, cA, cB) -> SegmentReport:
        nk = self.kw["kink_max_nodes"]
        ws = np.linspace(0.0, 1.0, nk + 2)
        images = []
        energies = []
        for k, w in enumerate(ws):
            c = (1 - w) * cA + w * cB
            if 0 < k < len(ws) - 1:
                c, e = self._optimize(c, thresh=self.kw["preopt_thresh"])
            else:
                e = float(self.calc.get_energy(c.reshape(-1))["energy"])
            images.append(np.asarray(c))
            energies.append(float(e))
        hei = int(np.argmax(energies))
        seg = SegmentReport(images_bohr=images, energies=energies,
                            hei_idx=hei, is_reactive=False, is_kink=True,
                            bond_summary="(kink: no covalent change)",
                            kind="kink")
        self._log("kink segment inserted")
        return seg

    @staticmethod
    def _nearest_min(E, hei, direction):
        i = hei
        E = list(E)
        while 0 < i < len(E) - 1:
            j = i + direction
            if E[j] > E[i]:
                break
            i = j
        return max(0, min(i, len(E) - 1))

    def _stitch(self, segments: List[SegmentReport]) -> List[SegmentReport]:
        """Interfaces between adjacent segments: an interface RMSD below
        ``rmsd_dedup_thresh`` drops the duplicated boundary image from the
        later segment; a gap above ``bridge_rmsd_thresh`` gets a bridge
        MEP (reactive if the interface itself changes a bond, else
        kink-marked)."""
        out: List[SegmentReport] = []
        for seg in segments:
            if out:
                prev_end = out[-1].images_bohr[-1]
                gap = rmsd(prev_end, seg.images_bohr[0])
                if gap < self.kw["rmsd_dedup_thresh"] \
                        and len(seg.images_bohr) > 1:
                    seg = SegmentReport(
                        images_bohr=seg.images_bohr[1:],
                        energies=seg.energies[1:],
                        hei_idx=max(seg.hei_idx - 1, 0),
                        is_reactive=seg.is_reactive, is_kink=seg.is_kink,
                        bond_summary=seg.bond_summary,
                        converged=seg.converged, kind=seg.kind)
                elif gap > self.kw["bridge_rmsd_thresh"]:
                    bc = self._bond_change(prev_end, seg.images_bohr[0])
                    self._log(f"stitch: interface gap RMSD {gap:.4f} Bohr -> "
                              + ("reactive bridge MEP" if bc.any_change
                                 else "bridge MEP"))
                    imgs, es, h, cv = self._mep(prev_end, seg.images_bohr[0])
                    bridge = self._segment(imgs, es, h, cv)
                    bridge.is_kink = not bc.any_change
                    bridge.kind = "bridge"
                    out.append(bridge)
            out.append(seg)
        return out


def run_path_search(
    input_paths: Sequence,
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    mep_mode: str = "gsm",
    align: bool = True,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_path_search/",
    full_template=None,
    verbose: bool = True,
    gs_kw: Optional[Dict[str, Any]] = None,
    stopt_kw: Optional[Dict[str, Any]] = None,
    dmf_kw: Optional[Dict[str, Any]] = None,
    search_kw: Optional[Dict[str, Any]] = None,
    bond_kw: Optional[Dict[str, Any]] = None,
    **calc_kw,
) -> Dict[str, Any]:
    """The recursive search over ``input_paths`` (two or more files of
    one system, in reaction order); writes the output tree under
    ``out_dir``. Engine and search keys may also come flat in
    ``calc_kw``. ``gs_kw`` reaches every segment's string as it is, its
    ``loop`` ("device", "host" or "auto") included
    (``path_opt.run_mep_between``). ``auto_freeze_links`` freezes the
    parents of a PDB input's link hydrogens; atoms to freeze may be
    indices or 'RES SEQ NAME' selectors."""
    t0 = time.time()
    if len(input_paths) < 2:
        raise ValueError("path-search needs >= 2 structures")
    search_kw = dict(search_kw or {})
    gs_kw = dict(gs_kw or {})
    stopt_kw = dict(stopt_kw or {})
    dmf_kw = dict(dmf_kw or {})
    bond_kw = dict(bond_kw or {})
    mep_mode = normalize_choice(mep_mode, choices=("gsm", "dmf"))
    # engine and search keys given flat go to their dicts, first table
    # first (max_cycles is the string's, DMF's under mep_mode="dmf")
    route_engine_keys(calc_kw, mep_mode, ((SEARCH_KW, search_kw),
                                          (GS_KW, gs_kw),
                                          (STOPT_KW, stopt_kw)), dmf_kw)
    for k in [k for k in calc_kw if k in BOND_KW]:
        bond_kw[k] = calc_kw.pop(k)
    skw = {**SEARCH_KW, **search_kw}
    skw["opt_mode"] = normalize_choice(skw["opt_mode"],
                                       choices=("lbfgs", "rfo"))

    structs = [common.load_structure(p) for p in input_paths]
    for st in structs[1:]:
        if list(st.numbers) != list(structs[0].numbers):
            raise ValueError("Inputs must share atom count and ordering")
    q, s = common.resolve_charge_spin(structs[0], charge, spin)
    for st in structs:
        st.freeze = common.merge_freeze(
            st, [common.resolve_atom_spec(f, st) for f in freeze_atoms],
            auto_freeze_links)
    full_struct, merge_full = (_full_merger(full_template, structs)
                               if full_template is not None else (None, None))
    calc = common.make_calculator(structs[0], calc_mode=calc_mode, charge=q,
                                  spin=s, freeze_atoms=structs[0].freeze,
                                  model=model, device=device, mesh=mesh,
                                  **calc_kw)
    if verbose:
        print(pretty_block("path-search", {
            "mep_mode": mep_mode, "charge": q, "spin": s,
            "calc_mode": calc_mode, "model": model,
            "device": str(calc.device), "search": dict(skw),
            "gs": dict(gs_kw), "bond": dict(bond_kw)}))

    if skw["preopt"]:
        for st in structs:
            coords, e, conv, cyc = optimize_structure(
                st, calc, opt_mode=skw["opt_mode"],
                thresh=skw["preopt_thresh"])
            st.coords = coords * BOHR2ANG
    if align:
        align_sequence_inplace(structs)

    out = common.rank_dir(out_dir)
    store = CheckpointStore(out / "checkpoint")
    searcher = PathSearch(calc, structs[0].numbers, mep_mode=mep_mode,
                          gs_kw=gs_kw, stopt_kw=stopt_kw, dmf_kw=dmf_kw,
                          search_kw=skw, bond_kw=bond_kw,
                          verbose=verbose, store=store)
    all_segments: List[SegmentReport] = []
    for pi, (a, b) in enumerate(zip(structs[:-1], structs[1:])):
        searcher.kink_streak = 0
        if skw.get("refine_path", True):
            segs = searcher.build(a.coords_bohr, b.coords_bohr, depth=0)
        else:
            # one MEP per adjacent pair, no recursion
            imgs, es, h, cv = searcher._mep(a.coords_bohr, b.coords_bohr)
            segs = [searcher._segment(imgs, es, h, cv)]
        for sg in segs:
            sg.pair_index = pi
        all_segments.extend(segs)

    out.mkdir(parents=True, exist_ok=True)
    paths: List[Path] = []
    mep_frames: List[np.ndarray] = []
    mep_energies: List[float] = []
    mep_pairs: List[int] = []
    for si, seg in enumerate(all_segments):
        seg_dir = out / f"seg_{si:03d}_mep"
        paths += common.write_trajectory(seg_dir, "final_geometries",
                                         structs[0], seg.images_bohr,
                                         seg.energies)
        if seg.is_reactive:
            paths += common.write_outputs(seg_dir, "hei", structs[0],
                                          seg.images_bohr[seg.hei_idx],
                                          energy=seg.energies[seg.hei_idx])
        seg_summary = segments_summary([seg])
        seg_summary["segments"][0]["index"] = si
        seg_summary["pair_index"] = int(seg.pair_index)
        seg_summary["weights"] = calc.weights_source
        paths.append(write_summary_yaml(seg_dir / "summary.yaml",
                                        seg_summary))
        if merge_full is not None:
            paths += _write_full(
                seg_dir / "final_geometries_full.pdb", full_struct,
                lambda: merge_full(seg.images_bohr,
                                   [seg.pair_index] * len(seg.images_bohr)),
                seg.energies, f"segment {si}")
            if seg.is_reactive:
                paths += _write_full(
                    seg_dir / "hei_full.pdb", full_struct,
                    lambda: merge_full([seg.images_bohr[seg.hei_idx]],
                                       [seg.pair_index]),
                    [seg.energies[seg.hei_idx]], f"segment {si} HEI")
        start = 1 if (mep_frames and rmsd(mep_frames[-1],
                                          seg.images_bohr[0]) < 1e-3) else 0
        mep_frames.extend(seg.images_bohr[start:])
        mep_energies.extend(seg.energies[start:])
        mep_pairs.extend([seg.pair_index] * (len(seg.images_bohr) - start))

    paths += common.write_trajectory(out, "mep", structs[0], mep_frames,
                                     mep_energies)
    if merge_full is not None:
        paths += _write_full(out / "mep_full.pdb", full_struct,
                             lambda: merge_full(mep_frames, mep_pairs),
                             mep_energies, "MEP")

    summary = segments_summary(all_segments)
    summary["weights"] = calc.weights_source
    diag = compressed_diagram(all_segments)
    summary["diagram"] = {"labels": diag["labels"],
                          "energies_kcal": [round(float(e), 6)
                                            for e in diag["energies_kcal"]],
                          "chain": diag["chain"]}
    if verbose:
        print(f"[diagram] State label sequence: {diag['chain']}")
    # the figures need matplotlib; without it they are skipped, the
    # diagram's levels stay in summary.yaml
    try:
        build_energy_diagram(out / "energy_diagram.png", all_segments)
        paths.append(out / "energy_diagram.png")
    except ImportError as e:
        print(f"[path-search] WARNING: energy_diagram.png skipped: {e}")
    paths.append(write_summary_yaml(out / "summary.yaml", summary))
    paths.append(write_summary_log(out / "summary.log", summary,
                                   elapsed=format_elapsed(t0)))
    try:
        from .trj2fig import plot_profile
        paths.append(plot_profile(out / "mep_plot.png", mep_energies))
    except ImportError as e:
        print(f"[path-search] WARNING: mep_plot.png skipped: {e}")

    if verbose:
        print(f"[path-search] {len(all_segments)} segments "
              f"({sum(1 for s in all_segments if s.is_reactive)} reactive), "
              f"{searcher.segments_run} MEPs run, {calc.force_calls} force "
              f"calls, {calc.energy_calls} energy calls; elapsed "
              f"{format_elapsed(t0)}")
    return {"segments": all_segments, "mep_frames_bohr": mep_frames,
            "mep_energies": mep_energies, "summary": summary,
            "outputs": paths, "structures": structs, "calculator": calc,
            "segments_run": searcher.segments_run,
            "force_calls": calc.force_calls,
            "energy_calls": calc.energy_calls}


def _full_merger(full_template, structs):
    """(the full structure, ``merge``): the merge of pocket frames into
    the full system, on one template or one per input in reaction order,
    each chain-aligned onto the one before. ``merge(frames_bohr,
    pair_idx)`` returns the full-system coordinates (Angstrom) of each
    frame; a run of frames of one pair blends that pair's two templates
    as the background, from the first (fraction 0) to the second
    (fraction 1) across the run, so a single frame takes the first
    template's background."""
    tmpl_paths = ([full_template] if isinstance(full_template, (str, Path))
                  else list(full_template))
    if len(tmpl_paths) not in (1, len(structs)):
        raise ValueError(
            f"--ref-full-pdb needs 1 or {len(structs)} templates (one per "
            f"input), got {len(tmpl_paths)}")
    tmpl_structs = [io_pdb.read_pdb(p) for p in tmpl_paths]
    n0 = tmpl_structs[0].n_atoms
    for ts_ in tmpl_structs[1:]:
        if ts_.n_atoms != n0:
            raise ValueError("[merge] Atom count mismatch among "
                             f"--ref-full-pdb templates: {n0} vs "
                             f"{ts_.n_atoms}")
    tmpl_coords = [tmpl_structs[0].coords.copy()]
    for ts_ in tmpl_structs[1:]:
        R, t = kabsch(ts_.coords, tmpl_coords[-1])
        tmpl_coords.append(ts_.coords @ R + t)
    full_struct, pocket = tmpl_structs[0], structs[0]
    nT = len(tmpl_coords)

    def merge(frames_bohr, pair_idx):
        out_coords = []
        i = 0
        while i < len(frames_bohr):
            j = i
            while j < len(frames_bohr) and pair_idx[j] == pair_idx[i]:
                j += 1
            pi = min(int(pair_idx[i]), nT - 2) if nT > 1 else 0
            A = tmpl_coords[pi]
            B = tmpl_coords[pi + 1] if nT > 1 else A
            M = j - i
            for k in range(M):
                tf = 0.0 if M == 1 else k / (M - 1.0)
                out_coords.append(bio_merge.merge_pocket_into_full(
                    full_struct, pocket,
                    np.asarray(frames_bohr[i + k]) * BOHR2ANG,
                    full_coords_ang=(1.0 - tf) * A + tf * B).coords)
            i = j
        return out_coords

    return full_struct, merge


def _write_full(path, full_struct, merged, energies, what):
    """Write the frames ``merged()`` returns as a multi-MODEL PDB on the
    full structure; a failed merge prints a warning and writes nothing."""
    try:
        io_pdb.write_pdb_frames(path, full_struct, merged(),
                                energies=energies)
    except Exception as e:
        print(f"[path-search] WARNING: full merge of {what} failed: {e}")
        return []
    return [Path(path)]


def segments_summary(segments: List[SegmentReport]) -> Dict[str, Any]:
    e0 = segments[0].energies[0] if segments else 0.0
    out = {"n_segments": len(segments), "segments": []}
    for i, s in enumerate(segments):
        out["segments"].append({
            "index": i,
            "pair_index": int(getattr(s, "pair_index", 0)),
            "reactive": bool(s.is_reactive),
            "kink": bool(s.is_kink),
            "kind": getattr(s, "kind", "seg"),
            "barrier_kcal": round(s.barrier_au * AU2KCALPERMOL, 3),
            "delta_e_kcal": round(s.delta_e_au * AU2KCALPERMOL, 3),
            "e_start_au": float(s.energies[0]),
            "e_ts_au": float(s.energies[s.hei_idx]),
            "e_end_au": float(s.energies[-1]),
            "rel_start_kcal": round((s.energies[0] - e0) * AU2KCALPERMOL, 3),
            "bond_changes": s.bond_summary,
            "converged": bool(s.converged),
        })
    return out
