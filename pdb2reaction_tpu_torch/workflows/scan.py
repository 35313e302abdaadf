"""Staged 1-D relaxed bond scan (``scan`` subcommand).

Counterpart of ``pdb2reaction_tpu/workflows/scan.py``:

- each stage is a list of ``(i, j, target Angstrom)``, atoms as indices
  or 'RES SEQ NAME' selectors; the pairs of a stage are driven together
  along ``linear_schedule`` (N = ceil(|target - d0| / step) steps ending
  exactly at the target);
- every step is an L-BFGS relaxation under harmonic distance wells on
  all scanned pairs (``engines/bias.py``), with the step cap tied to the
  scan increment; one biased calculator serves the whole scan, its
  targets retargeted by assigning ``calc.params``;
- ``preopt`` relaxes the input and ``endopt`` each stage's result
  without the wells (L-BFGS);
- each stage reports its covalent bond changes against its start and is
  checkpointed under ``checkpoint/``: a rerun in the same ``out_dir``
  resumes a finished stage with no force call;
- outputs: ``stage_NN.trj`` per stage, ``final_geometry.xyz`` and, with
  ``dump``, the combined ``scan.trj`` (PDB companions for PDB inputs).

The relaxations run on the calculator's device (the card unless
``device="cpu"``), through the hand-written kernels on the escn path.
Every evaluation is counted (``force_calls``); the stage energies are the
biased ones, as in the JAX package. ``mesh`` and ``spatial`` go to the
calculator; over several ranks rank 0 writes ``out_dir`` and the
checkpoint it reads is every rank's (``common.rank_dir``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..bio.bonds import compare_structures, summarize_changes
from ..constants import ANG2BOHR, BOHR2ANG
from ..engines.bias import bias_params, biased_calculator
from ..engines.lbfgs import lbfgs_minimize
from ..runtime.checkpoint import CheckpointStore, content_key
from . import common
from .config import format_elapsed, pretty_block
from .opt import optimize_structure


def linear_schedule(d0: float, target: float, step: float) -> List[float]:
    """N = ceil(|target - d0| / step) evenly spaced values ending exactly
    at ``target``."""
    span = target - d0
    n = max(1, int(math.ceil(abs(span) / max(step, 1e-6))))
    return [d0 + span * (k + 1) / n for k in range(n)]


def _distance_ang(coords_bohr, i: int, j: int) -> float:
    return float(np.linalg.norm(coords_bohr[i] - coords_bohr[j])) * BOHR2ANG


def run_scan(
    input_path,
    scan_stages: Sequence[Sequence[Tuple[Any, Any, float]]],
    *,
    charge: Optional[int] = None,
    spin: Optional[int] = None,
    freeze_atoms: Sequence = (),
    auto_freeze_links: bool = True,
    step_ang: float = 0.10,
    bias_k: float = 10.0,
    relax_thresh: str = "gau_loose",
    relax_max_cycles: int = 500,
    preopt: bool = False,
    endopt: bool = False,
    endopt_thresh: str = "gau",
    opt_max_cycles: int = 10000,
    calc_mode: str = "uma",
    model: str = "uma-s-1p1",
    device="cuda",
    mesh=None,
    out_dir="./result_scan/",
    dump: bool = False,
    verbose: bool = True,
    **calc_kw,
) -> Dict[str, Any]:
    """Run the staged scan of ``input_path`` (see the module docstring).
    ``bias_k`` is in eV/Angstrom^2; ``opt_max_cycles`` caps the unbiased
    preopt and endopt (the JAX package runs them uncapped, 10000 cycles).
    Returns the stages' frames and energies, the final coordinates, the
    bond-change reports, the outputs and the calls counted."""
    t0 = time.time()
    struct = common.load_structure(input_path)
    q, s = common.resolve_charge_spin(struct, charge, spin)
    freeze = common.merge_freeze(
        struct, [common.resolve_atom_spec(f, struct) for f in freeze_atoms],
        auto_freeze_links)
    struct.freeze = freeze

    stages: List[List[Tuple[int, int, float]]] = []
    all_pairs: List[Tuple[int, int]] = []
    for stage in scan_stages:
        resolved = [(common.resolve_atom_spec(i, struct),
                     common.resolve_atom_spec(j, struct), float(t))
                    for (i, j, t) in stage]
        stages.append(resolved)
        for (i, j, _) in resolved:
            if (i, j) not in all_pairs:
                all_pairs.append((i, j))

    base = common.make_calculator(struct, calc_mode=calc_mode, charge=q,
                                  spin=s, freeze_atoms=freeze, model=model,
                                  device=device, mesh=mesh, **calc_kw)
    cur_d = {p: float(np.linalg.norm(struct.coords[p[0]]
                                     - struct.coords[p[1]]))
             for p in all_pairs}
    calc = biased_calculator(base, all_pairs, [cur_d[p] for p in all_pairs],
                             bias_k)

    def relax(coords_bohr, targets_ang, max_step, thresh):
        """The biased relaxation at ``targets_ang`` (pair -> Angstrom):
        the wells are retargeted through ``calc.params``."""
        calc.params = bias_params([targets_ang[p] for p in all_pairs],
                                  bias_k, base.params, calc.device)
        res = lbfgs_minimize(calc.au_energy_force_fn(),
                             calc.pad_bohr(coords_bohr),
                             calc.system.free_mask, thresh=thresh,
                             max_cycles=relax_max_cycles, max_step=max_step)
        return calc.unpad(res.x), float(res.e)

    def unbiased_opt(st, thresh):
        return optimize_structure(st, base, opt_mode="lbfgs", thresh=thresh,
                                  max_cycles=opt_max_cycles)

    if preopt:
        coords, e, _, _ = unbiased_opt(struct, relax_thresh)
        struct.coords = coords * BOHR2ANG
        if verbose:
            print(f"[scan] preopt: E = {e:.6f} Ha")

    out = common.rank_dir(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    store = CheckpointStore(out / "checkpoint")
    if verbose:
        print(pretty_block("scan", {
            "stages": len(scan_stages), "step_ang": step_ang,
            "bias_k": bias_k, "relax_thresh": relax_thresh,
            "relax_max_cycles": relax_max_cycles, "preopt": preopt,
            "endopt": endopt, "charge": q, "spin": s,
            "calc_mode": calc_mode, "model": model,
            "device": str(calc.device)}))
    coords_bohr = struct.coords_bohr
    step_bohr = step_ang * ANG2BOHR
    results, stage_reports, paths = [], [], []
    for si, stage in enumerate(stages):
        stage_key = f"stage_{si}_" + content_key(
            coords_bohr, extra=str(stage) + str(step_ang) + str(bias_k))
        hit = store.load(stage_key)
        if hit is not None:
            meta, arrays = hit
            coords_bohr = arrays["coords"]
            frames = [arrays["frames"][k]
                      for k in range(arrays["frames"].shape[0])]
            cur_d.update({tuple(p): t for p, t in
                          zip(meta["pairs"], meta["targets"])})
            stage_reports.append(meta["report"])
            results.append({"frames_bohr": frames,
                            "energies": list(meta["energies"]),
                            "bond_changes": None})
            if verbose:
                print(f"[scan] stage {si + 1} resumed from checkpoint")
            continue
        frames, energies = [], []
        start = coords_bohr.copy()
        scheds = {(i, j): linear_schedule(_distance_ang(coords_bohr, i, j),
                                          target, step_ang)
                  for (i, j, target) in stage}
        n_steps = max([1] + [len(v) for v in scheds.values()])
        for k in range(n_steps):
            targets = dict(cur_d)
            for p, sched in scheds.items():
                targets[p] = sched[min(k, len(sched) - 1)]
            coords_bohr, e = relax(coords_bohr, targets, step_bohr,
                                   relax_thresh)
            cur_d.update({p: targets[p] for p in scheds})
            frames.append(coords_bohr.copy())
            energies.append(e)
            if verbose:
                tgt = ", ".join(f"{p}:{targets[p]:.3f}" for p in scheds)
                print(f"[scan] stage {si + 1} step {k + 1}/{n_steps}: "
                      f"E = {e:.6f} Ha ({tgt})")
        if endopt:
            coords_bohr, e_opt, _, _ = unbiased_opt(
                struct.copy(coords=coords_bohr * BOHR2ANG), endopt_thresh)
            frames.append(coords_bohr.copy())
            energies.append(e_opt)
        bc = compare_structures(struct.numbers, start, coords_bohr,
                                device=calc.device)
        report = summarize_changes(struct.numbers, bc)
        stage_reports.append(report)
        store.save(stage_key,
                   {"energies": energies, "report": report,
                    "pairs": [list(p) for p in scheds],
                    "targets": [scheds[p][-1] for p in scheds]},
                   {"coords": coords_bohr, "frames": np.stack(frames)})
        if verbose:
            print(f"[scan] stage {si + 1} bond changes:\n{report}")
        paths += common.write_trajectory(out, f"stage_{si + 1:02d}", struct,
                                         frames, energies)
        results.append({"frames_bohr": frames, "energies": energies,
                        "bond_changes": bc})

    paths += common.write_outputs(out, "final_geometry", struct, coords_bohr,
                                  energy=results[-1]["energies"][-1])
    if dump:
        paths += common.write_trajectory(
            out, "scan", struct, [f for r in results for f in r["frames_bohr"]],
            [e for r in results for e in r["energies"]])
    if verbose:
        print(f"[scan] elapsed {format_elapsed(t0)}")
    return {"stages": results, "coords_bohr": coords_bohr,
            "stage_reports": stage_reports, "outputs": paths,
            "structure": struct, "calculator": calc,
            "force_calls": base.force_calls + calc.force_calls,
            "energy_calls": base.energy_calls + calc.energy_calls}
