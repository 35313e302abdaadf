"""Command-line interface of the port: ``all`` (the default), ``opt``,
``scan``, ``scan2d``, ``scan3d``, ``path-opt``, ``path-search``,
``tsopt``, ``freq``, ``irc``, ``dft``, ``extract``, ``add-elem-info``,
``trj2fig`` and ``align-freeze-atoms``.

Same flags as the JAX package's (``pdb2reaction_tpu/cli.py``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
A command line that names no subcommand runs ``all``. ``--args-yaml``
overrides any option from the file's sections (YAML wins; see
``workflows/config.py`` for the YAML subset the port reads),
``--ligand-charge`` derives the charge of a PDB input, ``--ref-pdb``
lends a PDB template to .xyz/.gjf inputs and ``--profile DIR`` writes a
torch.profiler Chrome trace. ``opt`` / ``tsopt --coord-type dlc`` run
in delocalized internals and ``--mep-mode dmf`` (``path-opt``,
``path-search``, ``all``) runs Direct Max Flux (``path-opt`` reads its
keys from the ``dmf:`` section of ``--args-yaml``, as the JAX package
does). ``--gsm-loop`` (``path-opt``, ``path-search``, ``all``) picks the
GSM loop: ``device`` (captured CUDA graphs on the card, eager masked
cycles on the CPU), ``host``, or ``auto`` (the calculator's: device for
the PaiNN-class models and the analytic potentials, host for eSCN).
Refused: ``--dump`` outside ``opt`` and ``scan`` (the other JAX commands
write nothing with it).
``--args-yaml`` is refused by ``scan2d``, ``scan3d`` and ``dft``, whose
JAX commands read no YAML.

    python -m pdb2reaction_tpu_torch -i R.pdb -i P.pdb --center LIG \
        --ligand-charge 0 --model escn-md                   # all
    python -m pdb2reaction_tpu_torch opt -i x.xyz -q 0      # uma-s-1p1
    python -m pdb2reaction_tpu_torch path-search -i a.xyz -i b.xyz \
        -q 0 --calc-mode morse --device cpu                 # recursive MEPs
    python -m pdb2reaction_tpu_torch tsopt -i ts.xyz -q 0 \
        --opt-mode heavy --model escn-md                    # RS-I-RFO
    python -m pdb2reaction_tpu_torch scan -i x.xyz -q 0 \
        --scan-list 1,2,1.5 --model escn-md                 # staged scan
    python -m pdb2reaction_tpu_torch dft -i h2.xyz -q 0 --engine mini
    python -m pdb2reaction_tpu_torch extract -i c.pdb -c LIG -o p.pdb

Ranks: every workflow subcommand runs over ``--workers W`` x
``--spatial S`` ranks, one process each, launched by ``torchrun``
(WORLD_SIZE must equal W x S). ``--spatial S`` shards the atom axis of
every evaluation over S ranks, Hessians and HVPs included, for the
PaiNN-class models and for eSCN (``--model escn-md``, ``escn-md-gate``,
``escn-s``, ...; ``pallas-mega`` takes K3 on the gathered source rows
under the shard). ``--workers W`` splits image batches (GSM, DMF, the
dimer), analytic-Hessian tangents and FD displacements over W ranks, the
JAX package's data axis; beside ``--spatial > 1`` it has no effect, as
in the JAX package. ``--workers-per-node`` is accepted and dropped.
Every rank runs the same host loop; rank 0 alone logs and writes the
output tree (``workflows/common.py``):

    torchrun --nproc-per-node 4 -m pdb2reaction_tpu_torch opt -i x.xyz \
        -q 0 --spatial 4 --model escn-md
    torchrun --nproc-per-node 4 -m pdb2reaction_tpu_torch path-opt \
        -i a.xyz -i b.xyz -q 0 --workers 4 --model escn-md

Across hosts, ``PDB2R_TPU_DISTRIBUTED=1`` joins every process of the job
(``PDB2R_TPU_COORDINATOR=host:port``, ``PDB2R_TPU_NUM_PROCS``,
``PDB2R_TPU_PROC_ID``, else the ``torchrun`` variables) and puts the data
axis across hosts, the model axis inside each.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .workflows.config import (apply_yaml_overrides, load_yaml_dict,
                               normalize_choice)

_LATER = "is not ported yet (see ROADMAP.md)"


def _bool(v: str) -> bool:
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {v!r}")


def parse_freeze(spec: str) -> List:
    """Comma-separated 0-based indices or 'RES SEQ NAME' selectors."""
    out: List = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if tok:
            out.append(int(tok) if tok.lstrip("+-").isdigit() else tok)
    return out


def _idx(tok: str, one_based: bool):
    """An integer atom index, shifted when indices are 1-based; selector
    strings pass through."""
    if tok.lstrip("+-").isdigit():
        v = int(tok)
        if one_based and v < 1:
            raise SystemExit(
                f"Atom index {v} with 1-based numbering (the default; "
                "pass --one-based False for 0-based indices)")
        return v - (1 if one_based else 0)
    return tok


def _parse_pairs(spec: str, one_based: bool = False) -> List[Tuple]:
    """'i,j;k,l' atom pairs."""
    out = []
    for grp in (spec or "").split(";"):
        grp = grp.strip()
        if grp:
            toks = [t.strip() for t in grp.split(",")]
            out.append((_idx(toks[0], one_based), _idx(toks[1], one_based)))
    return out


def _parse_scan_stages(specs, one_based: bool = False) -> List[List[Tuple]]:
    """One stage per spec 'i,j,target[;k,l,target...]'."""
    stages = []
    for spec in specs:
        stage = []
        for grp in spec.split(";"):
            grp = grp.strip()
            if grp:
                toks = [t.strip() for t in grp.split(",")]
                stage.append((_idx(toks[0], one_based),
                              _idx(toks[1], one_based), float(toks[2])))
        if stage:
            stages.append(stage)
    return stages


def _scan_axes(specs, one_based: bool = False) -> List[Dict[str, Any]]:
    """Grid axes from 'i,j,end[,step[,start]]' specs."""
    axes = []
    for spec in specs:
        toks = [t.strip() for t in spec.split(",")]
        ax: Dict[str, Any] = {"pair": (_idx(toks[0], one_based),
                                       _idx(toks[1], one_based)),
                              "end": float(toks[2])}
        if len(toks) > 3:
            ax["step"] = float(toks[3])
        if len(toks) > 4:
            ax["start"] = float(toks[4])
        axes.append(ax)
    return axes


def _parse_scan_list(raw: str, one_based: bool, step: float):
    """'[(i,j,low,high),...]' quadruples: each axis swept from low to high
    at steps of at most ``step`` Angstrom."""
    import ast
    axes = []
    for i, j, low, high in ast.literal_eval(str(raw)):
        axes.append({"pair": (_idx(str(int(i)), one_based),
                              _idx(str(int(j)), one_based)),
                     "start": float(low), "end": float(high),
                     "step": float(step)})
    return axes


def _split_func_basis(spec: str):
    if "/" not in spec:
        raise SystemExit(f"--func-basis expects 'FUNC/BASIS', got {spec!r}")
    return spec.split("/", 1)


def _common_options(p) -> None:
    """The options every workflow subcommand of the JAX package takes."""
    p.add_argument("-q", "--charge", type=int, default=None)
    p.add_argument("-s", "--spin", type=int, default=None)
    p.add_argument("-m", "--mult", "--multiplicity", dest="multiplicity",
                   type=int, default=None)
    p.add_argument("--freeze-atoms", default="",
                   help="Comma-separated indices or 'RES SEQ NAME' specs.")
    p.add_argument("--auto-freeze-links", type=_bool, default=True)
    p.add_argument("--freeze-links", type=_bool, default=None)
    p.add_argument("--ref-pdb", type=Path, default=None,
                   help="PDB template for .xyz/.gjf inputs (outputs get PDB "
                        "companions, selectors resolve).")
    p.add_argument("--dump", type=_bool, default=False)
    p.add_argument("--calc-mode", default="uma",
                   choices=["uma", "morse", "lj"],
                   help="uma (the MLIP) or an analytic test potential.")
    p.add_argument("--model", default="uma-s-1p1",
                   help="Model config name: PaiNN-class uma-s-1p1 "
                        "(default), uma-m-1p1, small, uma-s-1p1-bf16, or "
                        "eSCN escn-md, escn-test, ....")
    p.add_argument("--hessian-calc-mode", default="Analytical",
                   choices=["Analytical", "FiniteDifference"])
    p.add_argument("--workers", type=int, default=1,
                   help="Data-axis ranks: image batches, Hessian tangents "
                        "and FD displacements over N ranks (launch under "
                        "torchrun, one process per rank).")
    p.add_argument("--workers-per-node", type=int, default=1,
                   help="Accepted and dropped, as in the JAX package.")
    p.add_argument("--spatial", type=int, default=1,
                   help="Shard the atom axis over N ranks (launch under "
                        "torchrun, one process per rank).")
    p.add_argument("--ligand-charge", default=None,
                   help="Total charge or per-resname mapping (e.g. "
                        "GPP:-3,SAM:1) deriving the charge of a PDB input "
                        "when -q is absent.")
    p.add_argument("--args-yaml", type=Path, default=None,
                   help="YAML overriding any option (YAML wins).")
    p.add_argument("--out-dir", type=Path, default=None)
    p.add_argument("--convert-files", type=_bool, default=True,
                   help="Mirror .xyz/.trj outputs as PDB/GJF.")
    p.add_argument("--profile", default=None, type=Path,
                   help="Write a torch.profiler Chrome trace into DIR.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; hand-written kernels) or cpu "
                        "(plain PyTorch path).")


def _opt_parser(sub):
    p = sub.add_parser("opt", help="Single-structure geometry optimization.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--opt-mode", default="light",
                   help="light|lbfgs or heavy|rfo.")
    p.add_argument("--coord-type", default="cart", choices=["cart", "dlc"])
    p.add_argument("--thresh", default="gau")
    p.add_argument("--max-cycles", type=int, default=10000)
    p.add_argument("--dist-freeze", default="",
                   help="Pairs 'i,j;k,l' restrained at their current "
                        "distances.")
    p.add_argument("--bias-k", type=float, default=10.0,
                   help="Harmonic restraint strength k [eV/Angstrom^2].")
    p.add_argument("--one-based", type=_bool, default=True,
                   help="Integer atom indices of --dist-freeze are "
                        "1-based.")
    p.add_argument("--dump-restart", type=int, default=0,
                   help="Dump the L-BFGS carry every N cycles for a mid-run "
                        "restart (Cartesian L-BFGS); 0 disables.")
    _common_options(p)
    p.set_defaults(func=opt_cmd)


def _scan_parser(sub):
    p = sub.add_parser("scan", help="Staged 1-D relaxed bond scan.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--scan-list", dest="scan_lists", action="append",
                   required=True,
                   help="Stage spec 'i,j,target[;k,l,target]' (repeatable).")
    p.add_argument("--step", "--max-step-size", dest="step_ang", type=float,
                   default=0.10,
                   help="Largest change of a scanned distance a step "
                        "[Angstrom].")
    p.add_argument("--bias-k", type=float, default=10.0,
                   help="Harmonic well strength k [eV/Angstrom^2].")
    p.add_argument("--preopt", type=_bool, default=True,
                   help="Unbiased optimization before the scan.")
    p.add_argument("--endopt", type=_bool, default=True,
                   help="Unbiased optimization of each stage's result.")
    p.add_argument("--relax-max-cycles", type=int, default=500,
                   help="Cycle cap of each step's relaxation.")
    p.add_argument("--one-based", type=_bool, default=True,
                   help="Integer (i, j) indices are 1-based.")
    _common_options(p)
    p.set_defaults(func=scan_cmd)


def _scan_nd_parser(sub, ndim: int):
    p = sub.add_parser(f"scan{ndim}d",
                       help=f"{ndim}-D relaxed distance-grid scan.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--scan", dest="scans", action="append", default=[],
                   help=f"Axis 'i,j,end[,step[,start]]' (exactly {ndim}).")
    if ndim == 3:
        p.add_argument("--csv", dest="csv_path", type=Path, default=None,
                       help="Existing surface.csv to re-plot (alias of "
                            "--plot-only).")
    p.add_argument("--scan-list", dest="scan_list_raw", default=None,
                   help="List of quadruples '[(i,j,low,high),...]'; "
                        "alternative to --scan.")
    p.add_argument("--max-step-size", type=float, default=0.20,
                   help="Largest grid step of an axis without its own "
                        "[Angstrom].")
    p.add_argument("--opt-mode", default="light",
                   choices=["light", "heavy", "lbfgs", "rfo"],
                   type=str.lower,
                   help="Grid relaxation: light|lbfgs or heavy|rfo.")
    p.add_argument("--thresh", default="baker",
                   help="Relaxation convergence preset.")
    p.add_argument("--preopt", type=_bool, default=True,
                   help="Unbiased optimization before the scan.")
    p.add_argument("--plot-only", type=Path, default=None,
                   help="Re-plot an existing surface.csv.")
    p.add_argument("--bias-k", type=float, default=100.0,
                   help="Harmonic well strength k [eV/Angstrom^2].")
    p.add_argument("--relax-max-cycles", type=int, default=10000,
                   help="Cycle cap of each grid relaxation.")
    p.add_argument("--one-based", type=_bool, default=True,
                   help="Integer (i, j) axis indices are 1-based.")
    p.add_argument("--baseline", default="min", choices=["min", "first"],
                   help="Zero of the plotted surface.")
    p.add_argument("--zmin", type=float, default=None,
                   help="Lower colour-scale bound [kcal/mol].")
    p.add_argument("--zmax", type=float, default=None,
                   help="Upper colour-scale bound [kcal/mol].")
    _common_options(p)
    p.set_defaults(func=scan_nd_cmd, ndim=ndim)


def _dft_parser(sub):
    p = sub.add_parser("dft", help="DFT single point (CPU PySCF, or the "
                                   "built-in RHF/STO-3G engine).")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--func", default="wb97m-v")
    p.add_argument("--basis", default="def2-svp")
    p.add_argument("--func-basis", default=None,
                   help="'FUNC/BASIS'; overrides --func and --basis.")
    p.add_argument("--max-cycle", type=int, default=100,
                   help="Largest number of SCF iterations.")
    p.add_argument("--conv-tol", type=float, default=1e-9,
                   help="SCF convergence tolerance [Hartree].")
    p.add_argument("--grid-level", type=int, default=3,
                   help="Integration grid level (PySCF grids.level).")
    p.add_argument("--engine", default="cpu", type=str.lower,
                   choices=["gpu", "cpu", "auto", "mini"],
                   help="cpu: PySCF on the CPU; gpu and auto take it too "
                        "(no gpu4pyscf backend is ported); mini: the "
                        "built-in RHF/STO-3G engine (H and He) on --device.")
    _common_options(p)
    p.set_defaults(func=dft_cmd)


def _path_opt_parser(sub):
    p = sub.add_parser("path-opt",
                       help="Two-endpoint MEP search (GSM or DMF).")
    p.add_argument("-i", "--input", dest="input_paths", action="append",
                   required=True, type=Path,
                   help="An endpoint; give it twice.")
    p.add_argument("--mep-mode", default="gsm", choices=["gsm", "dmf"])
    p.add_argument("--max-nodes", type=int, default=10)
    p.add_argument("--max-cycles", type=int, default=300,
                   help="String-optimizer cycle cap.")
    p.add_argument("--opt-mode", default="light",
                   help="Endpoint preoptimization mode: light|lbfgs "
                        "or heavy|rfo.")
    p.add_argument("--thresh", default=None,
                   help="Convergence preset for the string optimizer and "
                        "endpoint preopt.")
    p.add_argument("--preopt", type=_bool, default=False,
                   help="Preoptimize each endpoint before alignment + GSM.")
    p.add_argument("--preopt-max-cycles", type=int, default=10000)
    p.add_argument("--align", type=_bool, default=True)
    p.add_argument("--climb", type=_bool, default=True,
                   help="Enable the GSM climbing image.")
    p.add_argument("--fix-ends", type=_bool, default=False,
                   help="Keep endpoint images fixed during GSM.")
    p.add_argument("--gsm-loop", default="auto",
                   choices=["auto", "device", "host"],
                   help="GSM loop: device (captured CUDA graphs a phase), "
                        "host (a host read a cycle) or auto (the "
                        "calculator's: device, host for eSCN).")
    _common_options(p)
    p.set_defaults(func=path_opt_cmd)


def _search_options(p) -> None:
    p.add_argument("--mep-mode", default="gsm", choices=["gsm", "dmf"])
    p.add_argument("--max-nodes", type=int, default=10)
    p.add_argument("--max-cycles", type=int, default=300,
                   help="String-optimizer cycle cap per segment.")
    p.add_argument("--opt-mode", default="light",
                   choices=["light", "heavy", "lbfgs", "rfo"],
                   type=str.lower,
                   help="Optimizer of the preopt and HEI refinements: "
                        "light|lbfgs or heavy|rfo.")
    p.add_argument("--thresh", default=None,
                   help="Convergence preset for in-search optimizations.")
    p.add_argument("--preopt", type=_bool, default=True,
                   help="Optimize each input before the search.")
    p.add_argument("--climb", type=_bool, default=True)
    p.add_argument("--gsm-loop", default="auto",
                   choices=["auto", "device", "host"],
                   help="GSM loop: device (captured CUDA graphs a phase), "
                        "host (a host read a cycle) or auto (the "
                        "calculator's: device, host for eSCN).")


def _path_search_parser(sub):
    p = sub.add_parser("path-search",
                       help="Recursive multi-step MEP search between "
                            "structures.")
    p.add_argument("-i", "--input", dest="input_paths", action="append",
                   required=True, type=Path,
                   help="A structure, in reaction order; give two or more.")
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--refine-mode", default="hei", choices=["hei", "minima"])
    p.add_argument("--kink-max-nodes", type=int, default=5)
    p.add_argument("--align", type=_bool, default=True,
                   help="Align all inputs to the first after preopt.")
    p.add_argument("--ref-full-pdb", action="append", default=None,
                   type=Path,
                   help="Full-system PDB template(s) for merged outputs; "
                        "one, or one per input in reaction order.")
    _search_options(p)
    _common_options(p)
    p.set_defaults(func=path_search_cmd)


def _tsopt_parser(sub):
    p = sub.add_parser("tsopt", help="Transition-state optimization "
                                     "(Hessian dimer or RS-I-RFO).")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--opt-mode", default="light",
                   help="light|dimer or heavy|rsirfo.")
    p.add_argument("--coord-type", default="cart", choices=["cart", "dlc"],
                   help="Coordinates of the rsirfo mode; the dimer runs "
                        "Cartesian.")
    p.add_argument("--thresh", default="baker")
    p.add_argument("--max-cycles", type=int, default=10000)
    p.add_argument("--flatten-imag-mode", type=_bool, default=False,
                   help="Run the extra-imaginary-mode flatten loop (light "
                        "mode; False sets flatten_max_iter=0).")
    p.add_argument("--dump-restart", type=int, default=0,
                   help="Dump dimer-pass carries every N cycles for a "
                        "mid-run restart; 0 disables.")
    _common_options(p)
    p.set_defaults(func=tsopt_cmd)


def _freq_parser(sub):
    p = sub.add_parser("freq", help="Vibrational analysis and "
                                    "thermochemistry.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("-T", "--temperature", type=float, default=298.15)
    p.add_argument("--pressure", type=float, default=101325.0)
    p.add_argument("--max-write-modes", "--max-write",
                   dest="max_write_modes", type=int, default=10,
                   help="How many modes to export (after --sort).")
    p.add_argument("--amplitude-ang", type=float, default=0.8,
                   help="Mode-animation amplitude [Angstrom].")
    p.add_argument("--n-frames", type=int, default=20,
                   help="Frames per mode animation.")
    p.add_argument("--sort", dest="sort_modes", default="value",
                   choices=["value", "abs"],
                   help="Export order: by value or by absolute value.")
    _common_options(p)
    p.set_defaults(func=freq_cmd)


def _irc_parser(sub):
    p = sub.add_parser("irc", help="Intrinsic reaction coordinate "
                                   "(EulerPC).")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--step-length", "--step-size", dest="step_length",
                   type=float, default=0.10,
                   help="Step length in mass-weighted coordinates.")
    p.add_argument("--max-cycles", type=int, default=125)
    p.add_argument("--root", type=int, default=0,
                   help="Imaginary-mode index of the first displacement.")
    p.add_argument("--forward", type=_bool, default=True)
    p.add_argument("--backward", type=_bool, default=True)
    p.add_argument("--hessian-recalc", type=int, default=None,
                   help="Exact Hessian every N cycles of a branch; default "
                        "Bofill updates from the TS Hessian alone.")
    p.add_argument("--dump-restart", type=int, default=0,
                   help="Dump the branch carry every N cycles for a "
                        "mid-run restart; 0 disables.")
    _common_options(p)
    p.set_defaults(func=irc_cmd)


def _all_parser(sub):
    p = sub.add_parser("all", help="End-to-end pipeline: extract -> path "
                                   "search -> tsopt -> irc -> freq (the "
                                   "default subcommand).")
    p.add_argument("-i", "--input", dest="input_paths", action="append",
                   required=True, type=Path)
    p.add_argument("-c", "--center", default=None,
                   help="Substrate spec for pocket extraction (PDB inputs).")
    p.add_argument("-r", "--radius", type=float, default=2.6,
                   help="Extraction cutoff [Angstrom] around the substrate.")
    p.add_argument("--radius-het2het", type=float, default=0.0,
                   help="Independent hetero-hetero cutoff [Angstrom].")
    p.add_argument("--include-H2O", "--include-h2o", dest="include_h2o",
                   type=_bool, default=True)
    p.add_argument("--exclude-backbone", type=_bool, default=True)
    p.add_argument("--add-linkH", "--add-linkh", dest="add_link_h",
                   type=_bool, default=True)
    p.add_argument("--selected_resn", "--selected-resn",
                   dest="selected_resn", default="",
                   help="Force-include residue IDs (comma separated).")
    p.add_argument("--scan-lists", dest="scan_lists", action="append",
                   default=[],
                   help="Stage spec 'i,j,target[;k,l,target]' (repeatable) "
                        "in full-structure indices: stage 1b scans one "
                        "input to make the second endpoint.")
    p.add_argument("--one-based", type=_bool, default=True,
                   help="Integer --scan-lists indices are 1-based.")
    p.add_argument("--scan-one-based", type=_bool, default=None,
                   help="Overrides --one-based for the scan.")
    p.add_argument("--refine-path", type=_bool, default=True)
    p.add_argument("--tsopt", dest="do_tsopt", type=_bool, default=False,
                   help="TS optimization + IRC per reactive segment.")
    p.add_argument("--irc", dest="do_irc", type=_bool, default=True,
                   help="Run the IRC when --tsopt True.")
    p.add_argument("--thermo", "--freq", dest="do_freq", type=_bool,
                   default=False,
                   help="Frequencies and thermochemistry of R, TS and P "
                        "per reactive segment.")
    p.add_argument("--dft", dest="do_dft", type=_bool, default=False,
                   help="DFT single points of R, TS and P per reactive "
                        "segment.")
    p.add_argument("--ref-full-pdb", type=Path, default=None,
                   help="Full-system PDB template for merged mirrors.")
    p.add_argument("--verbose", type=_bool, default=True)
    p.add_argument("--opt-mode-post", default="heavy",
                   choices=["light", "heavy", "lbfgs", "rfo"],
                   type=str.lower,
                   help="Optimizer of the stage-4 TSOPT and endpoint "
                        "minimization (heavy = RS-I-RFO).")
    p.add_argument("--thresh-post", default="baker")
    p.add_argument("--tsopt-max-cycles", type=int, default=10000)
    p.add_argument("--flatten-imag-mode", type=_bool, default=False)
    p.add_argument("--freq-temperature", type=float, default=298.15)
    p.add_argument("--freq-pressure", type=float, default=101325.0)
    p.add_argument("--freq-max-write", type=int, default=None)
    p.add_argument("--freq-amplitude-ang", type=float, default=None)
    p.add_argument("--freq-n-frames", type=int, default=None)
    p.add_argument("--freq-sort", choices=["value", "abs"], default=None)
    # None keeps the scan command's own default
    p.add_argument("--scan-bias-k", type=float, default=None)
    p.add_argument("--scan-preopt", type=_bool, default=None)
    p.add_argument("--scan-endopt", type=_bool, default=None)
    p.add_argument("--scan-max-step-size", type=float, default=None)
    p.add_argument("--scan-relax-max-cycles", type=int, default=None)
    p.add_argument("--dft-func-basis", default=None,
                   help="'FUNC/BASIS' of the stage-4 DFT single points.")
    p.add_argument("--dft-max-cycle", type=int, default=100)
    p.add_argument("--dft-conv-tol", type=float, default=1e-9)
    p.add_argument("--dft-grid-level", type=int, default=3)
    p.add_argument("--dft-engine", default="gpu", type=str.lower,
                   choices=["gpu", "cpu", "auto", "mini"],
                   help="SCF engine: gpu, auto and cpu run PySCF on the CPU "
                        "(no gpu4pyscf backend is ported); mini the "
                        "built-in RHF/STO-3G engine on --device.")
    for name in ("--scan-out-dir", "--tsopt-out-dir", "--freq-out-dir",
                 "--dft-out-dir"):
        p.add_argument(name, type=Path, default=None)
    _search_options(p)
    _common_options(p)
    p.set_defaults(func=all_cmd)


def _extract_parser(sub):
    p = sub.add_parser("extract", help="Extract the active-site pocket "
                                       "around a substrate.")
    p.add_argument("-i", "--input", dest="inputs", action="append",
                   required=True, type=Path)
    p.add_argument("-c", "--center", required=True,
                   help="Substrate: PDB path, residue IDs, or residue "
                        "names.")
    p.add_argument("-o", "--output", dest="outputs", action="append",
                   default=[], type=Path)
    p.add_argument("--radius", type=float, default=2.6)
    p.add_argument("--radius-het2het", type=float, default=0.0)
    p.add_argument("--include-h2o", type=_bool, default=True)
    p.add_argument("--exclude-backbone", type=_bool, default=True)
    p.add_argument("--add-linkh", dest="add_link_h", type=_bool,
                   default=True)
    p.add_argument("--selected-resn", default="",
                   help="Force-include residue IDs (comma separated).")
    p.add_argument("--ligand-charge", default=None,
                   help="Total number or 'RES:Q,RES2:Q2' mapping.")
    p.add_argument("--verbose", type=_bool, default=True)
    p.add_argument("--device", default="cuda",
                   help="Device of the radius queries: cuda (default) or "
                        "cpu.")
    p.set_defaults(func=extract_cmd)


def _add_elem_parser(sub):
    p = sub.add_parser("add-elem-info",
                       help="Fill or repair PDB element columns 77-78.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("-o", "--output", "--out", dest="output_path",
                   default=None, type=Path)
    p.add_argument("--overwrite", type=_bool, default=False,
                   help="Write back to the input file.")
    p.add_argument("--verbose", type=_bool, default=True)
    p.set_defaults(func=add_elem_cmd)


def _trj2fig_parser(sub):
    p = sub.add_parser("trj2fig", help="Energy profile figure from a "
                                       "trajectory.")
    p.add_argument("-i", "--input", dest="trj_path", required=True,
                   type=Path)
    p.add_argument("-o", "--out", dest="outs", action="append", default=[],
                   help="Output file(s) [.png/.svg/.pdf/.html/.csv]; "
                        "repeatable.")
    p.add_argument("--reference", default="first",
                   choices=["first", "min", "last", "none"])
    p.add_argument("--unit", default="kcal", choices=["kcal", "au"])
    p.add_argument("--recompute", type=_bool, default=False)
    p.add_argument("--reverse-x", type=_bool, default=False,
                   help="Reverse the x-axis (last frame on the left).")
    _common_options(p)
    p.set_defaults(func=trj2fig_cmd)


def _align_parser(sub):
    p = sub.add_parser("align-freeze-atoms",
                       help="Kabsch-align structures on their freeze-atom "
                            "union.")
    p.add_argument("-i", "--input", dest="inputs", action="append",
                   required=True, type=Path)
    p.add_argument("-o", "--out-dir", dest="out_dir",
                   default=Path("./result_align/"), type=Path)
    p.add_argument("--freeze-atoms", default="")
    p.add_argument("--relax", type=_bool, default=False,
                   help="Relax between drag-refine steps with the "
                        "calculator.")
    p.add_argument("-q", "--charge", type=int, default=None)
    p.add_argument("-s", "--spin", type=int, default=None)
    p.add_argument("--calc-mode", default="uma",
                   choices=["uma", "morse", "lj"])
    p.add_argument("--model", default="uma-s-1p1")
    p.add_argument("--relax-max-cycles", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.set_defaults(func=align_cmd)


def _reject_unported(a, supported=()) -> None:
    unported = {
        "--dump-restart": ("--dump-restart" not in supported
                           and getattr(a, "dump_restart", 0) != 0),
        "--dump": "--dump" not in supported and a.dump,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise SystemExit(f"{', '.join(bad)} {_LATER}")


def _charge_spin(a):
    """-q and -s as given: a missing charge stays None, and the workflow
    takes it from a .gjf template or --ligand-charge, or refuses."""
    spin = a.spin if a.spin is not None else a.multiplicity
    return a.charge, spin


def _yaml(a, cfg: Dict[str, Any], candidates) -> Dict[str, Any]:
    """``--args-yaml`` sections merged into ``cfg`` (YAML wins)."""
    if a.args_yaml:
        apply_yaml_overrides(cfg, load_yaml_dict(a.args_yaml), candidates)
    return cfg


def _calc_opts(a) -> Dict[str, Any]:
    """Calculator and input options every workflow takes."""
    return dict(freeze_atoms=parse_freeze(a.freeze_atoms),
                auto_freeze_links=a.auto_freeze_links,
                calc_mode=a.calc_mode, model=a.model, device=a.device)


def make_mesh_or_none(workers: int, spatial: int = 1, *, cmd: str = "opt",
                      device="cuda", timeout_s: float = 600.0):
    """--workers W --spatial S -> the ("data", "model") mesh of W x S
    ranks this process joins, or None for one process: the JAX CLI's
    ``make_mesh_or_none``. ``PDB2R_TPU_DISTRIBUTED=1`` joins every process
    of a multi-host job (``PDB2R_TPU_COORDINATOR=host:port``,
    ``PDB2R_TPU_NUM_PROCS`` and ``PDB2R_TPU_PROC_ID``, else the torchrun
    variables) and builds the mesh over all of them, data across hosts. Otherwise the torchrun world (WORLD_SIZE) must be W x S ranks,
    else this exits naming the torchrun line. The collectives time out
    after ``timeout_s``, so a rank that diverges fails the run."""
    from .parallel import initialize_distributed, make_mesh
    workers, spatial = max(int(workers or 1), 1), max(int(spatial or 1), 1)
    env = os.environ
    if workers > 1 and spatial > 1:
        print(f"[ranks] NOTE: --workers {workers} has no effect beside "
              f"--spatial {spatial} (a sharded calculator runs its batches "
              "image by image)", file=sys.stderr)
    if env.get("PDB2R_TPU_DISTRIBUTED") == "1":
        coord = env.get("PDB2R_TPU_COORDINATOR")
        if coord:
            initialize_distributed(coord, int(env["PDB2R_TPU_NUM_PROCS"]),
                                   int(env["PDB2R_TPU_PROC_ID"]),
                                   device=device, timeout_s=timeout_s)
        else:
            initialize_distributed(device=device, timeout_s=timeout_s)
        return make_mesh(model=spatial)
    n = workers * spatial
    ws = int(env.get("WORLD_SIZE", "1"))
    if ws != n:
        raise SystemExit(
            f"--workers {workers} --spatial {spatial} runs one process per "
            f"rank: launch with `torchrun --nproc-per-node {n} -m "
            f"pdb2reaction_tpu_torch {cmd} ...` (WORLD_SIZE is {ws})")
    if n == 1:
        return None
    initialize_distributed(device=device, timeout_s=timeout_s)
    return make_mesh(data=workers, model=spatial)


@contextlib.contextmanager
def _ranks(a, cmd: str):
    """The command's mesh (None for one process) while it runs: ranks
    above 0 print nothing, and at the end the process group is left and
    the rank's scratch tree removed."""
    from .parallel import is_main_rank, shutdown
    from .workflows.common import drop_scratch
    mesh = make_mesh_or_none(a.workers, a.spatial, cmd=cmd, device=a.device)
    try:
        if is_main_rank():
            yield mesh
        else:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                yield mesh
    finally:
        shutdown()
        drop_scratch()


def opt_cmd(a) -> int:
    from .workflows.opt import run_opt
    _reject_unported(a, supported=("--dump", "--dump-restart"))
    charge, spin = _charge_spin(a)
    cfg = dict(opt_mode=normalize_choice(a.opt_mode),
               coord_type=a.coord_type, thresh=a.thresh,
               max_cycles=a.max_cycles, dump=a.dump, bias_k=a.bias_k,
               dump_restart=a.dump_restart)
    _yaml(a, cfg, [("opt",), ("lbfgs",), ("rfo",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, "opt") as mesh:
        res = run_opt(
            a.input_path, charge=charge, spin=spin,
            dist_freeze=_parse_pairs(a.dist_freeze, a.one_based) or None,
            spatial=a.spatial, mesh=mesh,
            out_dir=a.out_dir or "./result_opt/",
            convert_files=a.convert_files, **_calc_opts(a), **cfg)
    return 0 if res["converged"] else 3


def scan_cmd(a) -> int:
    from .workflows.scan import run_scan
    _reject_unported(a, supported=("--dump",))
    charge, spin = _charge_spin(a)
    stages = _parse_scan_stages(a.scan_lists, a.one_based)
    cfg: Dict[str, Any] = dict(step_ang=a.step_ang, bias_k=a.bias_k,
                               preopt=a.preopt, endopt=a.endopt,
                               relax_max_cycles=a.relax_max_cycles,
                               dump=a.dump)
    _yaml(a, cfg, [("scan",), ("bias",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, "scan") as mesh:
        run_scan(a.input_path, stages, charge=charge, spin=spin,
                 spatial=a.spatial, mesh=mesh,
                 out_dir=a.out_dir or "./result_scan/", **_calc_opts(a),
                 **cfg)
    return 0


def _no_yaml(a, cmd: str) -> None:
    if a.args_yaml:
        raise SystemExit(f"{cmd} reads no --args-yaml (nor does the JAX "
                         "package's): give its options on the command line")


def scan_nd_cmd(a) -> int:
    from .workflows.scan_nd import run_scan_nd
    ndim, cmd = a.ndim, f"scan{a.ndim}d"
    _reject_unported(a)
    _no_yaml(a, cmd)
    plot_only = a.plot_only or getattr(a, "csv_path", None)
    if a.scan_list_raw:
        axes = _parse_scan_list(a.scan_list_raw, a.one_based,
                                a.max_step_size)
    else:
        if not a.scans and not plot_only:
            raise SystemExit(f"{cmd} needs --scan axes or --scan-list")
        axes = _scan_axes(a.scans, a.one_based)
        for ax in axes:
            ax.setdefault("step", a.max_step_size)
    if not plot_only and len(axes) != ndim:
        raise SystemExit(f"{cmd} needs exactly {ndim} axes, got {len(axes)}")
    charge, spin = _charge_spin(a)
    with _ranks(a, cmd) as mesh:
        run_scan_nd(a.input_path, axes, charge=charge, spin=spin,
                    out_dir=a.out_dir, plot_only=plot_only, bias_k=a.bias_k,
                    relax_max_cycles=a.relax_max_cycles,
                    relax_mode=normalize_choice(a.opt_mode),
                    relax_thresh=a.thresh, preopt=a.preopt,
                    baseline=a.baseline, zmin=a.zmin, zmax=a.zmax,
                    hessian_calc_mode=a.hessian_calc_mode,
                    spatial=a.spatial, mesh=mesh, **_calc_opts(a))
    return 0


def dft_cmd(a) -> int:
    from .workflows.dft import ScfNotConverged, run_dft
    _reject_unported(a)
    _no_yaml(a, "dft")
    func, basis = a.func, a.basis
    if a.func_basis:
        func, basis = _split_func_basis(a.func_basis)
    if a.engine in ("gpu", "auto"):
        print("[dft] NOTE: no gpu4pyscf backend is ported; using PySCF on "
              "the CPU (the reference's own fallback)")
    charge, spin = _charge_spin(a)
    try:
        with _ranks(a, "dft"):
            run_dft(a.input_path, charge=charge, spin=spin, func=func,
                    basis=basis, max_cycle=a.max_cycle, conv_tol=a.conv_tol,
                    grid_level=a.grid_level, engine=a.engine,
                    device=a.device, out_dir=a.out_dir or "./result_dft/")
    except ScfNotConverged as e:
        print(f"[dft] ERROR: {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"[dft] ERROR: {e}", file=sys.stderr)
        return 2
    return 0


def path_opt_cmd(a) -> int:
    from .workflows.path_opt import run_path_opt
    _reject_unported(a)
    if len(a.input_paths) != 2:
        raise SystemExit("path-opt takes exactly two endpoints: -i A -i B")
    charge, spin = _charge_spin(a)
    cfg: Dict[str, Any] = dict(
        mep_mode=a.mep_mode, preopt=a.preopt, align=a.align,
        preopt_mode=normalize_choice(a.opt_mode), thresh=a.thresh,
        preopt_max_cycles=a.preopt_max_cycles,
        stopt_kw={"max_cycles": a.max_cycles},
        gs_kw={"max_nodes": a.max_nodes, "climb": a.climb,
               "fix_ends": a.fix_ends, "loop": a.gsm_loop})
    _yaml(a, cfg, [("gs",), ("sopt",), ("dmf",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, "path-opt") as mesh:
        res = run_path_opt(
            list(a.input_paths), charge=charge, spin=spin,
            spatial=a.spatial, mesh=mesh,
            out_dir=a.out_dir or "./result_path_opt/",
            **_calc_opts(a), **cfg)
    return 0 if res["converged"] else 3


def path_search_cmd(a) -> int:
    from .workflows.path_search import run_path_search
    _reject_unported(a)
    if len(a.input_paths) < 2:
        raise SystemExit("path-search takes two or more structures: "
                         "-i A -i B [-i C ...]")
    charge, spin = _charge_spin(a)
    skw = {"max_depth": a.max_depth, "refine_mode": a.refine_mode,
           "kink_max_nodes": a.kink_max_nodes,
           "opt_mode": normalize_choice(a.opt_mode), "preopt": a.preopt}
    if a.thresh is not None:
        skw["opt_thresh"] = a.thresh
    ref_full = a.ref_full_pdb
    if ref_full is not None:
        ref_full = list(ref_full) if len(ref_full) > 1 else ref_full[0]
    cfg: Dict[str, Any] = dict(
        mep_mode=a.mep_mode, full_template=ref_full, align=a.align,
        stopt_kw={"max_cycles": a.max_cycles},
        gs_kw={"max_nodes": a.max_nodes, "climb": a.climb,
               "loop": a.gsm_loop},
        search_kw=skw)
    _yaml(a, cfg, [("search",), ("gs",), ("bond",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, "path-search") as mesh:
        run_path_search(
            list(a.input_paths), charge=charge, spin=spin,
            spatial=a.spatial, mesh=mesh,
            out_dir=a.out_dir or "./result_path_search/",
            **_calc_opts(a), **cfg)
    return 0


def _stage4(a, run, cfg, default_out, ok=lambda res: 0):
    """tsopt, freq and irc: the shared options, --args-yaml, the ranks."""
    charge, spin = _charge_spin(a)
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, a.cmd) as mesh:
        res = run(a.input_path, charge=charge, spin=spin,
                  spatial=a.spatial, mesh=mesh,
                  out_dir=a.out_dir or default_out, **_calc_opts(a), **cfg)
    return ok(res)


def tsopt_cmd(a) -> int:
    from .workflows.tsopt import run_tsopt
    _reject_unported(a, supported=("--dump-restart",))
    cfg = dict(opt_mode=a.opt_mode, coord_type=a.coord_type,
               thresh=a.thresh, max_cycles=a.max_cycles,
               dump_restart=a.dump_restart,
               hessian_dimer_kw={"flatten_max_iter":
                                 10 if a.flatten_imag_mode else 0})
    _yaml(a, cfg, [("tsopt",), ("hessian_dimer",), ("rsirfo",)])
    return _stage4(a, run_tsopt, cfg, "./result_tsopt/",
                   lambda res: 0 if res["converged"] else 3)


def freq_cmd(a) -> int:
    from .workflows.freq import run_freq
    _reject_unported(a)
    cfg = dict(temperature=a.temperature, pressure=a.pressure,
               max_write_modes=a.max_write_modes,
               amplitude_ang=a.amplitude_ang, n_frames=a.n_frames,
               sort_modes=a.sort_modes)
    _yaml(a, cfg, [("freq",)])
    return _stage4(a, run_freq, cfg, "./result_freq/")


def irc_cmd(a) -> int:
    from .workflows.irc import run_irc
    _reject_unported(a, supported=("--dump-restart",))
    cfg = dict(step_length=a.step_length, max_cycles=a.max_cycles,
               root=a.root, forward=a.forward, backward=a.backward,
               hessian_recalc=a.hessian_recalc, dump_restart=a.dump_restart)
    _yaml(a, cfg, [("irc",)])
    return _stage4(a, run_irc, cfg, "./result_irc/")


def all_cmd(a) -> int:
    from .workflows import common
    from .workflows.allflow import run_all
    _reject_unported(a)
    # all takes --ligand-charge at the extraction and hands the charge to
    # every stage: nested stages never see the process default (their
    # intermediates are .xyz files, where it is refused)
    ligand_charge = common.get_default_ligand_charge()
    common.set_default_ligand_charge(None)
    charge, spin = _charge_spin(a)
    scan_ob = a.one_based if a.scan_one_based is None else a.scan_one_based
    dft_kw: Dict[str, Any] = dict(max_cycle=a.dft_max_cycle,
                                  conv_tol=a.dft_conv_tol,
                                  grid_level=a.dft_grid_level,
                                  engine=a.dft_engine)
    if a.dft_func_basis:
        dft_kw["func"], dft_kw["basis"] = _split_func_basis(a.dft_func_basis)
    freq_kw: Dict[str, Any] = dict(temperature=a.freq_temperature,
                                   pressure=a.freq_pressure)
    for key, val in (("max_write_modes", a.freq_max_write),
                     ("amplitude_ang", a.freq_amplitude_ang),
                     ("n_frames", a.freq_n_frames),
                     ("sort_modes", a.freq_sort)):
        if val is not None:
            freq_kw[key] = val
    cfg: Dict[str, Any] = dict(
        center=a.center, ligand_charge=ligand_charge,
        scan_stages=_parse_scan_stages(a.scan_lists, scan_ob) or None,
        mep_mode=a.mep_mode, refine_path=a.refine_path, tsopt=a.do_tsopt,
        do_irc=a.do_irc, do_freq=a.do_freq, do_dft=a.do_dft,
        opt_mode=normalize_choice(a.opt_mode), thresh=a.thresh,
        max_cycles=a.max_cycles, preopt=a.preopt, verbose=a.verbose,
        full_template=a.ref_full_pdb,
        extract_kw=dict(
            radius=a.radius, radius_het2het=a.radius_het2het,
            include_h2o=a.include_h2o, exclude_backbone=a.exclude_backbone,
            add_link_h=a.add_link_h,
            selected_resn=[t for t in a.selected_resn.split(",")
                           if t.strip()] or None),
        gs_kw={"max_nodes": a.max_nodes, "climb": a.climb,
               "loop": a.gsm_loop},
        scan_kw={k: v for k, v in dict(
            bias_k=a.scan_bias_k, preopt=a.scan_preopt,
            endopt=a.scan_endopt, step_ang=a.scan_max_step_size,
            relax_max_cycles=a.scan_relax_max_cycles).items()
            if v is not None},
        opt_post_kw=dict(opt_mode=normalize_choice(a.opt_mode_post),
                         thresh=a.thresh_post),
        tsopt_kw=dict(max_cycles_total=a.tsopt_max_cycles,
                      flatten_max_iter=10 if a.flatten_imag_mode else 0),
        freq_kw=freq_kw, dft_kw=dft_kw, scan_out_dir=a.scan_out_dir,
        tsopt_out_dir=a.tsopt_out_dir, freq_out_dir=a.freq_out_dir,
        dft_out_dir=a.dft_out_dir)
    _yaml(a, cfg, [("all",), ("search",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    with _ranks(a, "all") as mesh:
        run_all(list(a.input_paths), charge=charge, spin=spin,
                spatial=a.spatial, mesh=mesh,
                out_dir=a.out_dir or "./result_all/", **_calc_opts(a),
                **cfg)
    return 0


def extract_cmd(a) -> int:
    from .bio.extract import extract_api
    res = extract_api(
        list(a.inputs), a.center, list(a.outputs) or None,
        radius=a.radius, radius_het2het=a.radius_het2het,
        include_h2o=a.include_h2o, exclude_backbone=a.exclude_backbone,
        add_link_h=a.add_link_h,
        selected_resn=[t for t in a.selected_resn.split(",") if t.strip()]
        or None, ligand_charge=a.ligand_charge, verbose=a.verbose,
        device=a.device)
    print(f"[extract] wrote {res['outputs']}")
    print(f"[extract] charge summary: {res['charge_summary']}")
    return 0


def add_elem_cmd(a) -> int:
    from .bio.add_elem import assign_elements
    out = a.output_path
    if a.overwrite and out is None:
        out = a.input_path
    assign_elements(a.input_path, out, verbose=a.verbose)
    return 0


def trj2fig_cmd(a) -> int:
    from .workflows.trj2fig import run_trj2fig
    out_path = None
    if a.outs:
        out_path = Path(a.outs[0])
    elif a.out_dir:
        out_path = Path(a.out_dir) / "profile.png"
    charge, spin = _charge_spin(a)
    res = run_trj2fig(a.trj_path, reference=a.reference, unit=a.unit,
                      recompute=a.recompute, charge=charge, spin=spin,
                      calc_mode=a.calc_mode, model=a.model,
                      device=a.device, reverse_x=a.reverse_x,
                      out_path=out_path, extra_outputs=list(a.outs[1:]))
    print(f"[trj2fig] wrote {res['figure']}")
    return 0


def align_cmd(a) -> int:
    import numpy as np

    from .bio.align import align_sequence_inplace
    from .constants import BOHR2ANG
    from .core import io_pdb, io_xyz
    from .workflows import common
    structs = [common.load_structure(p) for p in a.inputs]
    for st in structs:
        st.freeze = common.merge_freeze(st, parse_freeze(a.freeze_atoms),
                                        True)
    relax_fn = None
    if a.relax:
        from .workflows.opt import optimize_structure
        q, s = common.resolve_charge_spin(structs[0], a.charge, a.spin)

        def relax_fn(st, pinned_idx):
            st2 = st.copy()
            st2.freeze = sorted(set(st.freeze) | set(pinned_idx))
            calc = common.make_calculator(
                st2, calc_mode=a.calc_mode, charge=q, spin=s,
                freeze_atoms=st2.freeze, model=a.model, device=a.device)
            coords_bohr, _, _, _ = optimize_structure(
                st2, calc, opt_mode="lbfgs", thresh="gau_loose",
                max_cycles=a.relax_max_cycles)
            return np.asarray(coords_bohr) * BOHR2ANG

    align_sequence_inplace(structs, relax_fn=relax_fn)
    out = Path(a.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for p, st in zip(a.inputs, structs):
        dst = out / Path(p).name
        if str(p).lower().endswith(".pdb"):
            io_pdb.write_pdb(dst, st)
        else:
            io_xyz.write_xyz(dst, st)
        print(f"[align] wrote {dst}")
    return 0


def _run(a) -> int:
    """One command with its process-wide defaults (--ref-pdb,
    --ligand-charge, --convert-files) set for the call and cleared
    after, inside a --profile trace when one is asked for."""
    if not hasattr(a, "args_yaml"):     # commands without common options
        return a.func(a)
    from .runtime.profiling import trace
    from .workflows import common
    if a.freeze_links is not None:
        a.auto_freeze_links = a.freeze_links
    common.set_default_ref_pdb(a.ref_pdb)
    common.set_default_ligand_charge(a.ligand_charge)
    common.set_convert_enabled(a.convert_files)
    try:
        with trace(a.profile):
            return a.func(a)
    finally:
        common.set_default_ref_pdb(None)
        common.set_default_ligand_charge(None)
        common.set_convert_enabled(True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pdb2r-torch",
        description="pdb2reaction_tpu_torch: the PyTorch/CUDA port. With "
                    "no subcommand, the arguments go to `all`.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _all_parser(sub)
    _opt_parser(sub)
    _scan_parser(sub)
    _scan_nd_parser(sub, 2)
    _scan_nd_parser(sub, 3)
    _path_opt_parser(sub)
    _path_search_parser(sub)
    _tsopt_parser(sub)
    _freq_parser(sub)
    _irc_parser(sub)
    _dft_parser(sub)
    _extract_parser(sub)
    _add_elem_parser(sub)
    _trj2fig_parser(sub)
    _align_parser(sub)
    parser.commands = set(sub.choices)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in parser.commands \
            and argv[0] not in ("-h", "--help"):
        argv = ["all"] + argv           # the default subcommand
    a = parser.parse_args(argv)
    sys.exit(_run(a))
