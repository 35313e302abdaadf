"""Command-line interface of the port: ``all`` (the default), ``opt``,
``path-opt``, ``path-search``, ``tsopt``, ``freq``, ``irc``,
``extract``, ``add-elem-info``, ``trj2fig`` and ``align-freeze-atoms``.

Same flags as the JAX package's (``pdb2reaction_tpu/cli.py``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
A command line that names no subcommand runs ``all``. ``--args-yaml``
overrides any option from the file's sections (YAML wins; see
``workflows/config.py`` for the YAML subset the port reads),
``--ligand-charge`` derives the charge of a PDB input, ``--ref-pdb``
lends a PDB template to .xyz/.gjf inputs and ``--profile DIR`` writes a
torch.profiler Chrome trace. Not ported, and refused with their
ROADMAP.md items: ``scan``, ``scan2d``, ``scan3d`` and
``all --scan-lists`` (queue 1 item 7), ``dft`` and ``all --dft True``
(item 12), DMF (item 11), ``--spatial > 1`` outside ``opt`` (item 9),
``--gsm-loop device``, ``--workers`` and ``--dump``.

    python -m pdb2reaction_tpu_torch -i R.pdb -i P.pdb --center LIG \
        --ligand-charge 0 --model escn-md                   # all
    python -m pdb2reaction_tpu_torch opt -i x.xyz -q 0      # uma-s-1p1
    python -m pdb2reaction_tpu_torch path-search -i a.xyz -i b.xyz \
        -q 0 --calc-mode morse --device cpu                 # recursive MEPs
    python -m pdb2reaction_tpu_torch tsopt -i ts.xyz -q 0 \
        --opt-mode heavy --model escn-md                    # RS-I-RFO
    python -m pdb2reaction_tpu_torch extract -i c.pdb -c LIG -o p.pdb

``opt --spatial N`` shards the atom axis over N ranks, one process each,
launched by ``torchrun`` (WORLD_SIZE must equal N). Every rank runs the
same L-BFGS loop on the same forces; rank 0 alone logs and writes
``result_opt/``:

    torchrun --nproc-per-node 4 -m pdb2reaction_tpu_torch opt -i x.xyz \
        -q 0 --spatial 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .workflows.config import (apply_yaml_overrides, load_yaml_dict,
                               normalize_choice)

_LATER = "is not ported yet (see ROADMAP.md)"
# the subcommands still to port: what each is, its ROADMAP.md queue 1 item
_UNPORTED = {"scan": ("the staged 1-D scan", 7),
             "scan2d": ("the 2-D distance-grid scan", 7),
             "scan3d": ("the 3-D distance-grid scan", 7),
             "dft": ("the DFT single point", 12)}


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
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--workers-per-node", type=int, default=1)
    p.add_argument("--spatial", type=int, default=1,
                   help="Shard the atom axis over N ranks (PaiNN-class "
                        "models; launch under torchrun --nproc-per-node N).")
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
    p.add_argument("--dump-restart", type=int, default=0)
    _common_options(p)
    p.set_defaults(func=opt_cmd)


def _path_opt_parser(sub):
    p = sub.add_parser("path-opt",
                       help="Two-endpoint MEP search (GSM; DMF is not "
                            "ported yet).")
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
                   help="GSM loop: auto and host run the host loop; the "
                        "device loop is not ported yet.")
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
                   help="GSM loop: auto and host run the host loop; the "
                        "device loop is not ported yet.")


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
                   help="Coordinates of the rsirfo mode (dlc is not ported "
                        "yet); the dimer runs Cartesian.")
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
                   default=[], help="Staged scans (not ported yet: "
                                    "ROADMAP.md queue 1 item 7).")
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
                   help="DFT single points (not ported yet: ROADMAP.md "
                        "queue 1 item 12).")
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
    for name in ("--tsopt-out-dir", "--freq-out-dir"):
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
        "--dump": a.dump,
        "--workers": a.workers != 1,
        "--workers-per-node": a.workers_per_node != 1,
        "--gsm-loop device (the GSM device loop, left out of ROADMAP.md "
        "queue 1 item 2)": getattr(a, "gsm_loop", "auto") == "device",
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


def _init_spatial(a, cmd: str) -> None:
    from .parallel import init_spatial
    if a.spatial > 1:
        ws = int(os.environ.get("WORLD_SIZE", "1"))
        if ws != a.spatial:
            raise SystemExit(
                f"--spatial {a.spatial} runs one process per shard: launch "
                f"with `torchrun --nproc-per-node {a.spatial} -m "
                f"pdb2reaction_tpu_torch {cmd} ...` (WORLD_SIZE is {ws})")
        init_spatial(device=a.device)


def opt_cmd(a) -> int:
    from .parallel import shutdown
    from .workflows.opt import run_opt
    _reject_unported(a)
    charge, spin = _charge_spin(a)
    if a.coord_type != "cart":          # before any rank builds a model
        from .workflows.opt import _DLC
        raise SystemExit(_DLC)
    cfg = dict(opt_mode=normalize_choice(a.opt_mode),
               coord_type=a.coord_type, thresh=a.thresh,
               max_cycles=a.max_cycles, bias_k=a.bias_k)
    _yaml(a, cfg, [("opt",), ("lbfgs",), ("rfo",)])
    if a.spatial > 1 and normalize_choice(cfg["opt_mode"]) == "rfo":
        raise SystemExit("opt --opt-mode heavy under atom-axis sharding "
                         "(--spatial > 1): the Hessian over ranks is not "
                         "ported yet, ROADMAP.md queue 1 item 9")
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    _init_spatial(a, "opt")
    try:
        res = run_opt(
            a.input_path, charge=charge, spin=spin,
            dist_freeze=_parse_pairs(a.dist_freeze, a.one_based) or None,
            spatial=a.spatial, out_dir=a.out_dir or "./result_opt/",
            convert_files=a.convert_files, **_calc_opts(a), **cfg)
    finally:
        shutdown()
    return 0 if res["converged"] else 3


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
               "fix_ends": a.fix_ends})
    _yaml(a, cfg, [("gs",), ("sopt",), ("dmf",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    try:
        res = run_path_opt(
            list(a.input_paths), charge=charge, spin=spin,
            spatial=a.spatial, out_dir=a.out_dir or "./result_path_opt/",
            **_calc_opts(a), **cfg)
    except NotImplementedError as e:     # DMF, --spatial > 1
        raise SystemExit(str(e))
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
        gs_kw={"max_nodes": a.max_nodes, "climb": a.climb},
        search_kw=skw)
    _yaml(a, cfg, [("search",), ("gs",), ("bond",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    try:
        run_path_search(
            list(a.input_paths), charge=charge, spin=spin,
            spatial=a.spatial, out_dir=a.out_dir or "./result_path_search/",
            **_calc_opts(a), **cfg)
    except NotImplementedError as e:     # DMF, --spatial > 1
        raise SystemExit(str(e))
    return 0


def _stage4(a, run, cfg, default_out, ok=lambda res: 0):
    """tsopt, freq and irc: the shared options, --args-yaml, refusals."""
    charge, spin = _charge_spin(a)
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    try:
        res = run(a.input_path, charge=charge, spin=spin,
                  spatial=a.spatial, out_dir=a.out_dir or default_out,
                  **_calc_opts(a), **cfg)
    except NotImplementedError as e:     # dlc RS-I-RFO, --spatial > 1
        raise SystemExit(str(e))
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
    from .workflows.allflow import DFT_TODO, SCAN_TODO, run_all
    _reject_unported(a)
    if a.scan_lists:
        raise SystemExit(SCAN_TODO)
    if a.do_dft:
        raise SystemExit(DFT_TODO)
    # all takes --ligand-charge at the extraction and hands the charge to
    # every stage: nested stages never see the process default (their
    # intermediates are .xyz files, where it is refused)
    ligand_charge = common.get_default_ligand_charge()
    common.set_default_ligand_charge(None)
    charge, spin = _charge_spin(a)
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
        mep_mode=a.mep_mode, refine_path=a.refine_path, tsopt=a.do_tsopt,
        do_irc=a.do_irc, do_freq=a.do_freq,
        opt_mode=normalize_choice(a.opt_mode), thresh=a.thresh,
        max_cycles=a.max_cycles, preopt=a.preopt, verbose=a.verbose,
        full_template=a.ref_full_pdb,
        extract_kw=dict(
            radius=a.radius, radius_het2het=a.radius_het2het,
            include_h2o=a.include_h2o, exclude_backbone=a.exclude_backbone,
            add_link_h=a.add_link_h,
            selected_resn=[t for t in a.selected_resn.split(",")
                           if t.strip()] or None),
        gs_kw={"max_nodes": a.max_nodes, "climb": a.climb},
        opt_post_kw=dict(opt_mode=normalize_choice(a.opt_mode_post),
                         thresh=a.thresh_post),
        tsopt_kw=dict(max_cycles_total=a.tsopt_max_cycles,
                      flatten_max_iter=10 if a.flatten_imag_mode else 0),
        freq_kw=freq_kw, tsopt_out_dir=a.tsopt_out_dir,
        freq_out_dir=a.freq_out_dir)
    _yaml(a, cfg, [("all",), ("search",)])
    cfg.setdefault("hessian_calc_mode", a.hessian_calc_mode)
    try:
        run_all(list(a.input_paths), charge=charge, spin=spin,
                spatial=a.spatial, out_dir=a.out_dir or "./result_all/",
                **_calc_opts(a), **cfg)
    except NotImplementedError as e:     # DMF, --spatial > 1
        raise SystemExit(str(e))
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
    _path_opt_parser(sub)
    _path_search_parser(sub)
    _tsopt_parser(sub)
    _freq_parser(sub)
    _irc_parser(sub)
    _extract_parser(sub)
    _add_elem_parser(sub)
    _trj2fig_parser(sub)
    _align_parser(sub)
    for name, (what, item) in _UNPORTED.items():    # listed in --help
        sub.add_parser(name, help=f"{what} (not ported yet: ROADMAP.md "
                                  f"queue 1 item {item}).")
    parser.commands = set(sub.choices)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in parser.commands \
            and argv[0] not in ("-h", "--help"):
        argv = ["all"] + argv           # the default subcommand
    if argv and argv[0] in _UNPORTED and not {"-h", "--help"} & set(argv):
        what, item = _UNPORTED[argv[0]]
        raise SystemExit(f"{argv[0]}: {what} {_LATER}: ROADMAP.md queue 1 "
                         f"item {item}")
    a = parser.parse_args(argv)
    sys.exit(_run(a))
