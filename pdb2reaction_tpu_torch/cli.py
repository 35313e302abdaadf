"""Command-line interface of the port: the ``opt``, ``path-opt``,
``path-search``, ``tsopt``, ``freq`` and ``irc`` subcommands.

Same flags as the JAX package's (``pdb2reaction_tpu/cli.py``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Flags whose features are not ported yet are accepted and raise when used
with a non-default value. The other subcommands are later port items.

    python -m pdb2reaction_tpu_torch opt -i x.xyz -q 0      # uma-s-1p1
    python -m pdb2reaction_tpu_torch path-opt -i a.xyz -i b.xyz -q 0 \
        --model escn-md                                     # GSM MEP
    python -m pdb2reaction_tpu_torch path-search -i a.xyz -i b.xyz \
        -q 0 --calc-mode morse --device cpu                 # recursive MEPs
    python -m pdb2reaction_tpu_torch tsopt -i ts.xyz -q 0 \
        --opt-mode heavy --model escn-md                    # RS-I-RFO
    python -m pdb2reaction_tpu_torch freq -i ts.xyz -q 0    # + thermo
    python -m pdb2reaction_tpu_torch irc -i ts.xyz -q 0     # EulerPC

``opt --spatial N`` shards the atom axis over N ranks, one process each,
launched by ``torchrun`` (WORLD_SIZE must equal N). Every rank runs the
same L-BFGS loop on the same forces; rank 0 alone logs and writes
``result_opt/``. ``path-opt`` refuses ``--spatial`` above 1 (its HVPs
under sharding are a later port item):

    torchrun --nproc-per-node 4 -m pdb2reaction_tpu_torch opt -i x.xyz \
        -q 0 --spatial 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Optional

from .workflows.config import normalize_choice

_LATER = "is not ported yet (see ROADMAP.md)"


def _bool(v: str) -> bool:
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {v!r}")


def parse_freeze(spec: str) -> List[int]:
    out = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if not tok.lstrip("+-").isdigit():
            raise SystemExit(f"--freeze-atoms {tok!r}: residue selectors "
                             f"need PDB input, which {_LATER}")
        out.append(int(tok))
    return out


def _common_options(p) -> None:
    """The options every workflow subcommand of the JAX package takes."""
    p.add_argument("-q", "--charge", type=int, default=None)
    p.add_argument("-s", "--spin", type=int, default=None)
    p.add_argument("-m", "--mult", "--multiplicity", dest="multiplicity",
                   type=int, default=None)
    p.add_argument("--freeze-atoms", default="")
    p.add_argument("--auto-freeze-links", type=_bool, default=True)
    p.add_argument("--freeze-links", type=_bool, default=None)
    p.add_argument("--ref-pdb", type=Path, default=None)
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
    p.add_argument("--ligand-charge", default=None)
    p.add_argument("--args-yaml", type=Path, default=None)
    p.add_argument("--out-dir", type=Path, default=None)
    p.add_argument("--convert-files", type=_bool, default=True)
    p.add_argument("--profile", default=None)
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
    p.add_argument("--dist-freeze", default="")
    p.add_argument("--bias-k", type=float, default=10.0)
    p.add_argument("--one-based", type=_bool, default=True)
    p.add_argument("--dump-restart", type=int, default=0)
    _common_options(p)
    p.set_defaults(func=opt_cmd)
    return p


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
    return p


def _path_search_parser(sub):
    p = sub.add_parser("path-search",
                       help="Recursive multi-step MEP search between "
                            "structures.")
    p.add_argument("-i", "--input", dest="input_paths", action="append",
                   required=True, type=Path,
                   help="A structure, in reaction order; give two or more.")
    p.add_argument("--mep-mode", default="gsm", choices=["gsm", "dmf"])
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--refine-mode", default="hei", choices=["hei", "minima"])
    p.add_argument("--kink-max-nodes", type=int, default=5)
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
    p.add_argument("--align", type=_bool, default=True,
                   help="Align all inputs to the first after preopt.")
    p.add_argument("--climb", type=_bool, default=True)
    p.add_argument("--ref-full-pdb", action="append", default=None,
                   type=Path,
                   help="Full-system PDB template(s) for merged outputs "
                        "(not ported yet).")
    p.add_argument("--gsm-loop", default="auto",
                   choices=["auto", "device", "host"],
                   help="GSM loop: auto and host run the host loop; the "
                        "device loop is not ported yet.")
    _common_options(p)
    p.set_defaults(func=path_search_cmd)
    return p


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
    return p


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
    return p


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
    return p


def _reject_unported(a, supported=()) -> None:
    unported = {
        "--dist-freeze (the distance restraints, ROADMAP.md queue 1 item "
        "6)": bool(getattr(a, "dist_freeze", "")),
        "--dump-restart": ("--dump-restart" not in supported
                           and getattr(a, "dump_restart", 0) != 0),
        "--ref-pdb": a.ref_pdb is not None,
        "--dump": a.dump,
        "--workers": a.workers != 1,
        "--ligand-charge": a.ligand_charge is not None,
        "--args-yaml": a.args_yaml is not None,
        "--profile": a.profile is not None,
        "--gsm-loop device (the GSM device loop, left out of ROADMAP.md "
        "queue 1 item 2)": getattr(a, "gsm_loop", "auto") == "device",
        "--ref-full-pdb (the full-system PDB merge, ROADMAP.md queue 1 "
        "item 6)": bool(getattr(a, "ref_full_pdb", None)),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise SystemExit(f"{', '.join(bad)} {_LATER}")


def _charge_spin(a):
    spin = a.spin if a.spin is not None else a.multiplicity
    # an .xyz carries no charge: 0 unless -q is given
    charge = a.charge if a.charge is not None else 0
    return charge, spin


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
    if a.spatial > 1 and normalize_choice(a.opt_mode) == "rfo":
        raise SystemExit("opt --opt-mode heavy under atom-axis sharding "
                         "(--spatial > 1): the Hessian over ranks is not "
                         "ported yet, ROADMAP.md queue 1 item 9")
    _init_spatial(a, "opt")
    try:
        res = run_opt(
            a.input_path, charge=charge, spin=spin,
            opt_mode=normalize_choice(a.opt_mode), coord_type=a.coord_type,
            thresh=a.thresh, max_cycles=a.max_cycles,
            freeze_atoms=parse_freeze(a.freeze_atoms),
            calc_mode=a.calc_mode, model=a.model, device=a.device,
            spatial=a.spatial, hessian_calc_mode=a.hessian_calc_mode,
            out_dir=a.out_dir or "./result_opt/")
    finally:
        shutdown()
    return 0 if res["converged"] else 3


def path_opt_cmd(a) -> int:
    from .workflows.path_opt import run_path_opt
    _reject_unported(a)
    if len(a.input_paths) != 2:
        raise SystemExit("path-opt takes exactly two endpoints: -i A -i B")
    charge, spin = _charge_spin(a)
    try:
        res = run_path_opt(
            list(a.input_paths), charge=charge, spin=spin,
            freeze_atoms=parse_freeze(a.freeze_atoms),
            auto_freeze_links=a.auto_freeze_links, mep_mode=a.mep_mode,
            preopt=a.preopt, preopt_mode=a.opt_mode, thresh=a.thresh,
            preopt_max_cycles=a.preopt_max_cycles, align=a.align,
            calc_mode=a.calc_mode, model=a.model, device=a.device,
            spatial=a.spatial, hessian_calc_mode=a.hessian_calc_mode,
            out_dir=a.out_dir or "./result_path_opt/",
            stopt_kw={"max_cycles": a.max_cycles},
            gs_kw={"max_nodes": a.max_nodes, "climb": a.climb,
                   "fix_ends": a.fix_ends})
    except NotImplementedError as e:     # DMF, RFO, --spatial > 1
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
    try:
        run_path_search(
            list(a.input_paths), charge=charge, spin=spin,
            freeze_atoms=parse_freeze(a.freeze_atoms),
            auto_freeze_links=a.auto_freeze_links, mep_mode=a.mep_mode,
            align=a.align, calc_mode=a.calc_mode, model=a.model,
            device=a.device, spatial=a.spatial,
            hessian_calc_mode=a.hessian_calc_mode,
            out_dir=a.out_dir or "./result_path_search/",
            stopt_kw={"max_cycles": a.max_cycles},
            gs_kw={"max_nodes": a.max_nodes, "climb": a.climb},
            search_kw=skw)
    except NotImplementedError as e:     # DMF, RFO, --spatial > 1
        raise SystemExit(str(e))
    return 0


def _stage4_kw(a):
    """The options tsopt, freq and irc pass to their workflows alike."""
    charge, spin = _charge_spin(a)
    return dict(charge=charge, spin=spin,
                freeze_atoms=parse_freeze(a.freeze_atoms),
                auto_freeze_links=a.auto_freeze_links,
                calc_mode=a.calc_mode, model=a.model, device=a.device,
                spatial=a.spatial, hessian_calc_mode=a.hessian_calc_mode)


def tsopt_cmd(a) -> int:
    from .workflows.tsopt import run_tsopt
    _reject_unported(a, supported=("--dump-restart",))
    try:
        res = run_tsopt(
            a.input_path, opt_mode=a.opt_mode, coord_type=a.coord_type,
            thresh=a.thresh, max_cycles=a.max_cycles,
            dump_restart=a.dump_restart,
            hessian_dimer_kw={"flatten_max_iter":
                              10 if a.flatten_imag_mode else 0},
            out_dir=a.out_dir or "./result_tsopt/", **_stage4_kw(a))
    except NotImplementedError as e:     # dlc RS-I-RFO, --spatial > 1
        raise SystemExit(str(e))
    return 0 if res["converged"] else 3


def freq_cmd(a) -> int:
    from .workflows.freq import run_freq
    _reject_unported(a)
    try:
        run_freq(a.input_path, temperature=a.temperature,
                 pressure=a.pressure, max_write_modes=a.max_write_modes,
                 amplitude_ang=a.amplitude_ang, n_frames=a.n_frames,
                 sort_modes=a.sort_modes,
                 out_dir=a.out_dir or "./result_freq/", **_stage4_kw(a))
    except NotImplementedError as e:     # --spatial > 1
        raise SystemExit(str(e))
    return 0


def irc_cmd(a) -> int:
    from .workflows.irc import run_irc
    _reject_unported(a, supported=("--dump-restart",))
    try:
        run_irc(a.input_path, step_length=a.step_length,
                max_cycles=a.max_cycles, root=a.root, forward=a.forward,
                backward=a.backward, hessian_recalc=a.hessian_recalc,
                dump_restart=a.dump_restart,
                out_dir=a.out_dir or "./result_irc/", **_stage4_kw(a))
    except NotImplementedError as e:     # --spatial > 1
        raise SystemExit(str(e))
    return 0


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="pdb2r-torch",
        description="pdb2reaction_tpu_torch: the PyTorch/CUDA port.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _opt_parser(sub)
    _path_opt_parser(sub)
    _path_search_parser(sub)
    _tsopt_parser(sub)
    _freq_parser(sub)
    _irc_parser(sub)
    a = parser.parse_args(argv)
    sys.exit(a.func(a))
