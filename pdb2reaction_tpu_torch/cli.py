"""Command-line interface of the port: the ``opt`` subcommand.

Same flags as the JAX package's ``opt`` (``pdb2reaction_tpu/cli.py``) plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Flags whose features are not ported yet are accepted and raise when used
with a non-default value. The other subcommands are later port items.

    python -m pdb2reaction_tpu_torch opt -i x.xyz -q 0 --model escn-md
"""

from __future__ import annotations

import argparse
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


def _opt_parser(sub):
    p = sub.add_parser("opt", help="Single-structure geometry optimization.")
    p.add_argument("-i", "--input", dest="input_path", required=True,
                   type=Path)
    p.add_argument("--opt-mode", default="light", help="light|lbfgs.")
    p.add_argument("--coord-type", default="cart", choices=["cart", "dlc"])
    p.add_argument("--thresh", default="gau")
    p.add_argument("--max-cycles", type=int, default=10000)
    p.add_argument("--dist-freeze", default="")
    p.add_argument("--bias-k", type=float, default=10.0)
    p.add_argument("--one-based", type=_bool, default=True)
    p.add_argument("--dump-restart", type=int, default=0)
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
                   choices=["uma", "morse", "lj"])
    p.add_argument("--model", default="escn-md",
                   help="eSCN config name (escn-md, escn-test, ...).")
    p.add_argument("--hessian-calc-mode", default="Analytical",
                   choices=["Analytical", "FiniteDifference"])
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--workers-per-node", type=int, default=1)
    p.add_argument("--spatial", type=int, default=1)
    p.add_argument("--ligand-charge", default=None)
    p.add_argument("--args-yaml", type=Path, default=None)
    p.add_argument("--out-dir", type=Path, default=None)
    p.add_argument("--convert-files", type=_bool, default=True)
    p.add_argument("--profile", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; hand-written kernels) or cpu "
                        "(plain PyTorch path).")
    return p


def _reject_unported(a) -> None:
    unported = {
        "--dist-freeze": bool(a.dist_freeze),
        "--dump-restart": a.dump_restart != 0,
        "--ref-pdb": a.ref_pdb is not None,
        "--dump": a.dump,
        "--workers": a.workers != 1,
        "--spatial": a.spatial != 1,
        "--ligand-charge": a.ligand_charge is not None,
        "--args-yaml": a.args_yaml is not None,
        "--profile": a.profile is not None,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise SystemExit(f"{', '.join(bad)} {_LATER}")


def opt_cmd(a) -> int:
    from .workflows.opt import run_opt
    _reject_unported(a)
    spin = a.spin if a.spin is not None else a.multiplicity
    # an .xyz carries no charge: 0 unless -q is given
    charge = a.charge if a.charge is not None else 0
    res = run_opt(
        a.input_path, charge=charge, spin=spin,
        opt_mode=normalize_choice(a.opt_mode), coord_type=a.coord_type,
        thresh=a.thresh, max_cycles=a.max_cycles,
        freeze_atoms=parse_freeze(a.freeze_atoms),
        calc_mode=a.calc_mode, model=a.model, device=a.device,
        out_dir=a.out_dir or "./result_opt/")
    return 0 if res["converged"] else 3


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="pdb2r-torch",
        description="pdb2reaction_tpu_torch: the PyTorch/CUDA port.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _opt_parser(sub)
    a = parser.parse_args(argv)
    sys.exit(opt_cmd(a))
