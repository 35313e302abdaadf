"""Shared workflow plumbing: input loading, charge and spin, freeze
lists, the calculator factory and output writing.

Counterpart of ``pdb2reaction_tpu/workflows/common.py``:

- ``load_structure`` reads .pdb, .xyz/.trj and .gjf/.com inputs; a
  ``--ref-pdb`` template (argument or process default) lends its atom
  records to an .xyz or .gjf input of the same atom count;
- ``resolve_charge_spin``: the caller's charge and spin win, then a
  .gjf template's, then a total derived from ``--ligand-charge`` and the
  residue tables of a PDB input; a charge found nowhere raises;
- ``detect_freeze_links`` / ``merge_freeze``: the parent of every HL
  link hydrogen of a PDB input is frozen with the given atoms;
- ``resolve_atom_spec``: an index or a 'RES SEQ NAME' selector;
- ``write_outputs`` / ``write_trajectory``: .xyz / .trj, with a .pdb
  companion for PDB inputs and a .gjf companion for .gjf inputs while
  conversion is on (``set_convert_enabled``); a failed companion prints a
  warning and the run goes on;
- ``rank_dir`` / ``drop_scratch``: the rule of a run over several
  ranks. Every workflow maps its ``out_dir`` (and every per-stage
  override) through it, so rank 0 writes the user's tree and every other
  rank the same tree in its private scratch directory: each rank reads
  back its own hand-offs between stages and takes the same branches, and
  only rank 0's files reach the user. What reads a previous run's files
  (``CheckpointStore``) is rank 0's, broadcast (``parallel.agree``).
"""

from __future__ import annotations

import atexit
import shutil
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from ..bio.residues import LINK_H_NAME, LINK_H_RESNAME
from ..constants import BOHR2ANG
from ..core import io_pdb, io_xyz
from ..core.structure import Structure
from ..mlip import potentials
from ..mlip.calculator import Calculator
from ..mlip.uma import make_uma_calculator
from ..parallel.distributed import is_main_rank

# calculator options the analytic potentials take
_POTENTIAL_KW = ("hessian_calc_mode", "fd_step", "return_partial_hessian",
                 "hessian_double", "pad_multiple")

_CONVERT_ENABLED = True
_SCRATCH: Optional[Path] = None          # this rank's private tree
_DEFAULT_REF_PDB = None
_DEFAULT_LIGAND_CHARGE = None


def drop_scratch() -> None:
    """Remove this rank's scratch directory (at exit, and when the CLI
    leaves the process group)."""
    global _SCRATCH
    if _SCRATCH is not None:
        shutil.rmtree(_SCRATCH, ignore_errors=True)
    _SCRATCH = None


atexit.register(drop_scratch)


def rank_dir(path) -> Path:
    """``path`` on rank 0 and outside a process group; on the other ranks
    the same path inside this process's private scratch directory (made
    on first use, removed by ``drop_scratch``). Every output directory of
    a workflow, the user's per-stage overrides included, goes through
    here: every rank writes the same tree and reads back its own
    hand-offs between stages, and only rank 0's tree reaches the user.
    Idempotent: a path already in the scratch directory is returned as it
    is."""
    global _SCRATCH
    path = Path(path)
    if is_main_rank():
        return path
    if _SCRATCH is None:
        _SCRATCH = Path(tempfile.mkdtemp(
            prefix=f"pdb2r_rank{dist.get_rank()}_"))
    full = path.resolve()
    if full.is_relative_to(_SCRATCH):
        return full
    return _SCRATCH / full.relative_to(full.anchor)


def set_convert_enabled(flag: bool) -> None:
    global _CONVERT_ENABLED
    _CONVERT_ENABLED = bool(flag)


def convert_enabled() -> bool:
    return _CONVERT_ENABLED


def set_default_ligand_charge(value) -> None:
    """Process-wide ``--ligand-charge`` (set by the CLI): a total charge
    or a RES:q mapping from which ``resolve_charge_spin`` derives the
    charge of a PDB input when none is given."""
    global _DEFAULT_LIGAND_CHARGE
    _DEFAULT_LIGAND_CHARGE = value


def get_default_ligand_charge():
    return _DEFAULT_LIGAND_CHARGE


def set_default_ref_pdb(path) -> None:
    """Process-wide ``--ref-pdb`` template (set by the CLI): its atom
    records are attached to .xyz and .gjf inputs, so their outputs get
    PDB companions and selector strings resolve."""
    global _DEFAULT_REF_PDB
    _DEFAULT_REF_PDB = path


def load_structure(path, ref_pdb=None) -> Structure:
    p = Path(path)
    suf = p.suffix.lower()
    if suf == ".pdb":
        st = io_pdb.read_pdb(p)
        st.input_suffix = suf
        return st
    if suf in (".xyz", ".trj"):
        st = io_xyz.read_xyz(p)
    elif suf in (".gjf", ".com"):
        from ..core.io_gjf import read_gjf
        st = read_gjf(p)
    else:
        raise ValueError(f"Unsupported structure format: {p}")
    st.input_suffix = suf
    rp = ref_pdb or _DEFAULT_REF_PDB
    if rp:
        tmpl = io_pdb.read_pdb(rp)
        if tmpl.n_atoms != st.n_atoms:
            raise ValueError(
                f"--ref-pdb {rp} has {tmpl.n_atoms} atoms but the input "
                f"has {st.n_atoms}")
        st.pdb_atoms = tmpl.pdb_atoms
        st.source_path = Path(rp)
    return st


def detect_freeze_links(pdb_path) -> List[int]:
    """Indices (0-based, into the atoms other than link hydrogens) of the
    parent of every HL link hydrogen: its nearest other atom."""
    atoms = io_pdb.parse_pdb_atoms(pdb_path)
    others, lkhs = [], []
    for a in atoms:
        if a["resname"] == LINK_H_RESNAME and a["name"] == LINK_H_NAME:
            lkhs.append(a)
        else:
            others.append(a)
    if not lkhs:
        return []
    oxyz = np.array([[a["x"], a["y"], a["z"]] for a in others]) \
        if others else np.zeros((0, 3))
    out = []
    for h in lkhs:
        if len(others) == 0:
            out.append(-1)
            continue
        d2 = ((oxyz - np.array([h["x"], h["y"], h["z"]])) ** 2).sum(1)
        out.append(int(np.argmin(d2)))
    return out


def merge_freeze(struct: Structure, extra: Sequence[int],
                 auto_freeze_links: bool = True) -> List[int]:
    """Sorted union of the structure's own freeze list, the extra indices
    and, for a PDB input with ``auto_freeze_links``, its link parents."""
    freeze = set(int(i) for i in list(struct.freeze) + list(extra))
    if auto_freeze_links and struct.source_path \
            and str(struct.source_path).lower().endswith(".pdb"):
        freeze.update(i for i in detect_freeze_links(struct.source_path)
                      if i >= 0)
    return sorted(freeze)


def resolve_atom_spec(spec: Union[int, str], struct: Structure) -> int:
    """An atom selector: an integer index or a 'RESNAME RESSEQ ATOMNAME'
    string like 'TYR 285 CA' (needs PDB records)."""
    if isinstance(spec, (int, np.integer)):
        return int(spec)
    s = str(spec).strip()
    if s.lstrip("+-").isdigit():
        return int(s)
    parts = s.split()
    if len(parts) != 3 or struct.pdb_atoms is None:
        raise ValueError(f"Cannot resolve atom spec {spec!r} "
                         "(need 'RESNAME RESSEQ NAME' and PDB input)")
    resname, resseq, name = parts[0].upper(), int(parts[1]), parts[2].upper()
    hits = [i for i, a in enumerate(struct.pdb_atoms)
            if a["resname"].upper() == resname and a["resseq"] == resseq
            and a["name"].upper() == name]
    if len(hits) != 1:
        raise ValueError(f"Atom spec {spec!r} matched {len(hits)} atoms")
    return hits[0]


def resolve_charge_spin(struct: Structure, charge: Optional[int],
                        spin: Optional[int],
                        ligand_charge=None) -> Tuple[int, int]:
    """The caller's charge and spin win; else a .gjf template's; else,
    for a PDB input and a ``ligand_charge`` (argument or process
    default), the total of the residue charge summary over the whole
    structure. A charge found nowhere raises; spin defaults to 1."""
    q = charge
    s = spin
    tmpl = struct.gjf_template
    if q is None and tmpl is not None:
        q = tmpl.charge
    if s is None and tmpl is not None:
        s = tmpl.spin
    lc = ligand_charge if ligand_charge is not None \
        else _DEFAULT_LIGAND_CHARGE
    if lc is not None:
        src = struct.source_path
        # the original input must be a PDB: source_path is rebound to the
        # --ref-pdb template for .xyz and .gjf inputs (load_structure)
        in_suf = struct.input_suffix
        is_pdb = (in_suf == ".pdb") if in_suf \
            else bool(src and str(src).lower().endswith(".pdb"))
        if not (src and is_pdb):
            raise ValueError(
                "--ligand-charge is only supported for PDB inputs; it "
                "cannot be used with .xyz or .gjf files")
        if q is None:
            from ..bio.extract import Model, compute_charge_summary
            model = Model.from_pdb(src)
            summary = compute_charge_summary(
                model, set(model.res_order), set(), lc)
            total = float(summary["total_charge"])
            q = int(round(total))
            print(f"[charge] full-complex summary from --ligand-charge: "
                  f"protein {summary['protein_charge']:+g}, ligand "
                  f"{summary['ligand_charge']:+g}, ions "
                  f"{summary['ion_charge']:+g} -> total {total:+g} "
                  f"(using {q:+d})")
    if q is None:
        raise ValueError("Charge (-q/--charge) is required for this input")
    return int(q), int(s if s is not None else 1)


def make_calculator(struct: Structure, *, calc_mode: str = "uma",
                    charge: int = 0, spin: int = 1,
                    freeze_atoms: Sequence[int] = (),
                    model: str = "uma-s-1p1", device="cuda", mesh=None,
                    **calc_kw) -> Calculator:
    """The UMA-class calculator (``calc_mode="uma"``) or an analytic test
    potential ("morse", "lj"), which runs every workflow without weights.
    ``mesh`` (``parallel.make_mesh``) splits batches, Hessian tangents and
    FD displacements over its data axis, for the analytic potentials
    too; atom-axis sharding (``spatial``) is the UMA factory's."""
    mode = (calc_mode or "uma").lower()
    if mode == "uma":
        return make_uma_calculator(struct, model=model, charge=charge,
                                   spin=spin, freeze_atoms=freeze_atoms,
                                   device=device, mesh=mesh, **calc_kw)
    fns = {"morse": potentials.make_morse, "lj": potentials.make_lj}
    if mode not in fns:
        raise ValueError(f"Unknown calc mode {calc_mode!r}")
    if int(calc_kw.get("spatial", 1)) > 1:
        raise ValueError(f"calc_mode={mode!r}: the analytic potentials run "
                         "unsharded; atom-axis sharding (spatial > 1) is "
                         "for the UMA-class models")
    return Calculator(struct, fns[mode](), freeze_atoms=freeze_atoms,
                      device=mesh.device if mesh is not None else device,
                      mesh=mesh,
                      **{k: v for k, v in calc_kw.items()
                         if k in _POTENTIAL_KW})


def write_outputs(out_dir: Path, name: str, struct: Structure,
                  coords_bohr: np.ndarray, energy: Optional[float] = None,
                  source_pdb: Optional[Path] = None) -> List[Path]:
    """Write ``<name>.xyz`` (Angstrom, energy in the comment line); with
    conversion on, ``<name>.pdb`` when the input was a PDB (or carries a
    template) and ``<name>.gjf`` when it was a .gjf (charge, spin and
    route from the template)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    coords_ang = np.asarray(coords_bohr).reshape(-1, 3) * BOHR2ANG
    st = struct.copy(coords=coords_ang)
    paths = []
    xyz = out_dir / f"{name}.xyz"
    io_xyz.write_xyz(xyz, st, energy=energy)
    paths.append(xyz)
    src = source_pdb or struct.source_path
    if convert_enabled() and src and str(src).lower().endswith(".pdb"):
        pdb = out_dir / f"{name}.pdb"
        try:
            io_pdb.overlay_coords_on_template(src, coords_ang, pdb)
            paths.append(pdb)
        except Exception as e:
            print(f"[convert] WARNING: PDB conversion failed: {e}")
    tmpl = struct.gjf_template
    if convert_enabled() and tmpl is not None:
        gjf = out_dir / f"{name}.gjf"
        try:
            if len(tmpl.symbols) != len(coords_ang):
                raise ValueError(
                    f"atom count mismatch: template {len(tmpl.symbols)}, "
                    f"output {len(coords_ang)}")
            gjf.write_text(tmpl.render(coords_ang))
            paths.append(gjf)
        except Exception as e:
            print(f"[convert] WARNING: GJF conversion failed: {e}")
    return paths


def write_trajectory(out_dir: Path, name: str, struct: Structure,
                     frames_bohr: Sequence[np.ndarray],
                     energies: Optional[Sequence[float]] = None,
                     source_pdb: Optional[Path] = None) -> List[Path]:
    """Write ``<name>.trj`` (Angstrom, each frame's energy in its comment
    line) and, with conversion on and a PDB input, ``<name>.pdb`` as
    MODEL records on the input's template."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = [struct.copy(coords=np.asarray(c).reshape(-1, 3) * BOHR2ANG)
              for c in frames_bohr]
    trj = out_dir / f"{name}.trj"
    io_xyz.write_trj(trj, frames, energies=energies)
    paths = [trj]
    src = source_pdb or struct.source_path
    if convert_enabled() and src and str(src).lower().endswith(".pdb"):
        pdb = out_dir / f"{name}.pdb"
        try:
            io_pdb.write_pdb_frames(
                pdb, load_structure(src),
                [np.asarray(c).reshape(-1, 3) * BOHR2ANG
                 for c in frames_bohr],
                energies=energies)
            paths.append(pdb)
        except Exception as e:
            print(f"[convert] WARNING: PDB trajectory conversion failed: "
                  f"{e}")
    return paths
