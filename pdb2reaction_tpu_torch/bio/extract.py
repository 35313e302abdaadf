"""Active-site pocket extraction (``extract`` subcommand, stage 1 of
``all``).

Counterpart of ``pdb2reaction_tpu/bio/extract.py``, on the atom records
of ``core/io_pdb.py``:

- the substrate by PDB coordinate match (tolerance 1e-3 Angstrom), by
  residue IDs ('A:123', '123A') or by residue names;
- residues within ``radius`` (2.6 Angstrom) of the substrate, amino acids
  only through a side-chain contact while the backbone is excluded, an
  independent hetero-hetero radius, waters on request, forced
  ``selected_resn``; the radius query runs in torch on the caller's
  device (``core/neighbors.py`` ``radius_query``);
- safeguards: disulfide partners (SG-SG <= 2.5 Angstrom), the N-side
  neighbour of a proline, peptide neighbours of backbone contacts when
  the backbone is kept (C-N <= 1.9 Angstrom);
- truncation and capping (``mark_atoms_to_skip``), link hydrogens at
  1.09 Angstrom along cut C-X bonds in a HETATM HL/LKH block, the same
  targets required across models;
- the charge summary over protein, ions, waters and unknown residues
  with the ``--ligand-charge`` distribution;
- several inputs as one union selection by residue identity, written as
  one multi-MODEL file or one file per input;
- ``extract_api`` returning {"outputs", "counts", "charge_summary"}.

The written pockets are the JAX package's byte for byte.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import io_pdb
from ..core.neighbors import radius_query
from . import residues as RES

BACKBONE_ATOMS: Set[str] = {
    "N", "C", "O", "CA", "OXT",
    "H", "H1", "H2", "H3", "HN", "HA", "HA2", "HA3",
}
WATER_RES = {"HOH", "WAT", "H2O", "DOD", "TIP", "TIP3", "SOL"}
PEPTIDE_CN = 1.9
DISULFIDE_SS = 2.5
LINK_H_DIST = 1.09
MATCH_TOL = 1e-3

ResKey = Tuple[str, bool, int, str, str]   # (chain, het, resseq, icode, resname)


@dataclass
class Residue:
    key: ResKey
    atoms: List[int] = field(default_factory=list)   # indices into atom list

    @property
    def resname(self) -> str:
        return self.key[4]

    @property
    def chain(self) -> str:
        return self.key[0]


class Model:
    """One PDB structure as atoms + residue grouping."""

    def __init__(self, atoms: List[Dict[str, Any]]):
        self.atoms = atoms
        self.coords = np.array([[a["x"], a["y"], a["z"]] for a in atoms])
        self.residues: Dict[ResKey, Residue] = {}
        order: List[ResKey] = []
        for i, a in enumerate(atoms):
            key = (a["chain"], a["record"] == "HETATM", a["resseq"],
                   a["icode"].strip(), a["resname"].upper())
            if key not in self.residues:
                self.residues[key] = Residue(key)
                order.append(key)
            self.residues[key].atoms.append(i)
        self.res_order = order

    @classmethod
    def from_pdb(cls, path) -> "Model":
        return cls(io_pdb.parse_pdb_atoms(path))

    def atom_name(self, i) -> str:
        return self.atoms[i]["name"].upper()

    def element(self, i) -> str:
        return (self.atoms[i]["element"] or "").capitalize()

    def is_aa(self, key: ResKey) -> bool:
        return key[4] in RES.AMINO_ACIDS

    def peptide_next(self, key: ResKey) -> Optional[ResKey]:
        """Residue whose N is <= 1.9 A from this residue's C."""
        c_idx = self._named(key, "C")
        if c_idx is None:
            return None
        c = self.coords[c_idx]
        for other in self.res_order:
            if other == key or not self.is_aa(other):
                continue
            n_idx = self._named(other, "N")
            if n_idx is not None and np.linalg.norm(
                    self.coords[n_idx] - c) <= PEPTIDE_CN:
                return other
        return None

    def peptide_prev(self, key: ResKey) -> Optional[ResKey]:
        n_idx = self._named(key, "N")
        if n_idx is None:
            return None
        n = self.coords[n_idx]
        for other in self.res_order:
            if other == key or not self.is_aa(other):
                continue
            c_idx = self._named(other, "C")
            if c_idx is not None and np.linalg.norm(
                    self.coords[c_idx] - n) <= PEPTIDE_CN:
                return other
        return None

    def _named(self, key: ResKey, name: str) -> Optional[int]:
        for i in self.residues[key].atoms:
            if self.atom_name(i) == name:
                return i
        return None


# ----------------------------------------------------------------------
# substrate specification
# ----------------------------------------------------------------------

_ID_RE = re.compile(r"^(?:(?P<chain>[A-Za-z0-9]):)?(?P<seq>\d+)"
                    r"(?P<icode>[A-Za-z])?$")


def resolve_substrate(model: Model, spec: str,
                      verbose: bool = True) -> Set[ResKey]:
    spec = spec.strip()
    if spec.lower().endswith(".pdb") and Path(spec).exists():
        sub = Model.from_pdb(spec)
        keys: Set[ResKey] = set()
        for i, a in enumerate(sub.atoms):
            d2 = ((model.coords - sub.coords[i]) ** 2).sum(1)
            j = int(np.argmin(d2))
            if (np.sqrt(d2[j]) <= MATCH_TOL
                    and model.atom_name(j) == sub.atom_name(i)):
                aj = model.atoms[j]
                keys.add((aj["chain"], aj["record"] == "HETATM",
                          aj["resseq"], aj["icode"].strip(),
                          aj["resname"].upper()))
        if not keys:
            raise ValueError(f"No atoms of {spec} matched the input "
                             f"structure (tol {MATCH_TOL} A)")
        return keys

    tokens = [t for t in re.split(r"[,\s]+", spec) if t]
    keys = set()
    id_tokens = [t for t in tokens if _ID_RE.match(t)]
    if id_tokens and len(id_tokens) == len(tokens):
        for t in tokens:
            m = _ID_RE.match(t)
            chain = m.group("chain")
            seq = int(m.group("seq"))
            icode = m.group("icode") or None
            matched = [k for k in model.res_order
                       if k[2] == seq
                       and (chain is None or k[0] == chain)
                       and (icode is None or k[3] == icode)]
            if not matched:
                raise ValueError(f"Residue ID {t!r} not found")
            keys.update(matched)
        return keys

    # residue-name based
    names = {t.upper() for t in tokens}
    for k in model.res_order:
        if k[4] in names:
            keys.add(k)
    if not keys:
        raise ValueError(f"No residues named {sorted(names)} found")
    by_name: Dict[str, int] = {}
    for k in keys:
        by_name[k[4]] = by_name.get(k[4], 0) + 1
    for nm, cnt in by_name.items():
        if cnt > 1 and verbose:
            print(f"[extract] WARNING: {cnt} residues named {nm}; "
                  "including all matches")
    return keys


# ----------------------------------------------------------------------
# residue selection and safeguards
# ----------------------------------------------------------------------

def select_residues(model: Model, substrate: Set[ResKey], *,
                    radius: float = 2.6, radius_het2het: float = 0.0,
                    include_h2o: bool = True, exclude_backbone: bool = True,
                    selected_resn: Optional[Sequence[str]] = None,
                    verbose: bool = True, device="cuda"
                    ) -> Tuple[Set[ResKey], Set[ResKey]]:
    """Returns (selected keys, backbone-contact keys). The radius queries
    run on ``device``."""
    radius = max(radius, 1e-3)
    radius_het2het = max(radius_het2het, 1e-3) if radius_het2het else 0.0
    sub_atoms = [i for k in substrate for i in model.residues[k].atoms]
    sub_xyz = model.coords[sub_atoms]
    sub_het = [i for i in sub_atoms if model.element(i) not in ("C", "H")]

    selected: Set[ResKey] = set(substrate)
    backbone_contact: Set[ResKey] = set()

    # one radius query over the whole structure for each radius
    within_set: Set[int] = set(
        radius_query(model.coords, sub_xyz, radius, device)[:, 0].tolist())
    het_within: Set[int] = set()
    if radius_het2het and sub_het:
        het_within = set(radius_query(
            model.coords, model.coords[sub_het], radius_het2het,
            device)[:, 0].tolist())

    for key in model.res_order:
        if key in selected:
            continue
        resname = key[4]
        if resname in WATER_RES and not include_h2o:
            continue
        idx = model.residues[key].atoms
        is_aa = model.is_aa(key)
        qualify = False
        hit = [i for i in idx if i in within_set]
        if hit:
            if exclude_backbone and is_aa:
                qualify = any(model.atom_name(i) not in BACKBONE_ATOMS
                              for i in hit)
            else:
                qualify = True
            if not exclude_backbone and is_aa:
                if any(model.atom_name(i) in BACKBONE_ATOMS for i in hit):
                    backbone_contact.add(key)
        if not qualify and het_within:
            het_idx = [i for i in idx if i in het_within
                       and model.element(i) not in ("C", "H")]
            if exclude_backbone and is_aa:
                het_idx = [i for i in het_idx
                           if model.atom_name(i) not in BACKBONE_ATOMS]
            qualify = bool(het_idx)
        if qualify:
            selected.add(key)

    # forced residues
    if selected_resn:
        for tok in selected_resn:
            m = _ID_RE.match(str(tok).strip())
            if not m:
                continue
            chain = m.group("chain")
            seq = int(m.group("seq"))
            icode = m.group("icode") or None
            hits = [k for k in model.res_order
                    if k[2] == seq and (chain is None or k[0] == chain)
                    and (icode is None or k[3] == icode)]
            if not hits:
                raise ValueError(f"--selected-resn {tok!r} not found")
            selected.update(hits)

    # disulfide safeguard
    for key in list(selected):
        if key[4] not in ("CYS", "CYX"):
            continue
        sg = model._named(key, "SG")
        if sg is None:
            continue
        for other in model.res_order:
            if other in selected or other[4] not in ("CYS", "CYX"):
                continue
            sg2 = model._named(other, "SG")
            if sg2 is not None and np.linalg.norm(
                    model.coords[sg] - model.coords[sg2]) <= DISULFIDE_SS:
                selected.add(other)
                if verbose:
                    print(f"[extract] disulfide partner included: {other}")

    # proline safeguard
    for key in list(selected):
        if key[4] in ("PRO", "HYP", "DPR"):
            prev = model.peptide_prev(key)
            if prev is not None and prev not in selected:
                selected.add(prev)
                if verbose:
                    print(f"[extract] PRO N-side neighbor included: {prev}")

    # backbone-contact peptide neighbors (only when exclude_backbone off)
    if not exclude_backbone:
        for key in list(backbone_contact):
            for nb in (model.peptide_prev(key), model.peptide_next(key)):
                if nb is not None:
                    selected.add(nb)

    return selected, backbone_contact


# ----------------------------------------------------------------------
# truncation and capping
# ----------------------------------------------------------------------

N_CAP = {"N", "H", "H1", "H2", "H3", "HN"}
C_CAP = {"C", "O", "OXT"}
CA_SET = {"CA", "HA", "HA2", "HA3"}


def mark_atoms_to_skip(model: Model, selected: Set[ResKey],
                       substrate: Set[ResKey], *,
                       exclude_backbone: bool = True,
                       backbone_contact: Optional[Set[ResKey]] = None,
                       pro_neighbors: Optional[Set[ResKey]] = None
                       ) -> Set[int]:
    """Atom indices to delete. Substrate atoms are never deleted."""
    skip: Set[int] = set()
    backbone_contact = backbone_contact or set()

    # find PRO N-side neighbors inside the selection (keep their C/O caps)
    pro_nside: Set[ResKey] = set()
    for key in selected:
        if key[4] in ("PRO", "HYP", "DPR"):
            prev = model.peptide_prev(key)
            if prev in selected:
                pro_nside.add(prev)

    if exclude_backbone:
        for key in selected:
            if key in substrate or not model.is_aa(key):
                continue
            is_pro = key[4] in ("PRO", "HYP", "DPR")
            for i in model.residues[key].atoms:
                nm = model.atom_name(i)
                if nm in BACKBONE_ATOMS:
                    if is_pro and (nm in ("N", "CA") or nm.startswith("H")):
                        continue   # ring preservation
                    if key in pro_nside and nm in ("CA", "C", "O", "OXT"):
                        continue   # preserve peptide bond into PRO-N
                    skip.add(i)
        return skip

    # exclude_backbone == False: segment-aware capping
    aa_sel = [k for k in model.res_order
              if k in selected and model.is_aa(k) and k not in substrate]
    segments: List[List[ResKey]] = []
    placed: Set[ResKey] = set()
    for key in aa_sel:
        if key in placed:
            continue
        seg = [key]
        placed.add(key)
        cur = key
        while True:
            nxt = model.peptide_next(cur)
            if nxt in selected and nxt is not None and nxt not in placed \
                    and model.is_aa(nxt):
                seg.append(nxt)
                placed.add(nxt)
                cur = nxt
            else:
                break
        cur = key
        while True:
            prv = model.peptide_prev(cur)
            if prv in selected and prv is not None and prv not in placed \
                    and model.is_aa(prv):
                seg.insert(0, prv)
                placed.add(prv)
                cur = prv
            else:
                break
        segments.append(seg)

    def preserve_ncap(key):
        # backbone-contact terminus rule: keep N-cap when the contacting
        # residue has no peptide-adjacent previous residue
        return key in backbone_contact and model.peptide_prev(key) is None

    def preserve_ccap(key):
        return key in backbone_contact and model.peptide_next(key) is None

    for seg in segments:
        for pos, key in enumerate(seg):
            is_pro = key[4] in ("PRO", "HYP", "DPR")
            single = len(seg) == 1
            for i in model.residues[key].atoms:
                nm = model.atom_name(i)
                if single:
                    if nm in N_CAP and not (is_pro or preserve_ncap(key)):
                        skip.add(i)
                    elif nm in C_CAP and not preserve_ccap(key):
                        skip.add(i)
                    elif nm in CA_SET and not is_pro:
                        skip.add(i)
                else:
                    if pos == 0 and nm in N_CAP \
                            and not (is_pro or preserve_ncap(key)):
                        skip.add(i)
                    if pos == len(seg) - 1 and nm in C_CAP \
                            and not preserve_ccap(key):
                        skip.add(i)
    return skip


# ----------------------------------------------------------------------
# link hydrogens
# ----------------------------------------------------------------------

_CUT_BONDS = [("CB", "CA"), ("CA", "N"), ("CA", "C")]
_CUT_BONDS_PRO = [("CA", "C")]


def compute_link_h(model: Model, selected: Set[ResKey], skip: Set[int],
                   substrate: Set[ResKey]
                   ) -> List[Tuple[ResKey, str, str, np.ndarray]]:
    """(residue, parent name, partner name, H position) per cut bond."""
    out = []
    for key in model.res_order:
        if key not in selected or key in substrate or not model.is_aa(key):
            continue
        bonds = _CUT_BONDS_PRO if key[4] in ("PRO", "HYP", "DPR") \
            else _CUT_BONDS
        for parent_nm, partner_nm in bonds:
            pi = model._named(key, parent_nm)
            qi = model._named(key, partner_nm)
            if pi is None or qi is None:
                continue
            if pi in skip or qi not in skip:
                continue
            if model.element(pi) != "C":
                continue
            vec = model.coords[qi] - model.coords[pi]
            n = np.linalg.norm(vec)
            if n < 1e-6:
                continue
            pos = model.coords[pi] + LINK_H_DIST * vec / n
            out.append((key, parent_nm, partner_nm, pos))
    return out


# ----------------------------------------------------------------------
# charge summary
# ----------------------------------------------------------------------

def parse_ligand_charge(spec) -> Tuple[Optional[float], Dict[str, int]]:
    if spec is None or spec == "":
        return None, {}
    s = str(spec).strip()
    if ":" in s:
        mapping = {}
        for tok in s.split(","):
            name, q = tok.split(":")
            mapping[name.strip().upper()] = int(q)
        return None, mapping
    return float(s), {}


def compute_charge_summary(model: Model, selected: Set[ResKey],
                           substrate: Set[ResKey],
                           ligand_charge=None) -> Dict[str, Any]:
    total_num, per_name = parse_ligand_charge(ligand_charge)
    protein = ions = waters = 0
    unknown_keys: List[ResKey] = []
    ion_list: List[str] = []
    for key in selected:
        rn = key[4]
        if rn in RES.AMINO_ACIDS:
            protein += RES.AMINO_ACIDS[rn]
        elif rn in RES.ION:
            ions += RES.ION[rn]
            ion_list.append(rn)
        elif rn in WATER_RES:
            waters += 0
        else:
            unknown_keys.append(key)
    unknown = 0.0
    if per_name:
        for key in unknown_keys:
            unknown += per_name.get(key[4], 0)
    elif total_num is not None:
        targets = [k for k in unknown_keys if k in substrate] or unknown_keys
        if targets:
            unknown = total_num
    total = protein + ions + unknown
    return {
        "protein_charge": protein,
        "ion_charge": ions,
        "ions": sorted(ion_list),
        "ligand_charge": unknown,
        "water_charge": 0,
        "n_unknown_residues": len(unknown_keys),
        "total_charge": total,
    }


# ----------------------------------------------------------------------
# output writer
# ----------------------------------------------------------------------

def _write_model_lines(model: Model, keep: List[int],
                       link_h: List[Tuple[ResKey, str, str, np.ndarray]]
                       ) -> List[str]:
    lines = []
    max_serial = 0
    for i in keep:
        a = model.atoms[i]
        lines.append(io_pdb.format_pdb_line(a, model.coords[i]))
        max_serial = max(max_serial, a["serial"])
    if link_h:
        lines.append("TER")
        for k, (key, parent, partner, pos) in enumerate(link_h):
            max_serial += 1
            lines.append(io_pdb.format_pdb_line(
                dict(record="HETATM", serial=max_serial, name="HL",
                     rawname=" HL ", resname="LKH", chain="L",
                     resseq=k + 1, element="H",
                     occupancy=1.0, bfactor=0.0), pos))
    return lines


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------

def extract_api(
    inputs: Sequence,
    center: str,
    outputs: Optional[Sequence] = None,
    *,
    radius: float = 2.6,
    radius_het2het: float = 0.0,
    include_h2o: bool = True,
    exclude_backbone: bool = True,
    add_link_h: bool = True,
    selected_resn: Optional[Sequence[str]] = None,
    ligand_charge=None,
    verbose: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """The pocket of ``inputs`` (one PDB or several models of one system)
    around ``center``, written to ``outputs``. The radius queries run on
    ``device`` (CUDA by default, as every entry point of the port)."""
    inputs = [Path(p) for p in (inputs if isinstance(inputs, (list, tuple))
                                else [inputs])]
    models = [Model.from_pdb(p) for p in inputs]

    # several inputs: the same atom count and a spot check of the order
    n0 = len(models[0].atoms)
    for m, p in zip(models[1:], inputs[1:]):
        if len(m.atoms) != n0:
            raise ValueError(f"Atom count mismatch: {p} has "
                             f"{len(m.atoms)} vs {n0}")
        for i in list(range(min(10, n0))) + list(range(max(0, n0 - 10), n0)):
            if m.atoms[i]["name"] != models[0].atoms[i]["name"]:
                raise ValueError(
                    f"Atom ordering mismatch at {i} in {p}: "
                    f"{m.atoms[i]['name']} vs {models[0].atoms[i]['name']}")

    substrate0 = resolve_substrate(models[0], center, verbose)

    # per-model selection; union by residue key
    union: Set[ResKey] = set()
    bb_contact_union: Set[ResKey] = set()
    per_model_sub: List[Set[ResKey]] = []
    for m in models:
        sub = {k for k in m.res_order
               if (k[0], k[2], k[3]) in {(s[0], s[2], s[3])
                                         for s in substrate0}}
        per_model_sub.append(sub)
        sel, bb = select_residues(
            m, sub, radius=radius, radius_het2het=radius_het2het,
            include_h2o=include_h2o, exclude_backbone=exclude_backbone,
            selected_resn=selected_resn, verbose=verbose, device=device)
        union.update(sel)
        bb_contact_union.update(bb)

    id_union = {(k[0], k[2], k[3], k[4]) for k in union}
    results = []
    link_targets_ref = None
    all_lines: List[List[str]] = []
    counts = []
    for mi, m in enumerate(models):
        sel = {k for k in m.res_order
               if (k[0], k[2], k[3], k[4]) in id_union}
        sub = per_model_sub[mi]
        skip = mark_atoms_to_skip(m, sel, sub,
                                  exclude_backbone=exclude_backbone,
                                  backbone_contact=bb_contact_union)
        link_h = compute_link_h(m, sel, skip, sub)
        targets = [(k, a, b) for (k, a, b, _) in link_h]
        if link_targets_ref is None:
            link_targets_ref = targets
        elif targets != link_targets_ref:
            raise ValueError(
                "Link-H targets differ across models — inputs are not "
                "consistent")
        keep = [i for key in m.res_order if key in sel
                for i in m.residues[key].atoms if i not in skip]
        raw = sum(len(m.residues[k].atoms) for k in sel)
        counts.append({"raw_atoms": raw, "kept_atoms": len(keep),
                       "link_h": len(link_h) if add_link_h else 0,
                       "n_residues": len(sel)})
        all_lines.append(_write_model_lines(
            m, keep, link_h if add_link_h else []))
        if verbose:
            print(f"[extract] model {mi}: {len(sel)} residues, "
                  f"{raw} raw atoms -> {len(keep)} kept"
                  + (f" + {len(link_h)} link-H" if add_link_h else ""))

    # outputs
    if outputs:
        outputs = [Path(o) for o in (outputs if isinstance(outputs,
                                                           (list, tuple))
                                     else [outputs])]
    else:
        outputs = ([Path("pocket.pdb")] if len(inputs) == 1 else
                   [Path(f"pocket_{p.stem}.pdb") for p in inputs])

    written = []
    if len(outputs) == 1 and len(models) > 1:
        lines = []
        for mi, ml in enumerate(all_lines):
            lines.append(f"MODEL     {mi + 1:>4d}")
            lines.extend(ml)
            lines.append("ENDMDL")
        lines.append("END")
        outputs[0].write_text("\n".join(lines) + "\n")
        written = [outputs[0]]
    else:
        if len(outputs) != len(models):
            raise ValueError("Provide one output or one per input")
        for o, ml in zip(outputs, all_lines):
            o.write_text("\n".join(ml + ["END"]) + "\n")
            written.append(o)

    charge = compute_charge_summary(models[0],
                                    {k for k in models[0].res_order
                                     if (k[0], k[2], k[3], k[4]) in id_union},
                                    per_model_sub[0], ligand_charge)
    if verbose:
        print(f"[extract] charge summary: {charge}")
    return {"outputs": [str(w) for w in written], "counts": counts,
            "charge_summary": charge}
