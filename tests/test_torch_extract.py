"""Pocket extraction, element repair, residue tables and the full-system
merge of the port (``bio/extract.py``, ``bio/add_elem.py``,
``bio/residues.py``, ``bio/merge.py``, ``core/neighbors.radius_query``)
against the JAX package's on the same inputs:

- ``extract_api`` on the complex of ``tests/test_extract.py`` and on a
  two-model pair: the pocket PDB text byte for byte, the counts and the
  charge summary equal, over the option grid (radius, radius_het2het,
  waters, backbone, link hydrogens, forced residues, residue-ID and
  substrate-PDB modes, one multi-MODEL file or one file per input);
- the radius query on the CPU against the JAX package's
  ``native.radius_query`` on a random cloud with points placed at the
  cutoff +- 1e-12 Angstrom (the same hits);
- ``assign_elements`` / ``guess_element`` / ``pdb_needs_elem_fix`` and the
  merge functions against JAX's;
- the twins of ``tests/test_extract.py:61-140`` and ``tests/test_bio.py:71``.
"""

from pathlib import Path

import numpy as np
import pytest

from pdb2reaction_tpu import native as j_native
from pdb2reaction_tpu.bio import add_elem as j_add
from pdb2reaction_tpu.bio import merge as j_merge
from pdb2reaction_tpu.bio.extract import extract_api as j_extract
from pdb2reaction_tpu.core import io_pdb as j_pdb
from pdb2reaction_tpu_torch.bio import add_elem, merge, residues
from pdb2reaction_tpu_torch.bio.add_elem import (assign_elements,
                                                 guess_element,
                                                 pdb_needs_elem_fix)
from pdb2reaction_tpu_torch.bio.extract import extract_api
from pdb2reaction_tpu_torch.core import io_pdb
from pdb2reaction_tpu_torch.core.neighbors import radius_query
from test_extract import _atom, build_complex_pdb


def _extended_pdb(path):
    """The complex plus a peptide PRO / GLU pair, a disulfide CYS pair, a
    second ligand near ZN and a sodium ion, so that the proline,
    disulfide and hetero-hetero rules have work."""
    build_complex_pdb(path)
    extra = [
        # GLU 20 - PRO 21 peptide, PRO's ring near the ligand
        _atom(23, "N", "GLU", "A", 20, (-6.0, 1.0, 0.0)),
        _atom(24, "CA", "GLU", "A", 20, (-5.0, 1.6, 0.0), element="C"),
        _atom(25, "C", "GLU", "A", 20, (-3.9, 0.8, 0.0)),
        _atom(26, "O", "GLU", "A", 20, (-3.9, -0.4, 0.0)),
        _atom(27, "CB", "GLU", "A", 20, (-5.2, 3.1, 0.0), element="C"),
        _atom(28, "N", "PRO", "A", 21, (-2.8, 1.5, 0.0)),
        _atom(29, "CA", "PRO", "A", 21, (-1.6, 0.8, 0.3), element="C"),
        _atom(30, "C", "PRO", "A", 21, (-1.5, -0.7, 2.0)),
        _atom(31, "O", "PRO", "A", 21, (-1.0, -1.3, 3.0)),
        _atom(32, "CB", "PRO", "A", 21, (-1.0, 1.9, 1.2), element="C"),
        _atom(33, "CG", "PRO", "A", 21, (-2.0, 3.0, 1.0), element="C"),
        _atom(34, "CD", "PRO", "A", 21, (-3.0, 2.8, 0.2), element="C"),
        # CYS 30 near the ligand, CYS 31 bridged by SG-SG 2.05 A
        _atom(35, "N", "CYS", "B", 30, (3.0, -4.0, 1.0)),
        _atom(36, "CA", "CYS", "B", 30, (2.5, -3.0, 1.5), element="C"),
        _atom(37, "C", "CYS", "B", 30, (3.5, -2.0, 2.0)),
        _atom(38, "O", "CYS", "B", 30, (4.5, -2.2, 2.5)),
        _atom(39, "CB", "CYS", "B", 30, (1.8, -2.2, 0.5), element="C"),
        _atom(40, "SG", "CYS", "B", 30, (1.5, -1.2, -0.9), element="S"),
        _atom(41, "N", "CYS", "B", 31, (6.0, 1.0, -3.0)),
        _atom(42, "CA", "CYS", "B", 31, (5.5, 0.0, -3.5), element="C"),
        _atom(43, "C", "CYS", "B", 31, (6.5, -1.0, -4.0)),
        _atom(44, "O", "CYS", "B", 31, (7.5, -0.8, -4.5)),
        _atom(45, "CB", "CYS", "B", 31, (4.0, -0.3, -3.0), element="C"),
        _atom(46, "SG", "CYS", "B", 31, (3.3, -1.0, -1.6), element="S"),
        # a second ligand by the zinc, and a sodium ion
        _atom(47, "N1", "MOL", "C", 200, (0.5, 1.0, 4.5), record="HETATM",
              element="N"),
        _atom(48, "C1", "MOL", "C", 200, (1.0, 2.0, 5.3), record="HETATM",
              element="C"),
        _atom(49, "NA", "NA", "C", 300, (8.0, 8.0, 8.0), record="HETATM",
              element="Na"),
    ]
    lines = [ln for ln in Path(path).read_text().splitlines()
             if ln != "END"]
    lines += [io_pdb.format_pdb_line(a, (a["x"], a["y"], a["z"]))
              for a in extra]
    Path(path).write_text("\n".join(lines + ["END"]) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("extract")
    r, p, ext = d / "R.pdb", d / "P.pdb", d / "X.pdb"
    build_complex_pdb(r)
    p.write_text(r.read_text().replace("1.200   0.000   0.000",
                                       "2.300   0.000   0.000"))
    _extended_pdb(ext)
    sub = d / "sub.pdb"
    sub.write_text("\n".join(ln for ln in r.read_text().splitlines()
                             if " LIG " in ln) + "\nEND\n")
    return {"R": r, "P": p, "X": ext, "sub": sub}


GRID = [
    ("X", "LIG", {}),
    ("X", "LIG", {"radius": 3.4}),
    ("X", "LIG", {"radius": 2.2, "radius_het2het": 3.0}),
    ("X", "LIG", {"include_h2o": False, "ligand_charge": "LIG:-1,MOL:1"}),
    ("X", "LIG", {"exclude_backbone": False, "radius": 3.0}),
    ("X", "LIG", {"exclude_backbone": False, "add_link_h": False}),
    ("X", "LIG", {"selected_resn": ["A:12", "31"], "ligand_charge": 2}),
    ("X", "A:100", {"ligand_charge": -1}),
    ("X", "100,C:200", {}),
    ("X", "LIG MOL", {"radius": 2.8}),
    ("X", "sub", {}),
    ("RP", "LIG", {}),
    ("RP", "LIG", {"exclude_backbone": False}),
    ("RP1", "LIG", {"ligand_charge": 0}),
]


@pytest.mark.parametrize("which,center,kw", GRID)
def test_extract_api_matches_jax(inputs, tmp_path, which, center, kw):
    src = {"X": [inputs["X"]], "RP": [inputs["R"], inputs["P"]],
           "RP1": [inputs["R"], inputs["P"]]}[which]
    center = str(inputs["sub"]) if center == "sub" else center
    n_out = 1 if which != "RP" else 2
    outs = [tmp_path / f"p{k}.pdb" for k in range(n_out)]
    jouts = [tmp_path / f"j{k}.pdb" for k in range(n_out)]
    res = extract_api(src, center, outs, device="cpu", **kw)
    jres = j_extract(src, center, jouts, **kw)
    for a, b in zip(outs, jouts):
        assert a.read_bytes() == b.read_bytes()
    assert res["counts"] == jres["counts"]
    assert res["charge_summary"] == jres["charge_summary"]
    assert res["outputs"] == [str(o) for o in outs]


def test_extract_refusals_match_jax(inputs, tmp_path):
    short = tmp_path / "short.pdb"
    short.write_text("\n".join(inputs["R"].read_text().splitlines()[:-3])
                     + "\nEND\n")
    for args in (([inputs["R"], short], "LIG"), ([inputs["R"]], "XXX"),
                 ([inputs["R"]], "B:77")):
        with pytest.raises(ValueError) as e:
            extract_api(*args, [tmp_path / "o.pdb"], device="cpu")
        with pytest.raises(ValueError) as je:
            j_extract(*args, [tmp_path / "o.pdb"])
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_radius_query_matches_native(seed):
    """Random cloud plus points at the cutoff +- 1e-12 from a centre: the
    same (atom, centre) hits as the JAX package's native query."""
    rng = np.random.default_rng(seed)
    cutoff = 2.6
    coords = rng.uniform(-8.0, 8.0, size=(700, 3))
    centers = rng.uniform(-6.0, 6.0, size=(40, 3))
    u = rng.normal(size=(60, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    which = rng.integers(0, len(centers), size=60)
    sign = np.where(np.arange(60) % 2 == 0, 1.0, -1.0)
    edge = centers[which] + (cutoff + sign * 1e-12)[:, None] * u
    coords = np.concatenate([coords, edge])
    got = radius_query(coords, centers, cutoff, device="cpu")
    ref = j_native.radius_query(coords, centers, cutoff)
    as_set = lambda h: set(map(tuple, np.asarray(h).tolist()))  # noqa
    assert as_set(got) == as_set(ref)
    inside = {(len(coords) - 60 + k, int(which[k])) for k in range(60)
              if sign[k] < 0}
    outside = {(len(coords) - 60 + k, int(which[k])) for k in range(60)
               if sign[k] > 0}
    assert inside <= as_set(got) and not (outside & as_set(got))
    assert radius_query(coords, centers[:0], cutoff, device="cpu").shape \
        == (0, 2)


def test_radius_query_cuda_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA query runs")
    with pytest.raises(RuntimeError, match="cuda"):
        radius_query(np.zeros((2, 3)), np.zeros((1, 3)), 1.0)


def test_extract_basic(inputs, tmp_path):
    """Twin of tests/test_extract.py:61."""
    out = tmp_path / "pocket.pdb"
    res = extract_api([inputs["R"]], "LIG", [out], ligand_charge=-1,
                      device="cpu")
    st = io_pdb.read_pdb(out)
    names = [a["name"] for a in st.pdb_atoms]
    resnames = {a["resname"] for a in st.pdb_atoms}
    assert "C1" in names and "O1" in names
    assert "OG" in names and "OD1" in names
    assert "GLY" not in resnames
    assert "ZN" in resnames and "HOH" in resnames
    ser_names = [a["name"] for a in st.pdb_atoms if a["resname"] == "SER"]
    assert "CA" not in ser_names and "N" not in ser_names
    hl = [a for a in st.pdb_atoms if a["resname"] == "LKH"]
    assert len(hl) == 2
    assert all(a["name"] == "HL" for a in hl)
    cb_ser = next(a for a in st.pdb_atoms
                  if a["resname"] == "SER" and a["name"] == "CB")
    d = min(np.hypot(np.hypot(a["x"] - cb_ser["x"], a["y"] - cb_ser["y"]),
                     a["z"] - cb_ser["z"]) for a in hl)
    assert d == pytest.approx(1.09, abs=1e-2)
    cs = res["charge_summary"]
    assert cs["protein_charge"] == -1
    assert cs["ion_charge"] == 2
    assert cs["ligand_charge"] == -1
    assert cs["total_charge"] == 0


def test_extract_by_resid_and_id_modes(inputs, tmp_path):
    """Twin of tests/test_extract.py:98."""
    out = tmp_path / "p.pdb"
    extract_api([inputs["R"]], "A:100", [out], device="cpu")
    st = io_pdb.read_pdb(out)
    assert any(a["resname"] == "LIG" for a in st.pdb_atoms)


def test_extract_multi_model(inputs, tmp_path):
    """Twin of tests/test_extract.py:107."""
    out = tmp_path / "multi.pdb"
    res = extract_api([inputs["R"], inputs["R"]], "LIG", [out],
                      device="cpu")
    text = out.read_text()
    assert text.count("MODEL") == 2
    assert text.count("ENDMDL") == 2
    assert len(res["counts"]) == 2
    assert res["counts"][0]["kept_atoms"] == res["counts"][1]["kept_atoms"]


def test_guess_element():
    """Twin of tests/test_extract.py:121, and every case against JAX."""
    assert guess_element("OG", "SER") == "O"
    assert guess_element("1HB", "ALA") == "H"
    assert guess_element("ZN", "ZN") == "Zn"
    assert guess_element("FE1", "LIG") == "Fe"
    assert guess_element("SE", "MSE") == "Se"
    assert guess_element("H2", "HOH") == "H"
    for name, res in (("CA", "ALA"), ("CA", "CA"), ("CL1", "LIG"),
                      ("DG", "LYS"), ("SEG", "SEC"), ("123", "LIG"),
                      ("C5'", "DA"), ("NA", "NA+"), ("BR", "LIG"),
                      ("O", "WAT"), ("HB2", "UNK")):
        assert guess_element(name, res) == j_add.guess_element(name, res)
    for raw in ("", " c", "CL", "cl", "Xx", "FE", "1"):
        assert add_elem.normalize_element(raw) == \
            j_add.normalize_element(raw)


def test_assign_elements(inputs, tmp_path):
    """Twin of tests/test_extract.py:130, and the files against JAX."""
    lines = [ln[:76].rstrip() if ln.startswith(("ATOM", "HETATM")) else ln
             for ln in inputs["X"].read_text().splitlines()]
    noelem = tmp_path / "noelem.pdb"
    noelem.write_text("\n".join(lines) + "\n")
    assert pdb_needs_elem_fix(noelem) and j_add.pdb_needs_elem_fix(noelem)
    summary = assign_elements(noelem, tmp_path / "fixed.pdb", verbose=False)
    jsummary = j_add.assign_elements(noelem, tmp_path / "jfixed.pdb",
                                     verbose=False)
    assert summary["fixed"] == 49
    assert {k: v for k, v in summary.items() if k != "output"} == \
        {k: v for k, v in jsummary.items() if k != "output"}
    assert (tmp_path / "fixed.pdb").read_bytes() == \
        (tmp_path / "jfixed.pdb").read_bytes()
    assert not pdb_needs_elem_fix(tmp_path / "fixed.pdb")
    st = io_pdb.read_pdb(tmp_path / "fixed.pdb")
    assert st.symbols.count("Zn") == 1 and st.symbols.count("Na") == 1


def test_residue_tables():
    """Twin of tests/test_bio.py:71."""
    assert residues.residue_formal_charge("ASP") == -1
    assert residues.residue_formal_charge("LYS") == 1
    assert residues.residue_formal_charge("HIP") == 1
    assert residues.residue_formal_charge("ZN") == 2
    assert residues.residue_formal_charge("CGLU") == -2
    assert residues.residue_formal_charge("NLYS") == 2
    assert residues.is_water("HOH") and residues.is_water("WAT")
    assert residues.is_amino_acid("SEP")
    assert residues.residue_formal_charge("XYZ") == 0
    from pdb2reaction_tpu.bio import residues as j_res
    assert residues.AMINO_ACIDS == j_res.AMINO_ACIDS
    assert residues.ION == j_res.ION
    assert (residues.LINK_H_NAME, residues.LINK_H_RESNAME) == \
        (j_res.LINK_H_NAME, j_res.LINK_H_RESNAME)


def test_merge_matches_jax(inputs, tmp_path):
    pocket = tmp_path / "pocket.pdb"
    extract_api([inputs["X"]], "LIG", [pocket], device="cpu")
    full, fp = io_pdb.read_pdb(inputs["X"]), io_pdb.read_pdb(pocket)
    jfull, jp = j_pdb.read_pdb(inputs["X"]), j_pdb.read_pdb(pocket)
    assert merge.atom_keys(full.pdb_atoms) == j_merge.atom_keys(jfull.pdb_atoms)
    m = merge.map_full_to_pocket(full.pdb_atoms, fp.pdb_atoms)
    assert m == j_merge.map_full_to_pocket(jfull.pdb_atoms, jp.pdb_atoms)
    some = sorted(m)[::2]
    assert merge.remap_indices(some, full.pdb_atoms, fp.pdb_atoms) == \
        j_merge.remap_indices(some, jfull.pdb_atoms, jp.pdb_atoms)
    missing = next(i for i in range(full.n_atoms) if i not in m)
    with pytest.raises(ValueError, match="not present"):
        merge.remap_indices([missing], full.pdb_atoms, fp.pdb_atoms)
    rng = np.random.default_rng(2)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    moved = (fp.coords + rng.normal(scale=0.05, size=fp.coords.shape)) @ rot
    bg = full.coords + 0.3
    for kw in ({}, {"full_coords_ang": bg}):
        a = merge.merge_pocket_into_full(full, fp, moved, **kw)
        b = j_merge.merge_pocket_into_full(jfull, jp, moved, **kw)
        np.testing.assert_allclose(a.coords, b.coords, rtol=0, atol=1e-12)
        assert a.n_atoms == full.n_atoms
