"""PDB and GJF input and output of the port (``core/io_pdb.py``,
``core/io_gjf.py``, the PDB parts of ``workflows/common.py``) against
the JAX package's, on the same records:

- ``parse_pdb_atoms`` / ``read_pdb`` equal, and ``write_pdb``,
  ``overlay_coords_on_template``, ``write_pdb_frames`` and
  ``format_pdb_line`` byte for byte, on records with HETATM, four-letter
  names, negative coordinates, blank element columns, altlocs and
  insertion codes;
- the GJF round trip byte for byte (``read_gjf``, ``write_gjf``,
  ``GjfTemplate.render``);
- ``resolve_atom_spec``, ``detect_freeze_links``, ``merge_freeze``,
  ``load_structure`` with a ``--ref-pdb`` template, ``resolve_charge_spin``
  (.gjf values, ``--ligand-charge``, the refusals) and the .pdb / .gjf
  companions of ``write_outputs`` / ``write_trajectory``, byte for byte;
- the twins of ``tests/test_core.py:70,86`` and
  ``tests/test_config_io.py:60``.
"""

import numpy as np
import pytest

from pdb2reaction_tpu.core import io_gjf as j_gjf
from pdb2reaction_tpu.core import io_pdb as j_pdb
from pdb2reaction_tpu.workflows import common as j_common
from pdb2reaction_tpu_torch.core import io_gjf, io_pdb
from pdb2reaction_tpu_torch.workflows import common

PDB_TEXT = """\
ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  C   ALA A   1      10.722   6.802  -4.199  1.00  0.00           C
HETATM    4 ZN    ZN A  90       1.000   2.000   3.000  1.00  0.00          ZN
HETATM    5  HL  LKH A  99       0.000   0.000   0.000  1.00  0.00           H
END
"""

# HETATM, a four-letter name, negative coordinates, blank element
# columns, an altloc, an insertion code, a blank chain, a charge field, a
# second MODEL that must be ignored
EDGE_TEXT = """\
REMARK   1 edge cases
MODEL        1
ATOM      1  N  AASN B  12A    -11.104  -6.134  -6.504  0.50 12.30      SEGA N
ATOM      2 HD21 ASN B  12A     -1.639   6.071  -5.147  1.00  0.00           H
ATOM      3 1HB  ASN B  12A      0.722  -0.802  -4.199  1.00  0.00
ATOM      4  CA  ASN B  13       2.000   3.000   4.000  1.00  0.00
HETATM    5 CL1  LIG    500     -99.123 -88.456 -77.789  1.00 99.99          CL1-
HETATM    6 FE    FE X 601      -0.001   0.001  -0.000  1.00  0.00
HETATM    7  O   HOH W 900       5.500   5.500   5.500  1.00  0.00           O
ENDMDL
MODEL        2
ATOM      1  N   ALA A   1       0.000   0.000   0.000  1.00  0.00           N
ENDMDL
END
"""

GJF = """%mem=4GB
#p wb97xd/def2svp opt

water opt

0 1
O    0.000000   0.000000   0.000000
H    0.960000   0.000000   0.000000
H   -0.240000   0.930000   0.000000

"""

GJF_TAIL = """%chk=x.chk
%nprocs=4
#p b3lyp/6-31g(d) freq
# scf=tight

charged
two lines

1 2
C   0.0 0.0 0.0
O   1.2 0.0 0.0

B 1 2 F

"""


@pytest.fixture(params=["plain", "edge"])
def pdb_path(tmp_path, request):
    p = tmp_path / "x.pdb"
    p.write_text(PDB_TEXT if request.param == "plain" else EDGE_TEXT)
    return p


def test_parse_and_read_match_jax(pdb_path):
    assert io_pdb.parse_pdb_atoms(pdb_path) == j_pdb.parse_pdb_atoms(pdb_path)
    st, jst = io_pdb.read_pdb(pdb_path), j_pdb.read_pdb(pdb_path)
    np.testing.assert_array_equal(st.numbers, jst.numbers)
    np.testing.assert_array_equal(st.coords, jst.coords)
    assert st.pdb_atoms == jst.pdb_atoms
    assert st.source_path == jst.source_path == str(pdb_path)


def test_write_pdb_byte_for_byte(tmp_path, pdb_path):
    st, jst = io_pdb.read_pdb(pdb_path), j_pdb.read_pdb(pdb_path)
    io_pdb.write_pdb(tmp_path / "a.pdb", st, remark="port")
    j_pdb.write_pdb(tmp_path / "b.pdb", jst, remark="port")
    assert (tmp_path / "a.pdb").read_bytes() == \
        (tmp_path / "b.pdb").read_bytes()
    # structures without records get the MOL template
    bare = st.copy()
    bare.pdb_atoms = None
    jbare = jst.copy()
    jbare.pdb_atoms = None
    io_pdb.write_pdb(tmp_path / "c.pdb", bare)
    j_pdb.write_pdb(tmp_path / "d.pdb", jbare)
    assert (tmp_path / "c.pdb").read_bytes() == \
        (tmp_path / "d.pdb").read_bytes()


def test_overlay_and_frames_byte_for_byte(tmp_path, pdb_path):
    st = io_pdb.read_pdb(pdb_path)
    rng = np.random.default_rng(0)
    new = st.coords + rng.normal(scale=3.0, size=st.coords.shape)
    io_pdb.overlay_coords_on_template(pdb_path, new, tmp_path / "a.pdb",
                                      remark="r")
    j_pdb.overlay_coords_on_template(pdb_path, new, tmp_path / "b.pdb",
                                     remark="r")
    assert (tmp_path / "a.pdb").read_bytes() == \
        (tmp_path / "b.pdb").read_bytes()
    frames = [st.coords + 0.1 * k for k in range(3)]
    io_pdb.write_pdb_frames(tmp_path / "f.pdb", st, frames,
                            energies=[-1.5, -1.25, -1.0])
    j_pdb.write_pdb_frames(tmp_path / "g.pdb", j_pdb.read_pdb(pdb_path),
                           frames, energies=[-1.5, -1.25, -1.0])
    assert (tmp_path / "f.pdb").read_bytes() == \
        (tmp_path / "g.pdb").read_bytes()
    with pytest.raises(ValueError, match="template atoms"):
        io_pdb.overlay_coords_on_template(pdb_path, new[:-1],
                                          tmp_path / "c.pdb")


@pytest.mark.parametrize("atom", [
    dict(record="HETATM", serial=123456, name="HL", rawname=" HL ",
         resname="LKH", chain="L", resseq=12345, element="H"),
    dict(record="ATOM", serial=7, name="HD21", resname="ASN", chain="B",
         resseq=-3, icode="A", altloc="B", element="H", occupancy=0.5,
         bfactor=99.99, segid="SEGX"),
    dict(record="ATOM", serial=8, name="CA", resname="ALA", element="C"),
    dict(record="HETATM", serial=9, name="CL1", resname="LIGAND",
         element="CL"),
])
def test_format_pdb_line_matches_jax(atom):
    for xyz in ((-99.123456, 0.0005, 1234.5), (1.0, -2.0, -0.0004)):
        assert io_pdb.format_pdb_line(atom, xyz) == \
            j_pdb.format_pdb_line(atom, xyz)


def test_pdb_parse_write(tmp_path):
    """Twin of tests/test_core.py:70."""
    p = tmp_path / "x.pdb"
    p.write_text(PDB_TEXT)
    st = io_pdb.read_pdb(p)
    assert st.n_atoms == 5
    assert st.symbols == ["N", "C", "C", "Zn", "H"]
    assert st.pdb_atoms[0]["resname"] == "ALA"
    assert st.pdb_atoms[3]["record"] == "HETATM"
    assert st.pdb_atoms[4]["resname"] == "LKH"
    out = tmp_path / "y.pdb"
    io_pdb.write_pdb(out, st)
    st2 = io_pdb.read_pdb(out)
    assert st2.symbols == st.symbols
    np.testing.assert_allclose(st2.coords, st.coords, atol=1e-3)


def test_pdb_overlay(tmp_path):
    """Twin of tests/test_core.py:86."""
    p = tmp_path / "x.pdb"
    p.write_text(PDB_TEXT)
    st = io_pdb.read_pdb(p)
    new = st.coords + 1.0
    out = tmp_path / "z.pdb"
    io_pdb.overlay_coords_on_template(p, new, out)
    st2 = io_pdb.read_pdb(out)
    np.testing.assert_allclose(st2.coords, new, atol=1e-3)


def test_gjf_roundtrip(tmp_path):
    """Twin of tests/test_config_io.py:60."""
    p = tmp_path / "w.gjf"
    p.write_text(GJF)
    st = io_gjf.read_gjf(p)
    assert st.symbols == ["O", "H", "H"]
    assert (st.charge, st.spin) == (0, 1)
    assert (st.gjf_template.charge, st.gjf_template.spin) == (0, 1)
    st.coords = st.coords + 0.5
    out = tmp_path / "w2.gjf"
    io_gjf.write_gjf(out, st)
    text = out.read_text()
    assert "%mem=4GB" in text
    assert "#p wb97xd/def2svp opt" in text
    st2 = io_gjf.read_gjf(out)
    np.testing.assert_allclose(st2.coords, st.coords, atol=1e-6)


@pytest.mark.parametrize("text", [GJF, GJF_TAIL])
def test_gjf_matches_jax_byte_for_byte(tmp_path, text):
    p = tmp_path / "in.gjf"
    p.write_text(text)
    st, jst = io_gjf.read_gjf(p), j_gjf.read_gjf(p)
    assert (st.charge, st.spin, st.symbols) == (jst.charge, jst.spin,
                                                jst.symbols)
    t, jt = st.gjf_template, jst.gjf_template
    assert (t.link0, t.route, t.title, t.tail) == (jt.link0, jt.route,
                                                   jt.title, jt.tail)
    x = st.coords * 1.1 - 0.3
    assert t.render(x) == jt.render(x)
    # the template rides along copies, as in the JAX package
    moved, jmoved = st.copy(coords=x), jst.copy(coords=x)
    io_gjf.write_gjf(tmp_path / "a.gjf", moved)
    j_gjf.write_gjf(tmp_path / "b.gjf", jmoved)
    assert (tmp_path / "a.gjf").read_bytes() == \
        (tmp_path / "b.gjf").read_bytes()
    # a structure with no template renders the plain one
    from pdb2reaction_tpu.core.structure import Structure as JStructure
    from pdb2reaction_tpu_torch.core.structure import Structure
    io_gjf.write_gjf(tmp_path / "c.gjf", Structure(st.numbers, x, charge=-1,
                                                   spin=2))
    j_gjf.write_gjf(tmp_path / "d.gjf", JStructure(st.numbers, x, charge=-1,
                                                   spin=2))
    assert (tmp_path / "c.gjf").read_bytes() == \
        (tmp_path / "d.gjf").read_bytes()


def test_resolve_atom_spec_matches_jax(tmp_path):
    p = tmp_path / "x.pdb"
    p.write_text(EDGE_TEXT)
    st, jst = io_pdb.read_pdb(p), j_pdb.read_pdb(p)
    for spec in (3, "4", "-1", "ASN 12 HD21", "asn 13 ca", "HOH 900 O",
                 "FE 601 FE"):
        assert common.resolve_atom_spec(spec, st) == \
            j_common.resolve_atom_spec(spec, jst)
    for bad in ("ASN 12", "ASN 12 XX", "LIG 500"):
        with pytest.raises(ValueError) as e:
            common.resolve_atom_spec(bad, st)
        with pytest.raises(ValueError) as je:
            j_common.resolve_atom_spec(bad, jst)
        assert str(e.value) == str(je.value)


def test_detect_freeze_links_and_merge_freeze_match_jax(tmp_path):
    from test_extract import build_complex_pdb
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    full = tmp_path / "c.pdb"
    build_complex_pdb(full)
    pocket = tmp_path / "p.pdb"
    extract_api([full], "LIG", [pocket], device="cpu")
    links = common.detect_freeze_links(pocket)
    assert links == j_common.detect_freeze_links(pocket) and len(links) == 2
    assert common.detect_freeze_links(full) == []
    st, jst = io_pdb.read_pdb(pocket), j_pdb.read_pdb(pocket)
    for extra, auto in (([0, 3], True), ([0, 3], False), ([], True)):
        assert common.merge_freeze(st, extra, auto) == \
            j_common.merge_freeze(jst, extra, auto)


def test_load_structure_and_ref_pdb_match_jax(tmp_path):
    p = tmp_path / "x.pdb"
    p.write_text(PDB_TEXT)
    g = tmp_path / "w.gjf"
    g.write_text(GJF)
    xyz = tmp_path / "x.xyz"
    xyz.write_text("5\nc\nN 0 0 0\nC 1 0 0\nC 2 0 0\nZn 3 0 0\nH 4 0 0\n")
    for path in (p, g, xyz):
        st, jst = common.load_structure(path), j_common.load_structure(path)
        np.testing.assert_array_equal(st.coords, jst.coords)
        assert st.input_suffix == jst.input_suffix
    st = common.load_structure(xyz, ref_pdb=p)
    jst = j_common.load_structure(xyz, ref_pdb=p)
    assert st.pdb_atoms == jst.pdb_atoms
    assert str(st.source_path) == str(jst.source_path)
    bad = tmp_path / "b.xyz"
    bad.write_text("1\n\nH 0 0 0\n")
    with pytest.raises(ValueError, match="atoms but the input"):
        common.load_structure(bad, ref_pdb=p)
    with pytest.raises(ValueError, match="Unsupported"):
        common.load_structure(tmp_path / "x.mol2")


def test_resolve_charge_spin_matches_jax(tmp_path, capsys):
    from test_extract import build_complex_pdb
    pdb = tmp_path / "c.pdb"
    build_complex_pdb(pdb)
    g = tmp_path / "w.gjf"
    g.write_text(GJF_TAIL)
    xyz = tmp_path / "a.xyz"
    xyz.write_text("1\nc\nH 0 0 0\n")
    cases = [(g, None, None, None), (g, 3, None, None), (pdb, None, 2, -1),
             (pdb, None, None, "LIG:2"), (pdb, 5, None, -1)]
    for path, q, s, lc in cases:
        st, jst = common.load_structure(path), j_common.load_structure(path)
        assert common.resolve_charge_spin(st, q, s, lc) == \
            j_common.resolve_charge_spin(jst, q, s, lc)
    for path, lc in ((xyz, None), (xyz, -1), (g, -1), (pdb, None)):
        st, jst = common.load_structure(path), j_common.load_structure(path)
        with pytest.raises(ValueError) as e:
            common.resolve_charge_spin(st, None, None, lc)
        with pytest.raises(ValueError) as je:
            j_common.resolve_charge_spin(jst, None, None, lc)
        msg = str(je.value).split(" (reference")[0]
        assert str(e.value) == msg


@pytest.mark.parametrize("suffix", [".pdb", ".gjf"])
def test_write_outputs_companions_match_jax(tmp_path, suffix):
    src = tmp_path / f"in{suffix}"
    if suffix == ".pdb":
        src.write_text(PDB_TEXT)
    else:
        src.write_text(GJF)
    st, jst = common.load_structure(src), j_common.load_structure(src)
    rng = np.random.default_rng(1)
    x = st.coords_bohr + rng.normal(scale=0.2, size=st.coords.shape)
    frames = [x, x + 0.1, x - 0.2]
    for mod, s, d in ((common, st, "p"), (j_common, jst, "j")):
        mod.write_outputs(tmp_path / d, "geom", s, x, energy=-1.25)
        mod.write_trajectory(tmp_path / d, "traj", s, frames,
                             [-1.0, -0.5, -0.75])
    names = sorted(f.name for f in (tmp_path / "p").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "j").iterdir())
    assert len(names) == (4 if suffix == ".pdb" else 3)
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
    # conversion off: the .xyz / .trj alone
    common.set_convert_enabled(False)
    try:
        paths = common.write_outputs(tmp_path / "off", "geom", st, x)
    finally:
        common.set_convert_enabled(True)
    assert [p.name for p in paths] == ["geom.xyz"]
