"""Port ``path-search`` (``workflows/path_search.py``, ``summary.py``,
the CLI) against the JAX package's:

- twins of ``tests/test_path_search.py``: the single-step search on
  Morse H3 through the CLI (the output tree, a reactive segment, the
  stitched MEP from R to P), the kink case (no covalent change) and the
  stitch dropping a duplicated boundary image;
- whole searches on Morse H3 through both packages' ``run_path_search``
  at odd ``max_nodes`` (at an even count the two middle images tie to
  the last bit and the string may come out mirrored): a reactive step,
  a kink, and three inputs (two pairs). The same segment kinds,
  reactive flags, HEI indices and image counts; energies within 1e-8
  Hartree, images within 1e-7 Bohr (the bound ``test_torch_gsm.py``
  holds the H3 string to); ``summary.yaml`` equal to the JAX package's
  under ``yaml.safe_load`` (floats within 1e-8, everything else
  exactly), the segment-level ones too. Force calls are not compared:
  the JAX Cartesian L-BFGS counts none (ROADMAP.md queue 3);
- the full-system merge (``--ref-full-pdb`` / ``full_template``) on
  the pocket of ``tests/test_extract.py``'s complex: every merged PDB
  carries the full atom count, and its frames are the JAX package's
  ``merge_pocket_into_full`` of the pocket frames over the blended
  templates;
- DMF segments (``mep_mode="dmf"`` and the DMF keys) through the CLI
  and ``run_path_search`` against JAX's;
- the refusals of what is not ported, each naming its ROADMAP item,
  through the CLI and the library, before any output is written."""

import numpy as np
import pytest
import yaml

from pdb2reaction_tpu.workflows import path_search as j_ps
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.workflows.path_search import (PathSearch,
                                                          SegmentReport,
                                                          run_path_search)

H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H3B = "3\nproduct\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n"
# conformational variant of A (no covalent change): middle H off-axis
H3K = "3\nkink\nH 0.0 0.0 0.0\nH 0.64 0.25 0.0\nH 2.4 0.0 0.0\n"
COMMON = ["-q", "0", "--calc-mode", "morse", "--freeze-atoms", "0,2",
          "--device", "cpu"]


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def _cli(args):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    return e.value.code


def test_path_search_single_step(tmp_path):
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    out = tmp_path / "ps"
    assert _cli(["path-search", "-i", str(a), "-i", str(b), "--max-nodes",
                 "8", "--out-dir", str(out)] + COMMON) == 0
    for f in ("mep.trj", "summary.yaml", "summary.log",
              "energy_diagram.png", "mep_plot.png",
              "seg_000_mep/hei.xyz", "seg_000_mep/final_geometries.trj",
              "seg_000_mep/summary.yaml"):
        assert (out / f).exists(), f
    log = (out / "summary.log").read_text()
    assert "reactive" in log and "bonds formed" in log
    # the stitched MEP is continuous and covers R -> P
    frames = io_xyz.read_xyz_frames(out / "mep.trj")
    assert frames[0].coords[1, 0] == pytest.approx(0.705, abs=0.05)
    assert frames[-1].coords[1, 0] == pytest.approx(1.695, abs=0.05)
    doc = yaml.safe_load((out / "summary.yaml").read_text())
    assert doc["diagram"]["chain"] == "R --> TS1 --> P"
    seg = yaml.safe_load((out / "seg_000_mep" / "summary.yaml").read_text())
    assert seg["pair_index"] == 0 and seg["weights"] == "analytic"


def test_path_search_kink(tmp_path):
    a = _write(tmp_path, "A.xyz", H3A)
    k = _write(tmp_path, "K.xyz", H3K)
    out = tmp_path / "ps"
    assert _cli(["path-search", "-i", str(a), "-i", str(k), "--out-dir",
                 str(out)] + COMMON) == 0
    summary = yaml.safe_load((out / "summary.yaml").read_text())
    # after preopt both conformers relax into the same well: a pure kink
    # segment or nothing reactive
    assert all(not s["reactive"] for s in summary["segments"])


def test_stitch_drops_duplicate_boundary_image():
    c = [np.full((3, 3), float(k)) for k in range(4)]
    seg_a = SegmentReport(images_bohr=[c[0], c[1], c[2]],
                          energies=[0.0, 0.5, 0.1], hei_idx=1,
                          is_reactive=True)
    seg_b = SegmentReport(images_bohr=[c[2], c[3]],
                          energies=[0.1, 0.0], hei_idx=0,
                          is_reactive=True)
    ps = PathSearch.__new__(PathSearch)
    ps.kw = {"rmsd_dedup_thresh": 1e-3, "bridge_rmsd_thresh": 1e9}
    ps.verbose = False
    out = ps._stitch([seg_a, seg_b])
    assert len(out) == 2
    # boundary image dropped from the later segment, hei reindexed
    assert len(out[1].images_bohr) == 1
    assert out[1].energies == [0.0]
    assert out[1].hei_idx == 0


def test_trj_energies_and_profile_match_jax(tmp_path):
    """read_trj_energies and plot_profile's CSV as the JAX package's on
    the same trajectory (each reference frame choice)."""
    from pdb2reaction_tpu.workflows import trj2fig as j_trj2fig
    from pdb2reaction_tpu_torch.workflows import trj2fig
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    res = run_path_search([a, b], charge=0, calc_mode="morse", device="cpu",
                          freeze_atoms=[0, 2], verbose=False,
                          out_dir=tmp_path / "ps", gs_kw={"max_nodes": 7})
    trj = tmp_path / "ps" / "mep.trj"
    es = trj2fig.read_trj_energies(trj)
    assert es == j_trj2fig.read_trj_energies(trj)
    assert np.abs(np.subtract(es, res["mep_energies"])).max() <= 1e-12
    for ref in ("first", "min", "last", "none"):
        for mod, tag in ((trj2fig, "port"), (j_trj2fig, "jax")):
            mod.plot_profile(tmp_path / f"{tag}_{ref}.png", es,
                             reference=ref,
                             csv_path=tmp_path / f"{tag}_{ref}.csv")
        assert (tmp_path / f"port_{ref}.png").exists()
        assert (tmp_path / f"port_{ref}.csv").read_text() == \
            (tmp_path / f"jax_{ref}.csv").read_text()


def _same(a, b, where="", tol=1e-8):
    """Equal YAML documents: floats within ``tol``, all else exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}", tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]", tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol, (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("inputs,max_nodes,kinds", [
    (["A", "B"], 9, ["seg"]),
    (["A", "K"], 7, ["kink"]),
    (["A", "B", "A"], 7, ["seg", "seg"]),
])
def test_path_search_matches_jax(tmp_path, inputs, max_nodes, kinds):
    texts = {"A": H3A, "B": H3B, "K": H3K}
    paths = [_write(tmp_path, f"{k}{i}.xyz", texts[k])
             for i, k in enumerate(inputs)]
    kw = dict(charge=0, calc_mode="morse", freeze_atoms=[0, 2],
              verbose=False, gs_kw={"max_nodes": max_nodes})
    rj = j_ps.run_path_search(paths, out_dir=tmp_path / "jax", **kw)
    rt = run_path_search(paths, out_dir=tmp_path / "port", device="cpu",
                         **kw)
    sj, st = rj["segments"], rt["segments"]
    assert [s.kind for s in st] == [s.kind for s in sj] == kinds
    for a, b in zip(st, sj):
        assert (a.is_reactive, a.is_kink, a.hei_idx, a.pair_index,
                len(a.images_bohr)) == \
            (b.is_reactive, b.is_kink, b.hei_idx, b.pair_index,
             len(b.images_bohr))
        assert a.bond_summary == b.bond_summary
        assert np.abs(np.subtract(a.energies, b.energies)).max() <= 1e-8
        assert max(np.abs(x - y).max() for x, y in
                   zip(a.images_bohr, b.images_bohr)) <= 1e-7
    assert len(rt["mep_frames_bohr"]) == len(rj["mep_frames_bohr"])
    assert np.abs(np.subtract(rt["mep_energies"],
                              rj["mep_energies"])).max() <= 1e-8
    # summary.yaml (the run's and each segment's) as the JAX package's
    for rel in ["summary.yaml"] + [f"seg_{i:03d}_mep/summary.yaml"
                                   for i in range(len(st))]:
        _same(yaml.safe_load((tmp_path / "port" / rel).read_text()),
              yaml.safe_load((tmp_path / "jax" / rel).read_text()), rel)
    if kinds == ["kink"]:
        assert rt["segments_run"] == 0 and rt["energy_calls"] == 2
    else:
        assert rt["segments_run"] >= len(kinds)
    # the calculator counted every evaluation, L-BFGS's included
    assert rt["force_calls"] > 0


@pytest.mark.parametrize("flags,said", [
    (["--dump", "True"], "--dump"),
    (["--spatial", "2"], "torchrun --nproc-per-node 2"),
])
def test_path_search_cli_refuses_unported(tmp_path, capsys, flags, said):
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    out = tmp_path / "ps"
    with pytest.raises(SystemExit) as e:
        cli.main(["path-search", "-i", str(a), "-i", str(b), "--out-dir",
                  str(out)] + COMMON + flags)
    assert said in str(e.value.code)
    assert not out.exists()


def test_path_search_cli_dmf(tmp_path):
    """``--mep-mode dmf`` through the CLI: the output tree, and the same
    segment as the JAX package's run_path_search on the same settings."""
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    out = tmp_path / "ps"
    assert _cli(["path-search", "-i", str(a), "-i", str(b), "--mep-mode",
                 "dmf", "--max-depth", "0", "--preopt", "False",
                 "--out-dir", str(out)] + COMMON) == 0
    for f in ("mep.trj", "summary.yaml", "summary.log",
              "seg_000_mep/final_geometries.trj", "seg_000_mep/hei.xyz"):
        assert (out / f).exists(), f
    rj = j_ps.run_path_search([a, b], charge=0, calc_mode="morse",
                              freeze_atoms=[0, 2], mep_mode="dmf",
                              search_kw={"max_depth": 0, "preopt": False},
                              out_dir=tmp_path / "jax", verbose=False)
    # 300 heavy-ball steps and the flanking L-BFGS runs: the two
    # packages' roundings part by a few 1e-9 Hartree, and the summary's
    # kcal/mol values are rounded to 1e-6
    _same(yaml.safe_load((out / "summary.yaml").read_text()),
          yaml.safe_load((tmp_path / "jax" / "summary.yaml").read_text()),
          tol=1e-5)
    frames = io_xyz.read_xyz_frames(out / "seg_000_mep" /
                                    "final_geometries.trj")
    assert len(frames) == len(rj["segments"][0].images_bohr) == 12


@pytest.mark.parametrize("kw,n_img", [
    ({"mep_mode": "DMF", "n_images": 7}, 7),
    ({"mep_mode": "dmf", "n_images": 7}, 7),
    ({"beta_ev": 5.0}, 9),
    ({"mep_mode": "dmf", "dmf_kw": {"n_images": 8}}, 8),
])
def test_run_path_search_dmf_matches_jax(tmp_path, kw, n_img):
    """DMF segments and the DMF keys, flat or in ``dmf_kw`` (with GSM they
    route to DMF and go unused, as in the JAX package): the same segments
    as JAX's. The port reads ``mep_mode`` in any case; the JAX package
    runs GSM for "DMF" (its ``run_mep_between`` tests the raw string), so
    that case is held to JAX's "dmf" run."""
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    base = dict(charge=0, calc_mode="morse", freeze_atoms=[0, 2],
                search_kw={"max_depth": 0, "preopt": False},
                gs_kw={"max_nodes": 7}, verbose=False)
    kw = {**base, **kw}
    rt = run_path_search([a, b], out_dir=tmp_path / "port", device="cpu",
                         **kw)
    if kw.get("mep_mode") == "DMF":
        kw["mep_mode"] = "dmf"
    rj = j_ps.run_path_search([a, b], out_dir=tmp_path / "jax", **kw)
    sj, st = rj["segments"], rt["segments"]
    assert len(st) == len(sj) == 1 and st[0].is_reactive
    assert st[0].hei_idx == sj[0].hei_idx
    assert len(st[0].images_bohr) == len(sj[0].images_bohr) == n_img
    assert np.abs(np.subtract(st[0].energies, sj[0].energies)).max() <= 1e-9
    assert max(np.abs(x - y).max() for x, y in
               zip(st[0].images_bohr, sj[0].images_bohr)) <= 1e-7
    _same(yaml.safe_load((tmp_path / "port" / "summary.yaml").read_text()),
          yaml.safe_load((tmp_path / "jax" / "summary.yaml").read_text()))


@pytest.mark.parametrize("kw,said", [
    ({"spatial": 2}, "run unsharded"),
])
def test_run_path_search_refuses_unported(tmp_path, kw, said):
    """Atom-axis sharding of an analytic potential (the UMA factory's
    alone) is refused before anything is written."""
    a = _write(tmp_path, "A.xyz", H3A)
    b = _write(tmp_path, "B.xyz", H3B)
    with pytest.raises(ValueError, match=said):
        run_path_search([a, b], charge=0, calc_mode="morse", device="cpu",
                        out_dir=tmp_path / "ps", verbose=False, **kw)
    assert not (tmp_path / "ps").exists()


def test_path_search_needs_two_inputs_of_one_system(tmp_path):
    a = _write(tmp_path, "A.xyz", H3A)
    o = _write(tmp_path, "O.xyz", "3\nwater\nO 0 0 0\nH 0.96 0 0\n"
                                  "H -0.24 0.93 0\n")
    with pytest.raises(ValueError, match=">= 2"):
        run_path_search([a], charge=0, calc_mode="morse", device="cpu")
    with pytest.raises(ValueError, match="ordering"):
        run_path_search([a, o], charge=0, calc_mode="morse", device="cpu",
                        out_dir=tmp_path / "ps")
    assert _cli(["path-search", "-i", str(a)] + COMMON) != 0


def _pocket_pair(tmp_path):
    """R and P of ``tests/test_extract.py``'s complex (P with the ligand's
    C1-O1 bond broken) and their pockets, extracted by the port."""
    from test_extract import build_complex_pdb
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    r, p = tmp_path / "R.pdb", tmp_path / "P.pdb"
    build_complex_pdb(r)
    p.write_text(r.read_text().replace("1.200   0.000   0.000",
                                       "2.300   0.000   0.000"))
    pockets = [tmp_path / "pocket_R.pdb", tmp_path / "pocket_P.pdb"]
    extract_api([r, p], "LIG", pockets, device="cpu")
    return [r, p], pockets


def _check_merged(out, templates, pockets):
    """Every merged PDB has the full atom count, and mep_full.pdb's
    frames are JAX's merge of mep.trj's frames: the background blended
    from R to the chain-aligned P across the frames."""
    from pdb2reaction_tpu.bio.align import kabsch as j_kabsch
    from pdb2reaction_tpu.bio.merge import merge_pocket_into_full
    from pdb2reaction_tpu.core import io_pdb as j_pdb
    from pdb2reaction_tpu_torch.core import io_pdb
    full = [j_pdb.read_pdb(t) for t in templates]
    n_full = full[0].n_atoms
    pocket = j_pdb.read_pdb(pockets[0])
    assert pocket.n_atoms < n_full
    merged = sorted(out.glob("seg_*_mep/*_full.pdb")) + [out
                                                         / "mep_full.pdb"]
    assert any(m.name == "hei_full.pdb" for m in merged)
    for m in merged:
        text = m.read_text()
        n_models = text.count("MODEL ")
        assert n_models >= 1
        assert text.count("\nATOM  ") + text.count("\nHETATM") \
            == n_models * n_full, m
        assert io_pdb.read_pdb(m).n_atoms == n_full
    frames = io_xyz.read_xyz_frames(out / "mep.trj")
    R, t = j_kabsch(full[1].coords, full[0].coords)
    A, B = full[0].coords, full[1].coords @ R + t
    blocks = (out / "mep_full.pdb").read_text().split("ENDMDL")[:-1]
    assert len(blocks) == len(frames) >= 3
    M = len(frames)
    for k, (fr, block) in enumerate(zip(frames, blocks)):
        tf = k / (M - 1.0)
        want = merge_pocket_into_full(full[0], pocket, fr.coords,
                                      full_coords_ang=(1 - tf) * A
                                      + tf * B).coords
        got = np.array([[float(ln[30:38]), float(ln[38:46]),
                         float(ln[46:54])] for ln in block.splitlines()
                        if ln.startswith(("ATOM", "HETATM"))])
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-4)
    return n_full


SEARCH_SMALL = {"max_depth": 0, "preopt": False}


def test_run_path_search_full_template_merge(tmp_path):
    """``full_template``: the pocket frames merged into the full system."""
    templates, pockets = _pocket_pair(tmp_path)
    out = tmp_path / "ps"
    res = run_path_search(pockets, charge=1, calc_mode="morse",
                          device="cpu", out_dir=out, verbose=False,
                          full_template=templates,
                          search_kw=SEARCH_SMALL, gs_kw={"max_nodes": 7},
                          stopt_kw={"max_cycles": 30})
    assert _check_merged(out, templates, pockets) == 22
    assert (out / "mep_full.pdb") in res["outputs"]
    # a template of another atom count is refused before the search
    with pytest.raises(ValueError, match="1 or 2 templates"):
        run_path_search(pockets, charge=1, calc_mode="morse", device="cpu",
                        out_dir=tmp_path / "x", verbose=False,
                        full_template=templates * 2)
    assert not (tmp_path / "x").exists()


def test_path_search_cli_ref_full_pdb_merge(tmp_path):
    """``--ref-full-pdb R.pdb --ref-full-pdb P.pdb`` through the CLI."""
    templates, pockets = _pocket_pair(tmp_path)
    out = tmp_path / "ps"
    assert _cli(["path-search", "-i", str(pockets[0]), "-i",
                 str(pockets[1]), "--ref-full-pdb", str(templates[0]),
                 "--ref-full-pdb", str(templates[1]), "--max-depth", "0",
                 "--preopt", "False", "--max-nodes", "7", "--max-cycles",
                 "30", "-q", "1", "--calc-mode", "morse", "--device",
                 "cpu", "--out-dir", str(out)]) == 0
    assert _check_merged(out, templates, pockets) == 22
    # the pocket trajectories got their PDB companions too
    assert (out / "mep.pdb").exists()


def test_multi_template_merge_and_segment_summaries(tmp_path):
    """Twin of tests/test_path_search.py:109, and at max_nodes 7 the
    merged MEP byte for byte JAX's."""
    from test_path_search import _h3_pdb
    from pdb2reaction_tpu.workflows.path_search import \
        run_path_search as j_run
    a = _h3_pdb(tmp_path / "A.pdb", 0.686)
    b = _h3_pdb(tmp_path / "B.pdb", 1.714)
    ta = _h3_pdb(tmp_path / "TA.pdb", 0.686, extra_x=10.0)
    tb = _h3_pdb(tmp_path / "TB.pdb", 1.714, extra_x=13.0)
    out = tmp_path / "ps"
    run_path_search([a, b], charge=0, calc_mode="morse", device="cpu",
                    freeze_atoms=[0, 2], full_template=[ta, tb],
                    out_dir=out, verbose=False, gs_kw={"max_nodes": 6})
    assert (out / "mep_full.pdb").exists()
    xs = []
    n_atoms_per_model = set()
    cur = 0
    for line in (out / "mep_full.pdb").read_text().splitlines():
        if line.startswith("MODEL"):
            cur = 0
        elif line.startswith(("ATOM", "HETATM")):
            cur += 1
            if " GLY " in line:
                xs.append(float(line[30:38]))
        elif line.startswith("ENDMDL"):
            n_atoms_per_model.add(cur)
    assert n_atoms_per_model == {4}
    assert xs[0] == pytest.approx(10.0, abs=0.3)
    assert xs[-1] > xs[0] + 0.8
    assert all(x2 >= x1 - 0.05 for x1, x2 in zip(xs, xs[1:]))
    seg_summaries = sorted(out.glob("seg_*_mep/summary.yaml"))
    assert seg_summaries
    doc = yaml.safe_load(seg_summaries[0].read_text())
    assert doc["pair_index"] == 0
    assert doc["segments"][0]["pair_index"] == 0
    assert "weights" in doc
    with pytest.raises(ValueError, match="templates"):
        run_path_search([a, b], charge=0, calc_mode="morse", device="cpu",
                        freeze_atoms=[0, 2], full_template=[ta, tb, ta],
                        out_dir=tmp_path / "bad", verbose=False)
    # at an odd node count the merged files are JAX's byte for byte
    kw = dict(charge=0, calc_mode="morse", freeze_atoms=[0, 2],
              full_template=[ta, tb], verbose=False)
    run_path_search([a, b], device="cpu", out_dir=tmp_path / "p7",
                    gs_kw={"max_nodes": 7}, **kw)
    j_run([a, b], out_dir=tmp_path / "j7",
          gs_kw={"max_nodes": 7, "loop": "host"}, **kw)
    fulls = sorted(p.relative_to(tmp_path / "j7")
                   for p in (tmp_path / "j7").rglob("*_full.pdb"))
    assert fulls == sorted(p.relative_to(tmp_path / "p7")
                           for p in (tmp_path / "p7").rglob("*_full.pdb"))
    for f in fulls:
        assert (tmp_path / "p7" / f).read_bytes() == \
            (tmp_path / "j7" / f).read_bytes(), f
