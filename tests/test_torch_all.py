"""The port's ``all`` (``workflows/allflow.py``, the ``all`` CLI and the
default subcommand) against the JAX package's:

- ``run_all`` on the R/P complex of ``tests/test_all_pipeline.py:134``
  with ``calc_mode="morse"``, ``tsopt=True``, ``do_freq=True`` through
  both packages: the same pockets byte for byte, the same segments,
  reactive flags and bond changes, HEI and TS energies within 1e-5
  Hartree, frequencies within 1e-8 relative (the Morse bar of
  ``tests/test_torch_stage4.py``; a state that misses it must have
  started from a geometry that the search's L-BFGS refinements put at
  most 1e-5 Angstrom from JAX's, and the port's stage 4 from JAX's start
  must meet it), the same set of output files. The
  search runs at ``max_depth`` 0 without preoptimization, ``max_nodes`` 7
  (odd: at an even count the string's two middle images tie and may come
  out mirrored, ``tests/test_torch_path_search.py``), JAX's GSM on its
  host loop (the port's only loop), and stage 4 capped at 10 cycles a
  run: deeper recursions run longer chains of optimizations to
  threshold, whose last-bit differences decide whether an interface gap
  passes the 0.1 Bohr bridge threshold (0.1065 against 0.1066 Bohr on this
  complex at full depth), so the segment lists part ways there;
- the default subcommand with ``--args-yaml`` through both CLIs: the same
  output tree (the checkpoint names are content hashes of float64
  endpoints, equal to 1e-9 but not bit for bit, and are left out);
- the twins of ``tests/test_all_pipeline.py:14, 41, 66, 87, 100, 134``
  and ``tests/test_cli.py:168, 228, 243, 283, 385, 400, 433``;
- stage 1b and the DFT single points: the twin of
  ``tests/test_all_pipeline.py:235`` (one PDB with ``--scan-lists`` in
  full-structure indices) through both CLIs, the scan product within
  1e-6 Bohr of JAX's; ``--dft True --dft-engine mini`` on Morse H3+
  through both, the DFT energies within 1e-8 Hartree and the same
  diagrams; the scan and DFT options parsed as JAX's, through
  ``--args-yaml`` too;
- the refusals: an .xyz without ``-q`` is refused by both CLIs with the
  same message;
- ``chip_smoke.py``'s active-site generator against
  ``scripts/tpu_all_e2e.py``'s on the same seed, text equal.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from pdb2reaction_tpu.cli import cli as jcli
from pdb2reaction_tpu.workflows.allflow import run_all as j_run_all
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.core import io_pdb, io_xyz
from pdb2reaction_tpu_torch.workflows import allflow
from pdb2reaction_tpu_torch.workflows.allflow import run_all

REPO = Path(__file__).resolve().parents[1]
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H3B = "3\nproduct\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n"
COMMON = ["-q", "0", "--calc-mode", "morse", "--freeze-atoms", "0,2",
          "--device", "cpu"]
E_TOL = 1e-5            # Hartree: HEI and TS energies
F_TOL = 1e-8            # relative: frequencies


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its host loops make
    thousands of small ops, and under the suite's parallel workers the
    idle-spinning thread pool of each op stalls on busy cores (the
    port's run_all of the fixture took 283 s beside seven busy cores,
    15 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(args):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    return e.value.code


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if "checkpoint" not in p.parts)


def _rp(tmp):
    from test_extract import build_complex_pdb
    r, p = tmp / "R.pdb", tmp / "P.pdb"
    build_complex_pdb(r)
    p.write_text(r.read_text().replace("1.200   0.000   0.000",
                                       "2.300   0.000   0.000"))
    return r, p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run_all of each package on the R/P complex (settings in the
    module docstring)."""
    d = tmp_path_factory.mktemp("all")
    r, p = _rp(d)
    kw = dict(center="LIG", ligand_charge=0, calc_mode="morse", tsopt=True,
              do_freq=True, verbose=False, preopt=False,
              search_kw={"max_depth": 0},
              tsopt_kw={"max_cycles_total": 10},
              opt_post_kw={"max_cycles": 10}, irc_kw={"max_cycles": 10})
    j_run_all([r, p], out_dir=d / "jax", gs_kw={"max_nodes": 7,
                                                "loop": "host"}, **kw)
    res = run_all([r, p], out_dir=d / "port", gs_kw={"max_nodes": 7},
                  device="cpu", **kw)
    return d, res


def test_run_all_matches_jax(runs):
    d, res = runs
    for name in ("pocket_R.pdb", "pocket_P.pdb"):
        assert (d / "port" / "stage1_extract" / name).read_bytes() == \
            (d / "jax" / "stage1_extract" / name).read_bytes()
    ps = yaml.safe_load((d / "port" / "summary.yaml").read_text())
    js = yaml.safe_load((d / "jax" / "summary.yaml").read_text())
    assert len(ps["segments"]) == len(js["segments"]) >= 3
    for a, b in zip(ps["segments"], js["segments"]):
        assert (a["kind"], a["reactive"], a["kink"], a["bond_changes"]) \
            == (b["kind"], b["reactive"], b["kink"], b["bond_changes"])
        assert abs(a["e_ts_au"] - b["e_ts_au"]) <= E_TOL
    assert ps["diagram"]["chain"] == js["diagram"]["chain"]
    assert len(ps["stage4"]) == len(js["stage4"]) >= 1
    for a, b in zip(ps["stage4"], js["stage4"]):
        assert a["segment"] == b["segment"]
        assert set(a) == set(b) == {"segment", "tsopt", "endpoints", "irc",
                                    "thermo"}
        assert (a["tsopt"]["converged"], a["tsopt"]["n_imag"]) == \
            (b["tsopt"]["converged"], b["tsopt"]["n_imag"])
        assert abs(a["tsopt"]["energy_au"] - b["tsopt"]["energy_au"]) \
            <= E_TOL
        for t in ("reactant", "product"):
            assert abs(a["endpoints"][t] - b["endpoints"][t]) <= E_TOL
        assert a["irc"]["matches_minima"] == b["irc"]["matches_minima"]
        for t in ("reactant", "ts", "product"):
            assert a["thermo"][t]["n_imag"] == b["thermo"][t]["n_imag"]
            assert abs(a["thermo"][t]["G_au"] - b["thermo"][t]["G_au"]) \
                <= E_TOL
        for t in ("reactant", "ts", "product"):
            rel = Path(f"stage4_seg_{a['segment']:03d}", "freq", t,
                       "frequencies_cm-1.txt")
            fp = np.loadtxt(d / "port" / rel)
            fj = np.loadtxt(d / "jax" / rel)
            if np.abs(fp - fj).max() <= F_TOL * np.abs(fj).max():
                continue
            _explain_start_gap(d, a["segment"], t, fj)
    # every stage is metered, the calculator shared by stages 2-4
    ph = res["force_call_phases"]
    assert {"preflight", "extract", "path_search", "merge"} <= set(ph)
    assert sum(v["calls"] for v in ph.values()) == res["force_calls"]
    assert sum(v["energy_calls"] for v in ph.values()) == \
        res["energy_calls"]


def _start(root, seg, tag):
    """The geometry a stage-4 state starts from (Angstrom): the segment's
    first or last image, or its HEI."""
    if tag == "ts":
        return io_xyz.read_xyz(root / f"stage4_seg_{seg:03d}" /
                               "hei_guess.xyz").coords
    frames = io_xyz.read_xyz_frames(
        root / "stage2_path" / f"seg_{seg:03d}_mep" / "final_geometries.trj")
    return frames[0 if tag == "reactant" else -1].coords


def _explain_start_gap(d, seg, tag, fj):
    """A state whose frequencies miss the bar started elsewhere: its start
    came out of the search's L-BFGS refinements (HEI +- 1 to "gau"), which
    the two packages agree on to 1e-6 Bohr (``tests/test_torch_opt.py``),
    not bit for bit, and stage 4 is capped at 10 unconverged cycles, which
    carry that gap on. The gap must be that small, and the port's stage 4
    from JAX's start must give JAX's frequencies within the bar."""
    from pdb2reaction_tpu_torch.engines.vib import frequencies_and_modes
    from pdb2reaction_tpu_torch.workflows import common
    from pdb2reaction_tpu_torch.workflows.opt import optimize_structure
    from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt
    xj = _start(d / "jax", seg, tag)
    gap = np.abs(_start(d / "port", seg, tag) - xj).max()
    assert 0 < gap <= 1e-5, (seg, tag, gap)
    st = common.load_structure(d / "port" / "stage1_extract" /
                               "pocket_R.pdb")
    st.freeze = common.merge_freeze(st, [], True)
    calc = common.make_calculator(st, calc_mode="morse", device="cpu",
                                  freeze_atoms=st.freeze)
    if tag == "ts":
        guess = d / f"redo_{seg}.xyz"
        io_xyz.write_xyz(guess, st.copy(coords=xj))
        x = run_tsopt(guess, calculator=calc, charge=1, opt_mode="rsirfo",
                      thresh="baker", max_cycles=10, verbose=False,
                      out_dir=d / f"redo_{seg}")["coords_bohr"]
    else:
        x = optimize_structure(st.copy(coords=xj), calc, opt_mode="rfo",
                               thresh="baker", max_cycles=10)[0]
    H = calc.get_hessian(np.asarray(x).reshape(-1))["hessian"]
    f = frequencies_and_modes(H, st.numbers, x, st.freeze).freqs_cm
    f = np.array([float(f"{v:12.4f}") for v in f])  # the file's rounding
    assert np.abs(f - fj).max() <= F_TOL * np.abs(fj).max(), (seg, tag)


def test_run_all_output_files_match_jax(runs):
    d, _ = runs
    assert _tree(d / "port") == _tree(d / "jax")


def test_all_pdb_full_output_tree(runs):
    """Twin of tests/test_all_pipeline.py:134 (on the run of the
    fixture)."""
    d, _ = runs
    out = d / "port"
    assert list((out / "stage1_extract").glob("pocket_*.pdb"))
    stage2 = out / "stage2_path"
    assert (stage2 / "mep_full.pdb").exists()
    seg_fulls = list(stage2.glob("seg_*_mep/final_geometries_full.pdb"))
    assert seg_fulls
    n_full = len(io_pdb.parse_pdb_atoms(d / "R.pdb"))
    assert io_pdb.read_pdb(seg_fulls[0]).n_atoms == n_full
    stage3 = out / "stage3_merged"
    assert (stage3 / "mep_full.pdb").exists()
    assert list(stage3.glob("seg_*_final_geometries_full.pdb"))
    seg_dirs = sorted(out.glob("stage4_seg_*"))
    assert seg_dirs
    for sd in seg_dirs:
        for f in ("ts_final.xyz", "reactant_opt.xyz", "product_opt.xyz",
                  "energy_diagram.png", "irc_plot.png", "hei_guess.xyz",
                  "irc.trj", "tsopt/final_geometry.xyz"):
            assert (sd / f).exists(), f
        for tag in ("reactant", "ts", "product"):
            assert (sd / "freq" / tag / "thermoanalysis.yaml").exists()
            assert (sd / "freq" / tag / "frequencies_cm-1.txt").exists()
    for f in ("energy_diagram_all.png", "energy_diagram_refined_all.png",
              "energy_diagram_gibbs_all.png", "irc_all.png"):
        assert (out / f).exists(), f
    summary = json.loads((out / "summary.yaml").read_text())
    assert summary["n_segments"] >= 1
    assert any(s["reactive"] for s in summary["segments"])
    s4 = summary["stage4"]
    assert s4 and {"segment", "tsopt", "endpoints", "irc",
                   "thermo"} <= set(s4[0])
    log = (out / "summary.log").read_text()
    assert "reactive" in log and "--- output tree ---" in log
    assert "TS frequencies" in log


def test_default_subcommand_tree_matches_jax(tmp_path):
    """``-i R.pdb -i P.pdb --center LIG --ligand-charge 0`` with no
    subcommand runs ``all`` in both CLIs; search depth 0 from
    ``--args-yaml`` (the ``search:`` section)."""
    r, p = _rp(tmp_path)
    y = tmp_path / "args.yaml"
    y.write_text("search:\n  max_depth: 0\n")
    flags = ["-i", str(r), "-i", str(p), "--center", "LIG",
             "--ligand-charge", "0", "--calc-mode", "morse", "--max-nodes",
             "7", "--preopt", "False", "--args-yaml", str(y)]
    res = CliRunner().invoke(jcli, flags + ["--gsm-loop", "host",
                                            "--out-dir",
                                            str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    assert _cli(flags + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "port")]) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    doc = json.loads((tmp_path / "port" / "summary.yaml").read_text())
    jdoc = yaml.safe_load((tmp_path / "jax" / "summary.yaml").read_text())
    assert doc["diagram"]["chain"] == jdoc["diagram"]["chain"]
    assert doc["stage4"] == jdoc["stage4"] == []


def test_all_pipeline_xyz(tmp_path):
    """Twin of tests/test_all_pipeline.py:14."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    out = tmp_path / "all"
    assert _cli(["all", "-i", str(a), "-i", str(b), "--max-nodes", "6",
                 "--tsopt", "True", "--thermo", "True", "--out-dir",
                 str(out)] + COMMON) == 0
    summary = yaml.safe_load((out / "summary.yaml").read_text())
    assert summary["n_segments"] >= 1
    s4 = summary["stage4"]
    assert len(s4) == 1
    assert s4[0]["tsopt"]["converged"]
    assert set(s4[0]["irc"]["matches_minima"].values()) == {
        "reactant", "product"}
    assert set(s4[0]["thermo"]) == {"reactant", "product", "ts"}
    assert (out / "energy_diagram_all.png").exists()
    assert (out / "stage4_seg_000" / "ts_final.xyz").exists()
    assert (out / "summary.log").read_text().count("reactive") >= 1


def test_all_stage4_defaults_library_cli_parity():
    """Twin of tests/test_all_pipeline.py:41."""
    sig = inspect.signature(run_all)
    lib = {name: sig.parameters[name].default
           for name in ("tsopt", "do_irc", "do_freq", "do_dft")}
    ns = cli.build_parser().parse_args(["all", "-i", "x.pdb"])
    for lib_name, dest in [("tsopt", "do_tsopt"), ("do_irc", "do_irc"),
                           ("do_freq", "do_freq"), ("do_dft", "do_dft")]:
        assert lib[lib_name] == getattr(ns, dest), lib_name
    assert lib["tsopt"] is False and lib["do_freq"] is False \
        and lib["do_dft"] is False


def test_all_default_run_skips_stage4(tmp_path):
    """Twin of tests/test_all_pipeline.py:66."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    out = tmp_path / "out"
    assert _cli(["all", "-i", str(a), "-i", str(b), "--max-nodes", "6",
                 "--out-dir", str(out)] + COMMON) == 0
    assert not list(out.glob("stage4_seg_*"))
    summary = yaml.safe_load((out / "summary.yaml").read_text())
    assert summary.get("stage4") == []
    assert (out / "summary.log").exists()


def test_all_single_input_requires_tsopt_or_scan(tmp_path):
    """Twin of tests/test_all_pipeline.py:87."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    with pytest.raises(ValueError, match="at least two structures"):
        cli.main(["all", "-i", str(a), "-q", "0", "--calc-mode", "morse",
                  "--device", "cpu", "--out-dir", str(tmp_path / "o")])


def test_all_default_subcommand_tsopt_only(tmp_path):
    """Twin of tests/test_all_pipeline.py:100."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    out = tmp_path / "out"
    assert _cli(["-i", str(a), "--tsopt", "True", "--out-dir", str(out)]
                + COMMON) == 0
    summary = yaml.safe_load((out / "summary.yaml").read_text())
    assert "tsopt" in summary
    assert (out / "tsopt" / "final_geometry.xyz").exists()


def test_cli_ref_pdb_template(tmp_path):
    """Twin of tests/test_cli.py:168."""
    from test_extract import build_complex_pdb
    pdb = tmp_path / "T.pdb"
    build_complex_pdb(pdb)
    st = io_pdb.read_pdb(pdb)
    xyz = tmp_path / "T.xyz"
    io_xyz.write_xyz(xyz, st)
    out = tmp_path / "opt"
    _cli(["opt", "-i", str(xyz), "--ref-pdb", str(pdb), "-q", "0",
          "--calc-mode", "morse", "--max-cycles", "3", "--thresh", "never",
          "--device", "cpu", "--out-dir", str(out)])
    assert (out / "final_geometry.xyz").exists()
    assert (out / "final_geometry.pdb").exists()
    bad = tmp_path / "bad.xyz"
    bad.write_text("1\n\nH 0 0 0\n")
    with pytest.raises(ValueError, match="atoms but the input"):
        cli.main(["opt", "-i", str(bad), "--ref-pdb", str(pdb), "-q", "0",
                  "--calc-mode", "morse", "--device", "cpu", "--out-dir",
                  str(tmp_path / "o2")])


def test_cli_args_yaml_engine_routing(tmp_path, capsys):
    """Twin of tests/test_cli.py:228."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    y = tmp_path / "args.yaml"
    y.write_text("opt:\n  thresh: gau_tight\nlbfgs:\n  keep_last: 9\n")
    assert _cli(["opt", "-i", str(a), "--args-yaml", str(y), "--out-dir",
                 str(tmp_path / "o")] + COMMON) == 0
    assert "thresh: gau_tight" in capsys.readouterr().out


def test_cli_all_passthrough_options(tmp_path, monkeypatch):
    """Twin of tests/test_cli.py:243."""
    captured = {}

    def fake_run_all(paths, **kw):
        captured.update(kw)
        return {"out_dir": tmp_path}

    monkeypatch.setattr(allflow, "run_all", fake_run_all)
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    assert _cli([
        "all", "-i", str(a), "-i", str(b),
        "--radius", "3.1", "--radius-het2het", "1.5",
        "--include-H2O", "False", "--exclude-backbone", "False",
        "--add-linkH", "False", "--selected_resn", "GLU12,HIS40",
        "--tsopt-out-dir", "/abs/ts", "--freq-out-dir", "fq",
        "--freq-max-write", "4", "--freq-amplitude-ang", "0.5",
        "--freq-n-frames", "8", "--freq-sort", "abs"] + COMMON) == 0
    ek = captured["extract_kw"]
    assert ek["radius"] == 3.1 and ek["radius_het2het"] == 1.5
    assert ek["include_h2o"] is False
    assert ek["exclude_backbone"] is False
    assert ek["add_link_h"] is False
    assert ek["selected_resn"] == ["GLU12", "HIS40"]
    assert str(captured["tsopt_out_dir"]) == "/abs/ts"
    assert str(captured["freq_out_dir"]) == "fq"
    fk = captured["freq_kw"]
    assert fk["max_write_modes"] == 4
    assert fk["amplitude_ang"] == 0.5
    assert fk["n_frames"] == 8 and fk["sort_modes"] == "abs"
    assert captured["device"] == "cpu" and captured["freeze_atoms"] == [0, 2]


def test_resolve_override_dir_semantics(tmp_path):
    """Twin of tests/test_cli.py:283."""
    from pdb2reaction_tpu_torch.workflows.allflow import _resolve_override_dir
    default = tmp_path / "result_all" / "freq"
    assert _resolve_override_dir(default, None) == default
    assert (_resolve_override_dir(default, "fq2")
            == tmp_path / "result_all" / "fq2")
    assert _resolve_override_dir(default, "/abs/x") == Path("/abs/x")


def test_all_defaults_match_reference():
    """Twin of tests/test_cli.py:385, against the JAX CLI's defaults."""
    ns = cli.build_parser().parse_args(["all", "-i", "x.pdb"])
    d = {p.name: p.default for p in jcli.commands["all"].params}
    assert ns.do_tsopt is False and d["do_tsopt"] == "False"
    assert ns.do_freq is False and d["do_freq"] == "False"
    assert ns.do_dft is False and d["do_dft"] == "False"
    assert ns.opt_mode_post == d["opt_mode_post"] == "heavy"
    assert ns.thresh_post == d["thresh_post"] == "baker"
    assert ns.opt_mode == d["opt_mode"] == "light"
    assert ns.max_cycles == d["max_cycles"] == 300
    assert ns.preopt is True and d["preopt"] == "True"
    for name in ("radius", "radius_het2het", "max_nodes",
                 "tsopt_max_cycles", "freq_temperature", "freq_pressure"):
        assert getattr(ns, name) == d[name], name


def test_cli_ligand_charge_derivation(tmp_path, capsys):
    """Twin of tests/test_cli.py:400."""
    from test_extract import build_complex_pdb
    pdb = tmp_path / "c.pdb"
    build_complex_pdb(pdb)
    assert _cli(["opt", "-i", str(pdb), "--calc-mode", "morse",
                 "--ligand-charge", "-1", "--device", "cpu", "--out-dir",
                 str(tmp_path / "o")]) == 0
    assert "full-complex summary from --ligand-charge" in \
        capsys.readouterr().out
    x = tmp_path / "a.xyz"
    x.write_text("1\nc\nH 0 0 0\n")
    with pytest.raises(ValueError, match="PDB inputs"):
        cli.main(["opt", "-i", str(x), "--calc-mode", "morse",
                  "--ligand-charge", "-1", "--device", "cpu",
                  "--out-dir", str(tmp_path / "o2")])
    st = io_pdb.read_pdb(pdb)
    x2 = tmp_path / "same.xyz"
    io_xyz.write_xyz(x2, st)
    with pytest.raises(ValueError, match="PDB inputs"):
        cli.main(["opt", "-i", str(x2), "--ref-pdb", str(pdb),
                  "--calc-mode", "morse", "--ligand-charge", "-1",
                  "--device", "cpu", "--out-dir", str(tmp_path / "o3")])


def test_cli_args_yaml_nested_section_routing(tmp_path, capsys):
    """Twin of tests/test_cli.py:433."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    y = tmp_path / "args.yaml"
    y.write_text("search:\n  opt_mode: rfo\n  preopt: false\n"
                 "gs:\n  max_nodes: 7\n")
    assert _cli(["path-search", "-i", str(a), "-i", str(b), "--max-nodes",
                 "6", "--args-yaml", str(y), "--out-dir",
                 str(tmp_path / "ps")] + COMMON) == 0
    out = capsys.readouterr().out
    assert "  opt_mode: rfo" in out
    assert "  preopt: false" in out
    assert "max_nodes: 7" in out


def test_all_single_pdb_scan_lists_remap(tmp_path, capsys):
    """The twin of tests/test_all_pipeline.py:235 through both CLIs: one
    PDB and --scan-lists in full-structure 1-based indices; the port
    drives JAX's pocket pair, its scan product within 1e-6 Bohr of JAX's,
    and runs the path stage between the input and the product."""
    from test_extract import build_complex_pdb
    r_pdb = tmp_path / "R.pdb"
    build_complex_pdb(r_pdb)
    flags = ["all", "-i", str(r_pdb), "--center", "LIG", "--ligand-charge",
             "0", "--scan-lists", "21,22,1.9", "--calc-mode", "morse",
             "--max-nodes", "7", "--refine-path", "False", "--tsopt",
             "False", "--irc", "False", "--freq", "False"]
    res = CliRunner().invoke(jcli, flags + ["--gsm-loop", "host",
                                            "--out-dir",
                                            str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    capsys.readouterr()
    assert _cli(flags + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    patoms = io_pdb.parse_pdb_atoms(
        tmp_path / "port" / "stage1_extract" / "pocket_R.pdb")
    li = [k for k, a in enumerate(patoms)
          if a["resname"] == "LIG" and a["name"] == "C1"][0]
    lj = [k for k, a in enumerate(patoms)
          if a["resname"] == "LIG" and a["name"] == "O1"][0]
    assert (li, lj) != (20, 21)            # the remap changed the indices
    for text in (out, res.output):
        assert f"({li}, {lj})" in text and ":1.900" in text
    prod = "stage1b_scan/scan_product.xyz"
    xt = io_xyz.read_xyz(tmp_path / "port" / prod).coords_bohr
    xj = io_xyz.read_xyz(tmp_path / "jax" / prod).coords_bohr
    assert np.abs(xt - xj).max() <= 1e-6
    assert (tmp_path / "port" / "stage2_path" / "mep.trj").exists()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_all_dft_mini_matches_jax(tmp_path):
    """``all --tsopt True --thermo True --dft True --dft-engine mini`` on
    the Morse H3 pair with -q 1 (H3+, closed shell) through both
    packages: the dft entries of stage 4 within 1e-8 Hartree, the same
    diagrams and files."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    flags = ["all", "-i", str(a), "-i", str(b), "-q", "1", "--calc-mode",
             "morse", "--freeze-atoms", "0,2", "--max-nodes", "7",
             "--tsopt", "True", "--thermo", "True", "--dft", "True",
             "--dft-engine", "mini", "--dft-func-basis", "hf/sto-3g"]
    res = CliRunner().invoke(jcli, flags + ["--gsm-loop", "host",
                                            "--out-dir",
                                            str(tmp_path / "jax")])
    assert res.exit_code == 0, res.output
    assert _cli(flags + ["--device", "cpu", "--out-dir",
                         str(tmp_path / "port")]) == 0
    ps = yaml.safe_load((tmp_path / "port" / "summary.yaml").read_text())
    js = yaml.safe_load((tmp_path / "jax" / "summary.yaml").read_text())
    assert len(ps["stage4"]) == len(js["stage4"]) >= 1
    for e, f in zip(ps["stage4"], js["stage4"]):
        assert set(e["dft"]) == set(f["dft"]) == {"reactant", "product",
                                                  "ts"}
        for t in e["dft"]:
            assert abs(e["dft"][t] - f["dft"][t]) <= 1e-8
    figs = {p.name for p in (tmp_path / "port").glob("*.png")}
    assert figs == {p.name for p in (tmp_path / "jax").glob("*.png")}
    assert {"energy_diagram_dft_all.png",
            "energy_diagram_dft_gibbs_all.png"} <= figs
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    doc = yaml.safe_load((tmp_path / "port" / "stage4_seg_000" / "dft_ts" /
                          "result.yaml").read_text())
    assert doc["energy"]["engine"] == "mini-rhf(sto-3g)"


def test_all_dft_without_pyscf_is_skipped(tmp_path):
    """The default engine needs PySCF: where it is missing the segment's
    dft entry says so and the run goes on (as JAX's)."""
    try:
        import pyscf  # noqa: F401
        pytest.skip("pyscf is installed: the ImportError path is not reached")
    except ImportError:
        pass
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    res = run_all([a, b], charge=1, calc_mode="morse", freeze_atoms=[0, 2],
                  device="cpu", tsopt=True, do_dft=True, verbose=False,
                  out_dir=tmp_path / "o", gs_kw={"max_nodes": 7})
    assert res["segments"] and all(
        "PySCF" in e["dft"]["skipped"] for e in res["segments"])


def test_all_scan_and_dft_options_parse_like_jax(tmp_path, monkeypatch):
    """The scan and DFT options of ``all``: JAX's defaults, the values
    handed to run_all, and --args-yaml's ``all:`` section over them."""
    ns = cli.build_parser().parse_args(["all", "-i", "x.pdb"])
    d = {p.name: p.default for p in jcli.commands["all"].params}
    for name in ("scan_bias_k", "scan_preopt", "scan_endopt",
                 "scan_max_step_size", "scan_relax_max_cycles",
                 "scan_one_based", "dft_func_basis", "scan_out_dir",
                 "dft_out_dir"):
        assert getattr(ns, name) is None and d[name] is None, name
    for name in ("dft_max_cycle", "dft_conv_tol", "dft_grid_level"):
        assert getattr(ns, name) == d[name], name
    assert ns.dft_engine == d["dft_engine"] == "gpu"
    assert ns.one_based is True and d["one_based"] == "True"
    assert ns.scan_lists == []

    captured = {}

    def fake_run_all(paths, **kw):
        captured.clear()
        captured.update(kw)
        return {"out_dir": tmp_path}

    monkeypatch.setattr(allflow, "run_all", fake_run_all)
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    base = ["all", "-i", str(a)] + COMMON
    assert _cli(base + [
        "--scan-lists", "1,2,1.5;2,3,2.0", "--scan-lists", "1,3,3.0",
        "--scan-one-based", "False", "--scan-bias-k", "50",
        "--scan-preopt", "False", "--scan-endopt", "False",
        "--scan-max-step-size", "0.2", "--scan-relax-max-cycles", "30",
        "--scan-out-dir", "sc", "--dft", "True", "--dft-func-basis",
        "b3lyp/def2-tzvp", "--dft-max-cycle", "50", "--dft-conv-tol",
        "1e-7", "--dft-grid-level", "4", "--dft-engine", "Mini",
        "--dft-out-dir", "/abs/d"]) == 0
    assert captured["scan_stages"] == [[(1, 2, 1.5), (2, 3, 2.0)],
                                       [(1, 3, 3.0)]]
    assert captured["scan_kw"] == {"bias_k": 50.0, "preopt": False,
                                   "endopt": False, "step_ang": 0.2,
                                   "relax_max_cycles": 30}
    assert captured["do_dft"] is True
    assert captured["dft_kw"] == {"max_cycle": 50, "conv_tol": 1e-7,
                                  "grid_level": 4, "engine": "mini",
                                  "func": "b3lyp", "basis": "def2-tzvp"}
    assert str(captured["scan_out_dir"]) == "sc"
    assert str(captured["dft_out_dir"]) == "/abs/d"
    # 1-based by default; --scan-one-based falls back to --one-based
    assert _cli(base + ["--scan-lists", "2,3,1.5"]) == 0
    assert captured["scan_stages"] == [[(1, 2, 1.5)]]
    assert captured["scan_kw"] == {} and captured["do_dft"] is False
    assert captured["mesh"] is None and captured["spatial"] == 1
    # --workers-per-node is accepted and dropped, as in the JAX CLI
    assert _cli(base + ["--scan-lists", "2,3,1.5", "--workers-per-node",
                        "4"]) == 0
    assert captured["mesh"] is None and "workers_per_node" not in captured
    assert _cli(base + ["--scan-lists", "2,3,1.5", "--one-based",
                        "False"]) == 0
    assert captured["scan_stages"] == [[(2, 3, 1.5)]]
    y = tmp_path / "args.yaml"
    y.write_text("all:\n  scan_kw:\n    bias_k: 20.0\n  dft_kw:\n"
                 "    engine: mini\n  do_dft: true\n")
    assert _cli(base + ["--scan-lists", "2,3,1.5", "--scan-preopt",
                        "False", "--args-yaml", str(y)]) == 0
    assert captured["scan_kw"] == {"preopt": False, "bias_k": 20.0}
    assert captured["dft_kw"]["engine"] == "mini"
    assert captured["do_dft"] is True


@pytest.mark.parametrize("flags,said", [
    (["--workers", "2"], "torchrun --nproc-per-node 2"),
    (["--workers-per-node", "2", "--workers", "2", "--spatial", "2"],
     "torchrun --nproc-per-node 4"),
    (["--dump", "True"], "--dump is not ported"),
])
def test_all_refuses_unported_options(tmp_path, flags, said):
    """Options the port does not serve exit naming themselves, and ranks
    asked for in one process exit naming the torchrun line, before
    anything is written; they are not parsed and dropped."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli.main(["all", "-i", str(a), "-i", str(b), "--out-dir", str(out)]
                 + COMMON + flags)
    assert said in str(e.value.code)
    assert not out.exists()


def test_xyz_without_charge_refused_like_jax(tmp_path):
    """Satellite of the charge default: an .xyz with no -q is refused by
    both CLIs with the same message (the port used to run it as
    neutral)."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    r = CliRunner().invoke(jcli, ["opt", "-i", str(a), "--calc-mode",
                                  "morse", "--out-dir", str(tmp_path / "j")])
    assert r.exit_code != 0 and isinstance(r.exception, ValueError)
    with pytest.raises(ValueError) as e:
        cli.main(["opt", "-i", str(a), "--calc-mode", "morse", "--device",
                  "cpu", "--out-dir", str(tmp_path / "p")])
    assert str(e.value) == str(r.exception)
    assert "Charge (-q/--charge) is required" in str(e.value)
    assert not (tmp_path / "p").exists()


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_active_site_matches_script(tmp_path):
    """chip_smoke.py's active site is scripts/tpu_all_e2e.py's
    build_enzyme_pdb, text equal on the same seed (R and P)."""
    load = _load
    smoke = load("chip_smoke_under_test", REPO / "chip_smoke.py")
    script = load("tpu_all_e2e_under_test",
                  REPO / "scripts" / "tpu_all_e2e.py")
    for stretch in (None, 2.40):
        a, b = tmp_path / "a.pdb", tmp_path / "b.pdb"
        na = smoke.build_enzyme_pdb(a, n_res=48, stretch=stretch, seed=0)
        nb = script.build_enzyme_pdb(b, n_res=48, stretch=stretch, seed=0)
        assert na == nb and a.read_text() == b.read_text()


def test_chip_smoke_pair_pocket_matches_jax(tmp_path):
    """Phase 16's whole R/P pair (active site and outer body): the JAX
    extract_api and the port's on the CPU give the same pockets, of
    chip_smoke.ALL_POCKET_ATOMS atoms, which the card's extraction is
    held to."""
    from pdb2reaction_tpu.bio.extract import extract_api as j_extract
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    smoke = _load("chip_smoke_under_test", REPO / "chip_smoke.py")
    r, p, n_site, n_body, d_lig = smoke.all_pair(str(tmp_path))
    assert n_site == 322 and n_body > 3000 and d_lig > 2.6
    outs = [tmp_path / f"t_{k}.pdb" for k in "RP"]
    jouts = [tmp_path / f"j_{k}.pdb" for k in "RP"]
    res = extract_api([r, p], "LIG", outs, ligand_charge=0, verbose=False,
                      device="cpu")
    jres = j_extract([r, p], "LIG", jouts, ligand_charge=0, verbose=False)
    assert res["charge_summary"] == jres["charge_summary"]
    for o, jo in zip(outs, jouts):
        assert o.read_bytes() == jo.read_bytes()
        assert io_pdb.read_pdb(o).n_atoms == smoke.ALL_POCKET_ATOMS


def test_profile_trace_and_force_call_meter(tmp_path):
    """``--profile DIR`` writes a torch.profiler Chrome trace; the
    ForceCallMeter counts force and energy calls per phase, the
    calculator attached while a phase runs, as the JAX meter counts force
    calls."""
    from pdb2reaction_tpu.runtime.profiling import ForceCallMeter as JMeter
    from pdb2reaction_tpu_torch.runtime.profiling import ForceCallMeter
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    assert _cli(["opt", "-i", str(a), "--profile", str(tmp_path / "prof"),
                 "--out-dir", str(tmp_path / "o")] + COMMON) == 0
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]

    class Counter:
        force_calls = 0
        energy_calls = 0

    m, jm, c = ForceCallMeter(), JMeter(Counter()), Counter()
    with m.phase("before"):
        m.calc = c
        c.force_calls += 3
    jm.calc = c
    with m.phase("a"), jm.phase("a"):
        c.force_calls += 5
        c.energy_calls += 2
    assert m.phases["before"]["calls"] == 3
    assert m.phases["a"]["calls"] == jm.phases["a"]["calls"] == 5
    assert m.phases["a"]["energy_calls"] == 2
    rep = m.report().splitlines()
    assert rep[0].split()[:4] == ["phase", "force", "calls", "energy"]
    assert rep[-1].split()[:3] == ["TOTAL", "8", "2"]


def test_cli_help_lists_commands(capsys):
    """Twin of tests/test_cli.py:131: every subcommand of the JAX CLI is
    served and listed; none names the scans' or DFT's old items."""
    assert _cli(["-h"]) == 0
    out = capsys.readouterr().out
    assert set(jcli.commands) == cli.build_parser().commands
    assert len(jcli.commands) == 15
    for cmd in jcli.commands:
        assert cmd in out, cmd
    assert "item 7" not in out and "item 12" not in out


def test_trj2fig_cli_matches_jax(tmp_path):
    """trj2fig through the CLI with -o .svg/.html/.csv, --reverse-x and
    --recompute (the Morse energies recomputed on the CPU), against the
    JAX package's run_trj2fig on the same trajectory."""
    from pdb2reaction_tpu.workflows.trj2fig import run_trj2fig as j_trj2fig
    from pdb2reaction_tpu_torch.core.structure import Structure
    st = Structure.from_symbols(["H"] * 3, [[0, 0, 0], [0.686, 0, 0],
                                            [2.4, 0, 0]])
    frames = [st.copy(coords=st.coords + [[0, 0, 0], [0.2 * k, 0, 0],
                                          [0, 0, 0]]) for k in range(6)]
    trj = tmp_path / "p.trj"
    io_xyz.write_trj(trj, frames)              # no energies: recomputed
    outs = [tmp_path / f"prof.{s}" for s in ("svg", "html", "csv")]
    flags = sum((["-o", str(o)] for o in outs), [])
    assert _cli(["trj2fig", "-i", str(trj), "--reverse-x", "True",
                 "--recompute", "True", "-q", "0", "--calc-mode", "morse",
                 "--device", "cpu"] + flags) == 0
    assert all(o.exists() for o in outs)
    assert outs[1].stat().st_size > 100
    jcsv = tmp_path / "j.csv"
    j_trj2fig(trj, out_path=tmp_path / "j.svg", extra_outputs=[jcsv],
              recompute=True, charge=0, calc_mode="morse", reverse_x=True)
    np.testing.assert_allclose(
        np.loadtxt(outs[2], delimiter=",", skiprows=1),
        np.loadtxt(jcsv, delimiter=",", skiprows=1), rtol=0, atol=1e-10)
    assert outs[2].read_text().splitlines()[0] == "image,energy_au"
