"""Stage 4 of the port as a whole (``workflows/tsopt.py``, ``freq.py``,
``irc.py`` and their CLI subcommands) against the JAX workflows:

- ``run_tsopt`` (light and heavy), ``run_freq`` and ``run_irc`` with
  ``calc_mode="morse"`` on the H3 double well: the same output files and
  the same numbers (energies to 1e-9 Hartree, coordinates to 1e-7 Bohr,
  frequencies to 1e-8 relative, the thermochemistry to 1e-10 relative;
  ``thermoanalysis.yaml`` read by a YAML reader, the port's written as
  JSON);
- the slice at small size: an eight-atom escn-test molecule with four
  active atoms and the JAX weights carried across (``params_from_jax``),
  float64: ``run_tsopt(heavy, max_cycles=3)``, ``run_irc(max_cycles=3)``
  and ``run_freq`` against JAX's, energies to 1e-9 Hartree, coordinates
  to 1e-7 Bohr, frequencies to 1e-6 relative;
- the ``tsopt``, ``freq`` and ``irc`` subcommands with ``--calc-mode
  morse --device cpu``: exit codes and outputs, ``--coord-type dlc``
  (``tsopt`` heavy and ``opt``) against the JAX workflows, and the
  refusals of ranks asked for in one process (``--spatial`` or
  ``--workers`` above 1 outside torchrun) before any output."""

import numpy as np
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch
import yaml

from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu.workflows import common as j_common
from pdb2reaction_tpu.workflows.freq import run_freq as j_run_freq
from pdb2reaction_tpu.workflows.irc import run_irc as j_run_irc
from pdb2reaction_tpu.workflows.tsopt import run_tsopt as j_run_tsopt
from pdb2reaction_tpu_torch import cli
from pdb2reaction_tpu_torch.constants import BOHR2ANG
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
from pdb2reaction_tpu_torch.workflows import common as t_common
from pdb2reaction_tpu_torch.workflows.freq import run_freq
from pdb2reaction_tpu_torch.workflows.irc import run_irc
from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt

from test_torch_escn import jax_weights_np

L = 2.4
E_TOL, X_TOL = 1e-9, 1e-7
H3_TS = "3\nts guess\nH 0.0 0.0 0.0\nH 1.05 0.0 0.0\nH 2.4 0.0 0.0\n"
H3_MID = "3\nts\nH 0.0 0.0 0.0\nH 1.2 0.0 0.0\nH 2.4 0.0 0.0\n"
MORSE = dict(charge=0, freeze_atoms=[0, 2], calc_mode="morse",
             verbose=False)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return p


def _names(paths, root):
    return sorted(str(p.relative_to(root)) for p in map(type(root), paths))


def _same_files(tmp_path, rj, rt):
    assert _names(rt["outputs"], tmp_path / "t") == \
        _names(rj["outputs"], tmp_path / "j")
    for p in rt["outputs"]:
        assert (tmp_path / "t" / p.name).exists()


@pytest.mark.parametrize("mode", ["light", "heavy"])
def test_run_tsopt_morse_matches_jax(tmp_path, mode):
    p = _write(tmp_path, "ts.xyz", H3_TS)
    rj = j_run_tsopt(p, opt_mode=mode, out_dir=tmp_path / "j", **MORSE)
    rt = run_tsopt(p, opt_mode=mode, out_dir=tmp_path / "t", device="cpu",
                   **MORSE)
    _same_files(tmp_path, rj, rt)
    assert rt["converged"] == rj["converged"] is True
    assert rt["cycles"] == rj["cycles"]
    assert abs(rt["energy"] - rj["energy"]) <= E_TOL
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= X_TOL
    np.testing.assert_allclose(rt["freqs_cm"], rj["freqs_cm"], rtol=1e-8)
    assert rt["n_imag"] == rj["n_imag"] == 1
    if mode == "light":
        assert rt["force_calls"] == rj["force_calls"]
    else:
        # the Hessians' two, the start and one a cycle (JAX counts none of
        # its device loop's)
        assert rt["force_calls"] == rt["cycles"] + 3
    xyz = io_xyz.read_xyz(tmp_path / "t" / "final_geometry.xyz")
    assert np.abs(xyz.coords[1, 0] - L / 2) < 2e-3
    assert len(io_xyz.read_xyz_frames(tmp_path / "t" / "imag_mode.trj")) \
        == 20


def test_run_freq_morse_matches_jax(tmp_path):
    p = _write(tmp_path, "w.xyz", "3\nwater\nO 0.0 0.0 0.0\n"
                                  "H 0.96 0.02 0.0\nH -0.23 0.93 0.01\n")
    kw = dict(charge=0, calc_mode="morse", verbose=False)
    rj = j_run_freq(p, out_dir=tmp_path / "j", **kw)
    rt = run_freq(p, out_dir=tmp_path / "t", device="cpu", **kw)
    _same_files(tmp_path, rj, rt)
    np.testing.assert_allclose(rt["freqs_cm"], rj["freqs_cm"], rtol=1e-8)
    assert abs(rt["energy"] - rj["energy"]) <= E_TOL
    tj = yaml.safe_load((tmp_path / "j" / "thermoanalysis.yaml").read_text())
    tt = yaml.safe_load((tmp_path / "t" / "thermoanalysis.yaml").read_text())
    assert tt.keys() == tj.keys()
    for k in tj:
        assert tt[k] == pytest.approx(tj[k], rel=1e-10, abs=1e-300), k
    assert (tmp_path / "t" / "frequencies_cm-1.txt").read_text() == \
        (tmp_path / "j" / "frequencies_cm-1.txt").read_text()


def test_run_irc_morse_matches_jax(tmp_path):
    p = _write(tmp_path, "ts.xyz", H3_MID)
    kw = dict(MORSE, max_cycles=40, rms_grad_thresh=5e-4)
    rj = j_run_irc(p, out_dir=tmp_path / "j", **kw)
    rt = run_irc(p, out_dir=tmp_path / "t", device="cpu", **kw)
    _same_files(tmp_path, rj, rt)
    assert len(rt["frames_bohr"]) == len(rj["frames_bohr"])
    assert max(np.abs(a - b).max() for a, b in
               zip(rt["frames_bohr"], rj["frames_bohr"])) <= X_TOL
    assert np.abs(np.subtract(rt["energies"], rj["energies"])).max() \
        <= E_TOL
    assert rt["force_calls"] == rj["force_calls"]
    with np.load(tmp_path / "t" / "irc_data.npz") as zt, \
            np.load(tmp_path / "j" / "irc_data.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=1e-7)


# ---- the slice at small size: escn-test with JAX's weights -----------------

@pytest.fixture(scope="module")
def escn_slice(tmp_path_factory):
    """An eight-atom molecule, atoms 4-7 frozen, and both packages'
    calculator factories returning escn-test over the same weights."""
    p, cfg = jax_weights_np("escn-test", jnp.float64, seed=7)
    jp = j_premerge(jtu.tree_map(jnp.asarray, p), cfg)
    tp = params_from_jax(p)
    rng = np.random.default_rng(2)
    st = Structure([6, 1, 8, 1, 6, 1, 1, 8], rng.normal(scale=1.3,
                                                        size=(8, 3)))
    path = tmp_path_factory.mktemp("slice") / "in.xyz"
    io_xyz.write_xyz(path, st)

    def jmake(struct, freeze_atoms=(), **kw):
        return JCalculator(struct, ESCN_FN_FOR(cfg), params=jp,
                           freeze_atoms=list(freeze_atoms))

    def tmake(struct, freeze_atoms=(), device="cuda", **kw):
        return make_uma_calculator(struct, model="escn-test",
                                   freeze_atoms=list(freeze_atoms),
                                   device="cpu", dtype=torch.float64,
                                   params=tp, weights_source="from_jax")

    return path, jmake, tmake


def _run_slice(monkeypatch, escn_slice, tmp_path, jfn, tfn, **kw):
    path, jmake, tmake = escn_slice
    monkeypatch.setattr(j_common, "make_calculator", jmake)
    monkeypatch.setattr(t_common, "make_calculator", tmake)
    common = dict(charge=0, freeze_atoms=[4, 5, 6, 7], verbose=False)
    rj = jfn(path, out_dir=tmp_path / "j", **common, **kw)
    rt = tfn(path, out_dir=tmp_path / "t", **common, **kw)
    assert rt["calculator"].weights_source == "from_jax"
    _same_files(tmp_path, rj, rt)
    return rj, rt


def test_slice_tsopt_heavy_matches_jax(monkeypatch, escn_slice, tmp_path):
    rj, rt = _run_slice(monkeypatch, escn_slice, tmp_path, j_run_tsopt,
                        run_tsopt, opt_mode="heavy", max_cycles=3)
    assert rt["cycles"] == rj["cycles"] == 3
    assert rt["converged"] == rj["converged"]
    assert abs(rt["energy"] - rj["energy"]) <= E_TOL
    assert np.abs(rt["coords_bohr"] - rj["coords_bohr"]).max() <= X_TOL
    x0 = io_xyz.read_xyz(escn_slice[0]).coords_bohr
    np.testing.assert_array_equal(rt["coords_bohr"][4:], x0[4:])
    np.testing.assert_allclose(rt["freqs_cm"], rj["freqs_cm"], rtol=1e-6)
    assert len(rt["freqs_cm"]) == 3 * 4 - 6     # PHVA of 4 active atoms


def test_slice_irc_matches_jax(monkeypatch, escn_slice, tmp_path):
    rj, rt = _run_slice(monkeypatch, escn_slice, tmp_path, j_run_irc,
                        run_irc, max_cycles=3)
    assert len(rt["frames_bohr"]) == len(rj["frames_bohr"]) >= 3
    assert max(np.abs(a - b).max() for a, b in
               zip(rt["frames_bohr"], rj["frames_bohr"])) <= X_TOL
    assert np.abs(np.subtract(rt["energies"], rj["energies"])).max() \
        <= E_TOL
    assert rt["force_calls"] == rj["force_calls"]


def test_slice_freq_matches_jax(monkeypatch, escn_slice, tmp_path):
    rj, rt = _run_slice(monkeypatch, escn_slice, tmp_path, j_run_freq,
                        run_freq)
    assert abs(rt["energy"] - rj["energy"]) <= E_TOL
    np.testing.assert_allclose(rt["freqs_cm"], rj["freqs_cm"], rtol=1e-6)
    assert rt["thermo"].gibbs == pytest.approx(rj["thermo"].gibbs,
                                               rel=1e-9)


# ---- the CLI ---------------------------------------------------------------

COMMON = ["-q", "0", "--calc-mode", "morse", "--device", "cpu"]


def _cli(args):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    return e.value.code


def test_stage4_cli_morse(tmp_path):
    p = _write(tmp_path, "ts.xyz", H3_TS)
    frz = ["--freeze-atoms", "0,2"]
    assert _cli(["tsopt", "-i", str(p), "--opt-mode", "heavy", "--out-dir",
                 str(tmp_path / "ts")] + COMMON + frz) == 0
    assert _cli(["tsopt", "-i", str(p), "--out-dir", str(tmp_path / "tl"),
                 "--dump-restart", "2"] + COMMON + frz) == 0
    assert (tmp_path / "tl" / "restart").is_dir()
    ts = tmp_path / "ts" / "final_geometry.xyz"
    for d in ("ts", "tl"):
        assert (tmp_path / d / "imag_mode.trj").exists()
    assert _cli(["freq", "-i", str(ts), "--out-dir", str(tmp_path / "fq"),
                 "--max-write", "2", "--sort", "abs"] + COMMON) == 0
    trj = sorted(f.name for f in (tmp_path / "fq").glob("mode_*.trj"))
    assert len(trj) == 2 and (tmp_path / "fq" / "frequencies_cm-1.txt") \
        .exists()
    assert yaml.safe_load((tmp_path / "fq" / "thermoanalysis.yaml")
                          .read_text())["n_imag"] >= 1
    assert _cli(["irc", "-i", str(ts), "--out-dir", str(tmp_path / "ir"),
                 "--max-cycles", "5", "--step-size", "0.1"]
                + COMMON + frz) == 0
    for f in ("finished_irc.trj", "forward_irc.trj", "backward_irc.trj",
              "irc_data.npz"):
        assert (tmp_path / "ir" / f).exists(), f
    fin = io_xyz.read_xyz_frames(tmp_path / "ir" / "finished_irc.trj")
    assert len(fin) == 11 and fin[5].coords[1, 0] == pytest.approx(
        io_xyz.read_xyz(ts).coords[1, 0], abs=1e-9)


@pytest.mark.parametrize("cmd,flags", [
    ("tsopt", ["--opt-mode", "heavy", "--coord-type", "dlc"]),
    ("opt", ["--coord-type", "dlc"]),
])
def test_stage4_cli_dlc_matches_jax(tmp_path, cmd, flags):
    """``tsopt --opt-mode heavy --coord-type dlc`` (RS-I-RFO in
    constrained DLC) and ``opt --coord-type dlc`` (DLC L-BFGS, whatever
    the mode) on the H3 TS guess: exit 0 and JAX's final geometry."""
    from pdb2reaction_tpu.workflows.opt import run_opt as j_run_opt
    p = _write(tmp_path, "ts.xyz", H3_TS)
    out = tmp_path / "out"
    assert _cli([cmd, "-i", str(p), "--out-dir", str(out), "--freeze-atoms",
                 "0,2"] + COMMON + flags) == 0
    run = j_run_tsopt if cmd == "tsopt" else j_run_opt
    rj = run(p, coord_type="dlc", out_dir=tmp_path / "j",
             **({"opt_mode": "heavy"} if cmd == "tsopt" else {}), **MORSE)
    xt = io_xyz.read_xyz(out / "final_geometry.xyz").coords
    assert np.abs(xt - np.asarray(rj["coords_bohr"]) * BOHR2ANG).max() \
        <= 1e-6
    if cmd == "tsopt":
        assert abs(xt[1, 0] - L / 2) < 1e-3
        assert (out / "imag_mode.trj").exists()
    else:                       # the H3 TS guess falls into a well
        assert abs(xt[1, 0] - L / 2) > 0.3


@pytest.mark.parametrize("cmd,flags,said", [
    ("tsopt", ["--spatial", "2"], "torchrun --nproc-per-node 2"),
    ("freq", ["--spatial", "2"], "torchrun --nproc-per-node 2"),
    ("irc", ["--workers", "2"], "torchrun --nproc-per-node 2"),
    ("opt", ["--opt-mode", "heavy", "--spatial", "2"],
     "torchrun --nproc-per-node 2"),
])
def test_stage4_cli_refusals(tmp_path, cmd, flags, said):
    p = _write(tmp_path, "ts.xyz", H3_TS)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "-i", str(p), "--out-dir", str(out)] + COMMON
                 + flags)
    assert said in str(e.value.code)
    assert not out.exists()
