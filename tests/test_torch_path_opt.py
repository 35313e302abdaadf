"""Port ``path-opt`` workflow (``workflows/path_opt.py``) and
``bio/align.py`` against the JAX package:

- ``align_sequence_inplace`` (and ``kabsch`` / ``align_coords`` under it)
  on seeded structures with 0, 1, 2 and 4 anchors, to 1e-12 Angstrom;
- ``run_path_opt`` on Morse H3 ``.xyz`` endpoints with alignment and no
  preoptimization: the same HEI, convergence and force calls, energies
  to 1e-9 Hartree, and the calculator's count equal to the string's (the
  port's batched closure counts the images; the workflow adds nothing);
- DMF (``mep_mode="dmf"``) through ``run_mep_between`` and
  ``run_path_opt`` against JAX's: images to 1e-8 Bohr, energies to 1e-10
  Hartree, the same HEI; the calculator counting every image evaluated;
- the refusal of ``spatial > 1`` and the ``path-opt`` CLI on the CPU with
  ``--calc-mode morse``, GSM and DMF (``--args-yaml``'s ``dmf:``
  section), writing ``final_geometries.trj`` and ``hei.xyz``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pdb2reaction_tpu.bio import align as j_align
from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.workflows.path_opt import run_path_opt as j_run
from pdb2reaction_tpu_torch.bio import align
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.workflows import common
from pdb2reaction_tpu_torch.workflows.path_opt import (run_mep_between,
                                                       run_path_opt)

REPO = Path(__file__).resolve().parents[1]
L = 2.4


def _rotated(xyz, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return xyz @ q + rng.normal(size=3) + 0.05 * rng.normal(size=xyz.shape)


@pytest.mark.parametrize("freeze", [[], [3], [1, 5], [0, 2, 4, 6]])
def test_align_sequence_matches_jax(freeze):
    rng = np.random.default_rng(len(freeze))
    zs = rng.choice([1, 6, 8], size=8).astype(np.int32)
    xyz = rng.normal(scale=1.5, size=(8, 3))
    frames = [xyz] + [_rotated(xyz, s) for s in (1, 2)]
    ts = [Structure(zs, f, freeze=list(freeze)) for f in frames]
    js = [JStructure(zs, f, freeze=list(freeze)) for f in frames]
    align.align_sequence_inplace(ts)
    j_align.align_sequence_inplace(js)
    for t, j in zip(ts, js):
        assert np.abs(t.coords - j.coords).max() <= 1e-12
    if len(freeze) >= 1:
        for t in ts[1:]:                 # anchors coincide exactly
            np.testing.assert_array_equal(t.coords[freeze],
                                          ts[0].coords[freeze])
    R, t = align.kabsch(frames[1], frames[0])
    Rj, tj = j_align.kabsch(frames[1], frames[0])
    assert np.abs(R - Rj).max() <= 1e-12 and np.abs(t - tj).max() <= 1e-12
    assert align.rmsd(frames[0], frames[0]) == 0.0


def _h3_endpoints(tmp_path):
    """Two H3 .xyz endpoints, the second rotated and shifted so that the
    alignment has work to do."""
    a = np.array([[0, 0, 0], [0.686, 0, 0], [L, 0, 0]], float)
    b = np.array([[0, 0, 0], [L - 0.686, 0, 0], [L, 0, 0]], float)
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    b = b @ q + np.array([0.3, -0.2, 0.5])
    paths = []
    for name, x in (("A", a), ("B", b)):
        p = tmp_path / f"{name}.xyz"
        io_xyz.write_xyz(p, Structure.from_symbols(["H"] * 3, x))
        paths.append(p)
    return paths


def test_run_path_opt_matches_jax(tmp_path):
    paths = _h3_endpoints(tmp_path)
    kw = dict(charge=0, spin=1, freeze_atoms=[0, 2], preopt=False,
              align=True, calc_mode="morse",
              gs_kw={"max_nodes": 9}, stopt_kw={"max_cycles": 200},
              verbose=False)
    rj = j_run(paths, out_dir=tmp_path / "j", **kw)
    rt = run_path_opt(paths, out_dir=tmp_path / "t", device="cpu", **kw)
    assert rt["hei_idx"] == rj["hei_idx"]
    assert rt["converged"] == rj["converged"] is True
    assert np.abs(rt["energies"] - rj["energies"]).max() <= 1e-9
    calc = rt["calculator"]
    assert calc.force_calls == rt["force_calls"] == rt["mep_force_calls"] \
        == (rt["cycles"] + 1) * 11
    assert rt["force_calls"] == rj["force_calls"]
    trj = io_xyz.read_xyz_frames(tmp_path / "t" / "final_geometries.trj")
    assert len(trj) == 11
    E = [io_xyz.parse_energy_comment(f.comment) for f in trj]
    np.testing.assert_allclose(E, rt["energies"], rtol=0, atol=1e-11)
    hei = io_xyz.read_xyz(tmp_path / "t" / "hei.xyz")
    np.testing.assert_allclose(hei.coords, trj[rt["hei_idx"]].coords,
                               atol=1e-14)
    # the aligned endpoints are JAX's
    for s_t, s_j in zip(rt["structures"], rj["structures"]):
        assert np.abs(s_t.coords - s_j.coords).max() <= 1e-12


def test_run_mep_between_counts_once_and_refusals(tmp_path):
    paths = _h3_endpoints(tmp_path)
    A, B = (common.load_structure(p) for p in paths)
    for st in (A, B):
        st.freeze = [0, 2]
    align.align_sequence_inplace([A, B])
    calc = common.make_calculator(A, calc_mode="morse", freeze_atoms=[0, 2],
                                  device="cpu")
    res = run_mep_between(A, B, calc, gs_kw={"max_nodes": 4, "climb": False},
                          stopt_kw={"max_cycles": 20}, verbose=False)
    assert calc.force_calls == res.force_calls == (res.cycles + 1) * 6
    # DMF: one batch of the 7 images a step and the final energies
    from pdb2reaction_tpu.workflows.path_opt import \
        run_mep_between as j_mep
    from pdb2reaction_tpu.workflows import common as j_common
    jA, jB = (j_common.load_structure(p) for p in paths)
    for st in (jA, jB):
        st.freeze = [0, 2]
    j_align.align_sequence_inplace([jA, jB])
    jcalc = j_common.make_calculator(jA, calc_mode="morse",
                                     freeze_atoms=[0, 2])
    dkw = {"n_images": 7, "max_cycles": 30}
    n0 = calc.force_calls
    rd = run_mep_between(A, B, calc, mep_mode="dmf", dmf_kw=dkw,
                         verbose=False)
    rj = j_mep(jA, jB, jcalc, mep_mode="dmf", dmf_kw=dkw)
    assert calc.force_calls - n0 == rd.force_calls == 31 * 7
    assert rd.hei_idx == rj.hei_idx and rd.cycles == rj.cycles == 30
    assert np.abs(rd.images - np.asarray(rj.images)).max() <= 1e-8
    assert np.abs(rd.energies - rj.energies).max() <= 1e-10
    kw = dict(charge=0, mep_mode="dmf", calc_mode="morse",
              freeze_atoms=[0, 2], preopt=False, n_images=7, verbose=False)
    rt = run_path_opt(paths, device="cpu", out_dir=tmp_path / "t", **kw)
    rj = j_run(paths, out_dir=tmp_path / "j", **kw)
    assert rt["hei_idx"] == rj["hei_idx"]
    assert len(rt["images_bohr"]) == len(rj["images_bohr"]) == 7
    assert np.abs(rt["energies"] - rj["energies"]).max() <= 1e-10
    assert max(np.abs(a - b).max() for a, b in zip(
        rt["images_bohr"], rj["images_bohr"])) <= 1e-8
    assert rt["force_calls"] == rt["mep_force_calls"] == 301 * 7
    for f in ("final_geometries.trj", "hei.xyz"):
        assert (tmp_path / "t" / f).exists() and (tmp_path / "j" / f).exists()
    # atom-axis sharding needs its ranks, and the analytic potentials
    # run unsharded: both refuse before anything is written
    for mode, err, said in (("morse", ValueError, "unsharded"),
                            ("uma", RuntimeError, "torchrun")):
        with pytest.raises(err, match=said):
            run_path_opt(paths, charge=0, calc_mode=mode, device="cpu",
                         spatial=2, out_dir=tmp_path / "never")
    assert not (tmp_path / "never").exists()


def test_run_path_opt_preopt_lowers_endpoints(tmp_path):
    """L-BFGS endpoint preoptimization (gau_loose) on displaced endpoints:
    each endpoint's energy drops, and the string runs between them."""
    a = np.array([[0, 0, 0], [0.9, 0.1, 0], [L, 0, 0]], float)
    b = np.array([[0, 0, 0], [L - 0.9, -0.1, 0], [L, 0, 0]], float)
    paths = []
    for name, x in (("A", a), ("B", b)):
        p = tmp_path / f"{name}.xyz"
        io_xyz.write_xyz(p, Structure.from_symbols(["H"] * 3, x))
        paths.append(p)
    calc = common.make_calculator(Structure.from_symbols(["H"] * 3, a),
                                  calc_mode="morse", device="cpu",
                                  freeze_atoms=[0, 2])
    e0 = [calc.get_energy(Structure.from_symbols(["H"] * 3, x)
                          .coords_bohr)["energy"] for x in (a, b)]
    rt = run_path_opt(paths, charge=0, freeze_atoms=[0, 2], preopt=True,
                      calc_mode="morse", device="cpu",
                      gs_kw={"max_nodes": 5}, stopt_kw={"max_cycles": 30},
                      out_dir=tmp_path / "out", verbose=False)
    assert rt["energies"][0] < e0[0] and rt["energies"][-1] < e0[1]
    assert rt["calculator"].force_calls > rt["mep_force_calls"]


def test_path_opt_cli_writes_outputs(tmp_path):
    paths = _h3_endpoints(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-opt",
         "-i", str(paths[0]), "-i", str(paths[1]), "--calc-mode", "morse",
         "--device", "cpu", "-q", "0", "--freeze-atoms", "0,2",
         "--max-nodes", "6", "--max-cycles", "60"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode in (0, 3), r.stderr
    out = tmp_path / "result_path_opt"
    assert len(io_xyz.read_xyz_frames(out / "final_geometries.trj")) == 8
    assert (out / "hei.xyz").exists()
    assert "[path-opt] HEI" in r.stdout
    # DMF, its keys from the dmf: section of --args-yaml (max_cycles is
    # then DMF's), against the JAX library on the same settings
    y = tmp_path / "dmf.yaml"
    y.write_text("dmf:\n  n_images: 8\n  max_cycles: 12\n")
    dmf = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-opt",
         "-i", str(paths[0]), "-i", str(paths[1]), "--mep-mode", "dmf",
         "--calc-mode", "morse", "--device", "cpu", "-q", "0",
         "--freeze-atoms", "0,2", "--args-yaml", str(y), "--out-dir",
         "dmf"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert dmf.returncode in (0, 3), dmf.stderr
    assert "12 cycles, 104 DMF force calls" in dmf.stdout
    trj = io_xyz.read_xyz_frames(tmp_path / "dmf" / "final_geometries.trj")
    assert len(trj) == 8 and (tmp_path / "dmf" / "hei.xyz").exists()
    rj = j_run(paths, charge=0, mep_mode="dmf", calc_mode="morse",
               freeze_atoms=[0, 2], preopt=False, verbose=False,
               dmf_kw={"n_images": 8, "max_cycles": 12},
               out_dir=tmp_path / "j")
    E = [io_xyz.parse_energy_comment(f.comment) for f in trj]
    np.testing.assert_allclose(E, rj["energies"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("flags,said", [
    (["--spatial", "2"], "torchrun --nproc-per-node 2"),
])
def test_path_opt_cli_refuses_unported(tmp_path, flags, said):
    """``--spatial`` above 1 in one process (the ranks are torchrun's) is
    refused up front, with no process group and no output."""
    paths = _h3_endpoints(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "path-opt",
         "-i", str(paths[0]), "-i", str(paths[1]), "--calc-mode", "morse",
         "--device", "cpu", "-q", "0", *flags], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and said in r.stderr, r.stderr
    assert not (tmp_path / "result_path_opt").exists()
