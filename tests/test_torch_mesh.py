"""The data axis of the port (parallel/mesh.py, ``Calculator(mesh=...)``,
``--workers``) in gloo CPU processes, against the JAX package's
``make_mesh(data=8)`` calculator on the 8-device CPU mesh and against the
port's own single-process runs.

Four ranks (``test_torch_mesh_worker.py``, suite "mesh") are spawned
once for the module, and two more processes joined through the
``PDB2R_TPU_*`` variables (suite "dist"); the CLI runs under
``python -m torch.distributed.run``. Tolerances:
- Morse batches (twin of tests/test_calculator.py:88): JAX's mesh batch
  at rel 1e-12, the port's single-process batch bit for bit, every
  rank's arrays equal, ``force_calls == B + 1`` on every rank;
- the water Hessians (twin of tests/test_calculator.py:135): JAX's mesh
  Hessian at rtol 1e-10 atol 1e-12, analytic and FD;
- batched forces through a sharded calculator (twin of
  tests/test_spatial.py:116): energies rtol 1e-6 atol 1e-7, forces rtol
  1e-5 atol 1e-7 against the unsharded factory;
- two processes through ``PDB2R_TPU_COORDINATOR`` (twin of
  tests/test_distributed.py:62): the meshless batch within 1e-9;
- a path search resumed on four ranks from the memo of a single-process
  run: the same segments on every rank with no force call of a MEP;
- tsopt, freq and irc of escn-test in f64 under spatial=2 on a 2 x 2
  mesh: energies and frequencies rtol 1e-8 against one process;
- ``path-opt --workers 2`` under torch.distributed.run:
  ``final_geometries.trj`` byte for byte the single-process run's, one
  output tree, no scratch directory left; ``all --workers 2`` with an
  absolute ``--tsopt-out-dir``: summary.yaml equal to one process's,
  the override written once."""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.parallel.mesh import make_mesh as j_make_mesh
from pdb2reaction_tpu_torch.core import io_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
from pdb2reaction_tpu_torch.parallel import (Mesh, SpatialGroup,
                                             shard_params_model)
from pdb2reaction_tpu_torch.workflows.freq import run_freq
from pdb2reaction_tpu_torch.workflows.irc import run_irc
from pdb2reaction_tpu_torch.workflows.path_search import run_path_search
from pdb2reaction_tpu_torch.workflows.tsopt import run_tsopt

from test_torch_escn import jax_weights_np

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
H3A = "3\nreactant\nH 0.0 0.0 0.0\nH 0.686 0.0 0.0\nH 2.4 0.0 0.0\n"
H3B = "3\nproduct\nH 0.0 0.0 0.0\nH 1.714 0.0 0.0\nH 2.4 0.0 0.0\n"
WATER = (["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(suite, world, d, timeout=300):
    """``world`` ranks of ``test_torch_mesh_worker.main`` on suite
    ``suite`` over ``d/in.pkl``; their result dicts in rank order."""
    import torch.multiprocessing as mp
    import test_torch_mesh_worker
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=test_torch_mesh_worker.main,
                         args=(r, world, port, str(d), suite))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errs = [(d / f"rank{r}.err").read_text() for r in range(world)
            if (d / f"rank{r}.err").exists()]
    assert not alive and not errs, (len(alive), errs)
    assert all(p.exitcode == 0 for p in procs)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _h2():
    return [[0, 0, 0], [0.9, 0, 0]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX side and the port's single-process runs here, then the
    four ranks once."""
    d = tmp_path_factory.mktemp("mesh")
    h3 = [d / "A.xyz", d / "B.xyz"]
    h3[0].write_text(H3A)
    h3[1].write_text(H3B)
    ref = {}
    # the single-process path search whose memo the ranks resume from
    ps_kw = dict(charge=0, calc_mode="morse", device="cpu",
                 freeze_atoms=[0, 2], verbose=False, gs_kw={"max_nodes": 7},
                 out_dir=d / "ps")
    first = run_path_search(h3, **ps_kw)["calculator"].force_calls
    rp = run_path_search(h3, **ps_kw)          # resumed: the memo's calls
    ref["ps"] = [(s.kind, s.hei_idx, np.asarray(s.energies),
                  np.stack(s.images_bohr)) for s in rp["segments"]]
    ref["ps_calls"] = (first, rp["calculator"].force_calls)
    ref["ps_files"] = sorted(str(p.relative_to(d / "ps"))
                             for p in (d / "ps").rglob("*"))
    # the escn-test slice of tests/test_torch_stage4.py, single process
    p, _ = jax_weights_np("escn-test", jnp.float64, seed=7)
    rng = np.random.default_rng(2)
    sl = Structure([6, 1, 8, 1, 6, 1, 1, 8],
                   rng.normal(scale=1.3, size=(8, 3)))
    slice_path = d / "slice.xyz"
    io_xyz.write_xyz(slice_path, sl)
    tp = params_from_jax(p)

    def calc1():
        return make_uma_calculator(
            io_xyz.read_xyz(slice_path), model="escn-test", device="cpu",
            dtype=torch.float64, params=tp, freeze_atoms=[4, 5, 6, 7])

    kw = dict(charge=0, verbose=False)
    rt = run_tsopt(slice_path, opt_mode="heavy", max_cycles=3,
                   calculator=calc1(), out_dir=d / "ts1", **kw)
    rf = run_freq(slice_path, calculator=calc1(), out_dir=d / "freq1", **kw)
    ri = run_irc(slice_path, max_cycles=3, calculator=calc1(),
                 out_dir=d / "irc1", **kw)
    ref["stage4"] = ((rt["energy"], rt["coords_bohr"], rt["freqs_cm"]),
                     (rf["energy"], rf["freqs_cm"]),
                     (np.asarray(ri["energies"]), ri["force_calls"]))
    rng = np.random.default_rng(13)
    zs = rng.choice([1, 6, 7, 8], size=16).astype(np.int32)
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3), -1).reshape(-1, 3)
    painn = (zs, grid[:16] * 1.5 + rng.normal(scale=0.1, size=(16, 3)))
    rsl = io_xyz.read_xyz(slice_path)
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"h3": [str(x) for x in h3], "ps_dir": str(d / "ps"),
                     "escn_weights": p, "slice_path": str(slice_path),
                     "slice": (rsl.numbers, rsl.coords),
                     "painn_system": painn}, fh)
    ranks = spawn_ranks("mesh", RANKS, d)
    return ranks, ref, d


def test_mesh_layout(run):
    ranks, _, _ = run
    assert [r["mesh"] for r in ranks] == [
        ({"data": 4, "model": 1}, k, 0) for k in range(RANKS)]
    assert [r["mesh22"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # ranks above 0 wrote their trees into scratch directories that were
    # removed when they exited; rank 0 wrote the user's
    assert ranks[0]["scratch"] is None
    assert all(r["scratch"] is not None and not os.path.exists(r["scratch"])
               for r in ranks[1:])


def test_stage_overrides_follow_the_rank_rule(run):
    """``all``'s per-stage output overrides: rank 0 writes the user's
    absolute path, every other rank the same path in its own scratch
    tree, so no rank reads a hand-off that another rank writes."""
    ranks, _, d = run
    ab = str(d / "abs_ts")
    assert ranks[0]["override"] == [ab, str(d / "result_all" / "fq")]
    for r in ranks[1:]:
        sc = r["scratch"]
        assert r["override"] == [sc + str(d.resolve() / "abs_ts"),
                                 sc + str(d.resolve() / "result_all" / "fq")]


@pytest.mark.parametrize("B", [16, 5])
def test_batched_forces_over_data_ranks(run, B):
    """Twin of tests/test_calculator.py:88 over four data ranks (B = 5
    padded to 8): JAX's mesh batch, the single-process batch bit for
    bit, the same bits on every rank, the count JAX keeps."""
    ranks, _, _ = run
    st = JStructure.from_symbols(["H", "H"], _h2())
    base = st.coords_bohr.reshape(-1)
    batch = np.stack([base + 0.01 * k for k in range(B)])
    jr = JCalculator(st, jpot.make_morse(),
                     mesh=j_make_mesh(data=8)).get_forces_batch(batch)
    one = Calculator(Structure.from_symbols(["H", "H"], _h2()),
                     potentials.make_morse(),
                     device="cpu").get_forces_batch(batch)
    e0, f0, _, _ = ranks[0][f"batch{B}"]
    for res in ranks:
        e, f, single, calls = res[f"batch{B}"]
        assert e.shape == (B,) and f.shape == (B, 6)
        np.testing.assert_allclose(e, jr["energy"], rtol=1e-12)
        np.testing.assert_allclose(f, jr["forces"], rtol=1e-12,
                                   atol=1e-14)
        assert np.array_equal(e, one["energy"])
        assert np.array_equal(f, one["forces"])
        assert np.array_equal(e, e0) and np.array_equal(f, f0)
        assert e[3] == pytest.approx(single["energy"], rel=1e-12)
        assert calls == B + 1


@pytest.mark.parametrize("mode", ["Analytical", "FiniteDifference"])
def test_hessian_tangents_over_data_ranks(run, mode):
    """Twin of tests/test_calculator.py:135: the water Morse Hessian with
    its tangents (or displacements) over four data ranks, against JAX's
    mesh Hessian and the single-process one."""
    ranks, _, _ = run
    jst = JStructure.from_symbols(*WATER)
    x0 = jst.coords_bohr.reshape(-1)
    Hj = JCalculator(jst, jpot.make_morse(), mesh=j_make_mesh(data=8),
                     hessian_calc_mode=mode).get_hessian(x0)["hessian"]
    one = Calculator(Structure.from_symbols(*WATER), potentials.make_morse(),
                     device="cpu", hessian_calc_mode=mode)
    H1 = one.get_hessian(x0)["hessian"]
    for res in ranks:
        H, calls = res[f"hess/{mode}"]
        np.testing.assert_allclose(H, Hj, rtol=1e-10, atol=1e-12)
        assert np.array_equal(H, H1)
        assert np.array_equal(H, ranks[0][f"hess/{mode}"][0])
        assert calls == one.force_calls


def test_chunks_over_data_ranks(run):
    """escn-test in f64 over four data ranks with chunks of 8 (a rank's
    share 2): the analytic and FD Hessians and a batch of 5 images
    stacked 2 a pass, against one process one item at a time, at 1e-12
    of max|H| and of max|F|, the same bits on every rank, and the force
    calls counted as one process counts them."""
    ranks, _, d = run
    st8 = io_xyz.read_xyz(d / "slice.xyz")
    cb8 = st8.coords_bohr.reshape(-1)
    with open(d / "in.pkl", "rb") as fh:
        tp = params_from_jax(pickle.load(fh)["escn_weights"])
    images = np.stack([cb8 + 0.02 * k for k in range(5)])
    ref = {}
    for mode in ("Analytical", "FiniteDifference"):
        calc = make_uma_calculator(
            st8, model="escn-test", device="cpu", dtype=torch.float64,
            params=tp, batch_chunk=1, hessian_calc_mode=mode,
            freeze_atoms=[4, 5, 6, 7])
        os.environ.update(PDB2R_TPU_HVP_CHUNK="1", PDB2R_TPU_FD_CHUNK="1")
        try:
            ref[mode] = calc.get_hessian(cb8)["hessian"]
        finally:
            del os.environ["PDB2R_TPU_HVP_CHUNK"]
            del os.environ["PDB2R_TPU_FD_CHUNK"]
    rb = calc.get_forces_batch(images)
    for res in ranks:
        got = res["chunked"]
        for mode in ("Analytical", "FiniteDifference"):
            H = got[mode]
            assert np.abs(H - ref[mode]).max() \
                <= 1e-12 * np.abs(ref[mode]).max()
            assert np.array_equal(H, ranks[0]["chunked"][mode])
        r, calls = got["batch"]
        assert calls == calc.force_calls
        np.testing.assert_allclose(r["energy"], rb["energy"], rtol=1e-12)
        assert np.abs(r["forces"] - rb["forces"]).max() \
            <= 1e-12 * np.abs(rb["forces"]).max()
        assert np.array_equal(r["forces"], ranks[0]["chunked"]["batch"][0][
            "forces"])


def test_sharded_calculator_batches(run):
    """Twin of tests/test_spatial.py:116: get_forces_batch through a
    calculator sharded over four model ranks, image by image."""
    ranks, _, _ = run
    for res in ranks:
        r0, r1, calls = res["spatial_batch"]
        np.testing.assert_allclose(r1["energy"], r0["energy"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r1["forces"], r0["forces"], rtol=1e-5,
                                   atol=1e-7)
        assert calls == 3
        assert np.array_equal(r1["forces"],
                              ranks[0]["spatial_batch"][1]["forces"])


def test_path_search_resumes_alike_on_every_rank(run):
    """A search rerun on four data ranks in the out_dir of a
    single-process run: rank 0 reads the memo and every rank restores
    the same segments with the force calls of a single-process rerun
    (the preoptimizations, no MEP); only rank 0 writes out_dir."""
    ranks, ref, d = run
    for r, res in enumerate(ranks):
        segs, calls, own_dir = res["ps"]
        assert len(segs) == len(ref["ps"])
        for (k, h, e, x), (k1, h1, e1, x1) in zip(segs, ref["ps"]):
            assert (k, h) == (k1, h1)
            assert np.array_equal(e, e1) and np.array_equal(x, x1)
        assert calls == ref["ps_calls"][1] < ref["ps_calls"][0]
        assert (own_dir == str(d / "ps")) == (r == 0)
    files = sorted(str(p.relative_to(d / "ps"))
                   for p in (d / "ps").rglob("*"))
    assert files == ref["ps_files"]


def test_stage4_under_spatial2_matches_one_process(run):
    """tsopt (heavy, 3 cycles), freq and irc (3 cycles) of the escn-test
    slice with the Hessians through the sharded plain closure on a 2 x 2
    mesh, against the single-process runs."""
    ranks, ref, _ = run
    (te, tx, tf), (fe, ff), (ie, icalls) = ref["stage4"]
    for res in ranks:
        (te1, tx1, tf1), (fe1, ff1), (ie1, icalls1) = res["stage4"]
        assert te1 == pytest.approx(te, rel=1e-8)
        np.testing.assert_allclose(tx1, tx, rtol=0, atol=1e-7)
        np.testing.assert_allclose(tf1, tf, rtol=1e-8)
        assert fe1 == pytest.approx(fe, rel=1e-8)
        np.testing.assert_allclose(ff1, ff, rtol=1e-8)
        np.testing.assert_allclose(ie1, ie, rtol=1e-8)
        assert icalls1 == icalls
        assert np.array_equal(ff1, ranks[0]["stage4"][1][1])


def test_two_processes_through_the_pdb2r_variables(tmp_path):
    """Twin of tests/test_distributed.py:62: two processes joined through
    PDB2R_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID (the CLI's
    make_mesh_or_none), a data axis of two, eight images against the
    meshless calculator; ``gather_global`` across the two."""
    with open(tmp_path / "in.pkl", "wb") as fh:
        pickle.dump({}, fh)
    ranks = spawn_ranks("dist", 2, tmp_path)
    st = Structure.from_symbols(*WATER)
    ref = Calculator(st, potentials.make_morse(), device="cpu")
    base = st.coords_bohr.reshape(-1)
    e_ref = np.array([ref.get_forces(base + 0.01 * k)["energy"]
                      for k in range(8)])
    for res in ranks:
        assert res["mesh"] == {"data": 2, "model": 1}
        assert np.abs(res["batch"]["energy"] - e_ref).max() < 1e-9
        # gather_global: every process's rows in process order
        np.testing.assert_array_equal(
            res["gathered"], np.repeat([0.0, 1.0], 2)[:, None]
            * np.ones((1, 3)))
    assert np.array_equal(ranks[0]["batch"]["energy"],
                          ranks[1]["batch"]["energy"])


def test_path_opt_cli_workers_under_torchrun(tmp_path):
    """``path-opt --workers 2 --calc-mode morse`` under
    ``python -m torch.distributed.run --nproc-per-node 2``: the string's
    batches over two ranks give ``final_geometries.trj`` byte for byte
    the single-process run's; rank 0's tree is the only output and no
    scratch directory is left behind."""
    a, b = tmp_path / "A.xyz", tmp_path / "B.xyz"
    a.write_text(H3A)
    b.write_text(H3B)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(scratch))
    args = ["-m", "pdb2reaction_tpu_torch", "path-opt", "-i", str(a), "-i",
            str(b), "-q", "0", "--calc-mode", "morse", "--device", "cpu",
            "--freeze-atoms", "0,2", "--max-nodes", "7"]
    one = subprocess.run([sys.executable] + args + ["--out-dir", "one"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode in (0, 3), one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(free_port())] + args + ["--workers", "2", "--out-dir", "two"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == one.returncode or (
        one.returncode == 3 and two.returncode != 0), two.stderr[-3000:]
    trj = "final_geometries.trj"
    assert (tmp_path / "two" / trj).read_bytes() \
        == (tmp_path / "one" / trj).read_bytes()
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) \
        == sorted(p.name for p in (tmp_path / "one").iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["A.xyz", "B.xyz", "one", "two", "tmp"])
    assert not any(p.name.startswith("pdb2r_rank")
                   for p in scratch.iterdir())
    assert two.stdout.count("[path-opt] HEI") == 1


def test_all_workers_absolute_override_under_torchrun(tmp_path):
    """``all --workers 2`` in TSOPT-only mode with an absolute
    ``--tsopt-out-dir`` under ``python -m torch.distributed.run``: the
    override goes through the rank rule too, so each rank reads back its
    own TS for freq and IRC. rc 0, summary.yaml equal to the
    single-process run's, the override written once (rank 0's), one
    output tree and no scratch directory left."""
    a = tmp_path / "A.xyz"
    a.write_text(H3A)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(scratch))
    args = ["-m", "pdb2reaction_tpu_torch", "all", "-i", str(a), "-q", "0",
            "--calc-mode", "morse", "--device", "cpu", "--freeze-atoms",
            "0,2", "--tsopt", "True", "--thermo", "True"]

    def over(tag):
        return ["--out-dir", tag, "--tsopt-out-dir",
                str(tmp_path / f"ts_{tag}")]

    one = subprocess.run([sys.executable] + args + over("one"),
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(free_port())] + args + ["--workers", "2"] + over("two"),
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    s1 = yaml.safe_load((tmp_path / "one" / "summary.yaml").read_text())
    s2 = yaml.safe_load((tmp_path / "two" / "summary.yaml").read_text())
    assert s1 == s2 and "tsopt" in s2
    for tag in ("one", "two"):
        assert (tmp_path / f"ts_{tag}" / "final_geometry.xyz").exists()
        assert (tmp_path / tag / "freq").is_dir()
    assert (tmp_path / "ts_two" / "final_geometry.xyz").read_bytes() \
        == (tmp_path / "ts_one" / "final_geometry.xyz").read_bytes()

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert tree(tmp_path / "two") == tree(tmp_path / "one")
    assert tree(tmp_path / "ts_two") == tree(tmp_path / "ts_one")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["A.xyz", "one", "two", "ts_one", "ts_two", "tmp"])
    assert not any(p.name.startswith("pdb2r_rank")
                   for p in scratch.iterdir())


def test_mesh_and_spatial_must_agree():
    """Under atom-axis sharding (``spatial > 1``) the mesh's "model" axis
    must be the atom axis; when they differ the factory refuses. With
    ``spatial`` 1 a model axis builds a replicated calculator, as the JAX
    factory does (``shard_params_model`` then lays its parameters over
    the axis)."""
    g = SpatialGroup(0, 2, torch.device("cpu"), "gloo")
    mesh = Mesh({"data": 2, "model": 2}, g, g)
    st = Structure.from_symbols(["H", "H"], _h2())
    for spatial in (4, 3):
        with pytest.raises(ValueError, match="model axis is 2"):
            make_uma_calculator(st, model="small", device="cpu", mesh=mesh,
                                spatial=spatial)
    for spatial in (None, 1):
        calc = make_uma_calculator(st, model="small", device="cpu",
                                   mesh=mesh, spatial=spatial)
        assert calc.spatial == 1 and calc.mesh is mesh
    # an atom-axis sharded calculator (the factory sets ``spatial`` as
    # here) refuses the tensor-parallel layout: its model axis carries
    # atom rows, and feature columns laid over it would mix the two
    params = calc.params
    calc.spatial = 2
    with pytest.raises(ValueError, match="spatial=2"):
        calc.shard_params_model()
    assert calc.params is params


def test_shard_params_model_names_its_item():
    """The tensor-parallel layout's entry points: without a model axis
    the mesh's returns the tree as it is and the calculator's is a no-op
    without a mesh; a matrix whose columns divide the axis is laid out,
    the rest replicated."""
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4),
              "v": torch.ones(3, 3)}
    g1 = SpatialGroup(0, 1, torch.device("cpu"), "gloo")
    assert shard_params_model(params, Mesh({"data": 1, "model": 1}, g1,
                                           g1)) is params
    g = SpatialGroup(1, 2, torch.device("cpu"), "gloo")
    laid = shard_params_model(params, Mesh({"data": 1, "model": 2}, g1, g))
    assert laid["w"].local.shape == (3, 2) and laid["w"].shape == (3, 4)
    assert laid["w"].axis == "model" and laid["w"].group is g
    assert torch.equal(laid["w"].local, params["w"][:, 2:])
    assert laid["b"] is params["b"] and laid["v"] is params["v"]
    calc = Calculator(Structure.from_symbols(["H", "H"], _h2()),
                      potentials.make_morse(), device="cpu")
    assert calc.shard_params_model() is calc
