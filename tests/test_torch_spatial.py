"""Atom-axis sharding of the port (parallel/, the sharded pallas and
gather modes, make_uma_calculator(spatial=4), the sharded opt) in four
gloo CPU processes, against the JAX package's ``make_spatial_energy_fn``
on the 8-device CPU mesh with the same weights (carried across with
``from_jax``).

The workers (``test_torch_spatial_worker.py``, spawned with
``torch.multiprocessing`` on a free localhost port) import only the port;
this process computes the JAX side and hands the inputs over in a file.
Tolerances:
- pallas mode (f32): energy 1e-5 relative, forces rtol 1e-4 atol 1e-6
  against JAX, as tests/test_spatial.py:155-157, and against the port's
  unsharded pallas mode;
- gather mode in f64: forces 1e-9 relative; energy 1e-9 relative plus a
  few f32 ulps (both packages sum the per-atom energies in float32 and
  order the sum differently);
- the factory: 1e-8 Ha and forces rtol 1e-5 atol 1e-8, as
  test_uma_factory_spatial (f32 model math, sums reordered);
- eSCN (escn-test in the "pallas-mega" layout, which takes K3's under a
  shard, and in "pallas" and "xla"; escn-test-gate) in f64 against the
  JAX package's unsharded ``escn_energy``: energy and forces rtol 1e-10;
  the premerged eSCN factory path (twin of tests/test_spatial.py:74-96,
  181-197) and a sharded escn-test opt against the unsharded ones in
  f64, rtol 1e-10;
- forces bitwise equal on the four ranks and across two calls."""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.core.structure import pad_to as jpad_to
from pdb2reaction_tpu.mlip.escn import escn_energy as j_escn_energy
from pdb2reaction_tpu.mlip.model import ModelConfig as JModelConfig
from pdb2reaction_tpu.mlip.model import make_model as j_make_model
from pdb2reaction_tpu.parallel.mesh import make_mesh
from pdb2reaction_tpu.parallel.spatial import make_spatial_energy_fn
from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

from test_torch_escn import jax_weights_np

REPO = Path(__file__).resolve().parents[1]
CFG = dict(hidden=16, n_layers=2, n_radial=6, cutoff=4.0, max_neighbors=12)
F32_SUM = 8 * float(np.finfo(np.float32).eps)
RANKS = 4
ESCN = ("escn-test", "escn-test-gate")
RTOL = 1e-10                # eSCN in f64 against unsharded


def _structure(n, seed, spacing=1.5):
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n, p=[0.5, 0.3, 0.1, 0.1])
    grid = int(np.ceil(n ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(grid)] * 3), -1).reshape(-1, 3)
    coords = pts[:n] * spacing + rng.normal(scale=0.1, size=(n, 3))
    return zs.astype(np.int32), coords


def _jax_weights(mode, jdt, seed):
    """Numpy weights of the JAX model, every float perturbed (non-zero
    biases), and the JAX config."""
    cfg = JModelConfig(**CFG, mp_mode=mode, dtype=jdt)
    _, p, cfg = j_make_model(cfg, seed=seed, charge=-1, spin=2)
    rng = np.random.default_rng(seed + 50)
    p = jtu.tree_map(np.asarray, p)
    p = jtu.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if a.ndim > 0 and a.dtype.kind == "f" else a, p)
    return p, cfg


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX side here, then the four ranks once; every test below reads
    their results."""
    import torch.multiprocessing as mp
    import test_torch_spatial_worker
    d = tmp_path_factory.mktemp("spatial")
    zs, xyz = _structure(60, seed=5)
    sys_ = jpad_to(JStructure(zs, xyz), n_pad=64)       # 16 rows a rank
    mesh = make_mesh(data=2, model=RANKS)
    weights, jax_eg = {}, {}
    for mode, jdt in (("pallas", jnp.float32), ("gather", jnp.float64)):
        p, cfg = _jax_weights(mode, jdt, seed=1)
        fn = make_spatial_energy_fn(cfg, mesh, axis="model")
        e, g = jax.jit(jax.value_and_grad(
            lambda c: fn(c, sys_, jtu.tree_map(jnp.asarray, p))))(
            jnp.asarray(sys_.coords))
        weights[mode], jax_eg[mode] = p, (float(e), np.asarray(g))
    for name in ESCN:
        p, cfg = jax_weights_np(name, jnp.float64, seed=2, charge=1, spin=2)
        e, g = jax.jit(jax.value_and_grad(
            lambda c: j_escn_energy(c, sys_, jtu.tree_map(jnp.asarray, p),
                                    cfg)))(jnp.asarray(sys_.coords))
        weights[name], jax_eg[name] = p, (float(e), np.asarray(g))
    fzs, fxyz = _structure(17, seed=11)
    xyz_path = d / "x.xyz"
    write_xyz(xyz_path, Structure(fzs, fxyz))
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"system": (zs, xyz), "n_pad": 64, "cfg": CFG,
                     "weights": weights, "factory_system": (fzs, fxyz),
                     "xyz_path": str(xyz_path)}, fh)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=test_torch_spatial_worker.main,
                         args=(r, port, str(d))) for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    errs = [(d / f"rank{r}.err").read_text() for r in range(RANKS)
            if (d / f"rank{r}.err").exists()]
    assert not alive and not errs, (len(alive), errs)
    assert all(p.exitcode == 0 for p in procs)
    ranks = []
    for r in range(RANKS):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return ranks, jax_eg, d


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() \
        / max(np.abs(np.asarray(b)).max(), 1e-30)


def test_groups_are_gloo_on_the_cpu(run):
    ranks, _, _ = run
    assert [r["group"] for r in ranks] == [(k, RANKS, "cpu", "gloo")
                                           for k in range(RANKS)]


def test_sharded_pallas_matches_jax_and_unsharded(run):
    ranks, jax_eg, _ = run
    e_j, g_j = jax_eg["pallas"]
    for res in ranks:
        e, g = res["pallas"]
        assert abs(e - e_j) < 1e-5 * max(1.0, abs(e_j))
        np.testing.assert_allclose(g, g_j, rtol=1e-4, atol=1e-6)
        e0, g0 = res["pallas_unsharded"]
        assert abs(e - e0) < 1e-5 * max(1.0, abs(e0))
        np.testing.assert_allclose(g, g0, rtol=1e-4, atol=1e-6)


def test_sharded_gather_f64_matches_jax(run):
    ranks, jax_eg, _ = run
    e_j, g_j = jax_eg["gather"]
    for res in ranks:
        e, g = res["gather"]
        assert abs(e - e_j) <= (1e-9 + F32_SUM) * abs(e_j)
        assert _rel(g, g_j) <= 1e-9


def test_uma_factory_spatial_matches_unsharded(run):
    ranks, _, _ = run
    for res in ranks:
        r0, r1, n_pad, mode = res["factory"]
        assert n_pad % RANKS == 0 and mode == "gather"
        assert abs(r1["energy"] - r0["energy"]) < 1e-8
        np.testing.assert_allclose(r1["forces"], r0["forces"], rtol=1e-5,
                                   atol=1e-8)


def test_forces_bitwise_equal_across_ranks_and_calls(run):
    ranks, _, _ = run
    first = ranks[0]
    for res in ranks:
        for key in ("pallas", "gather"):
            assert res[key][0] == first[key][0]
            assert np.array_equal(res[key][1], first[key][1])
        assert np.array_equal(res["factory"][1]["forces"],
                              first["factory"][1]["forces"])
        assert np.array_equal(res["repeat"], res["factory"][1]["forces"])


def test_sharded_opt_same_on_every_rank_and_rank0_writes(run):
    ranks, _, d = run
    e0, calls0, x0, _ = ranks[0]["opt"]
    assert calls0 >= 2 and np.isfinite(e0)
    for res in ranks:
        e, calls, x, _ = res["opt"]
        assert (e, calls) == (e0, calls0) and np.array_equal(x, x0)
    assert ranks[0]["opt"][3] == [str(d / "opt" / "final_geometry.xyz")]
    assert all(res["opt"][3] == [] for res in ranks[1:])
    assert (d / "opt" / "final_geometry.xyz").exists()


@pytest.mark.parametrize("case", [
    "escn-test/pallas-mega", "escn-test/pallas", "escn-test/xla",
    "escn-test-gate/pallas-mega"])
def test_sharded_escn_f64_matches_jax(run, case):
    """Each rank's sharded eSCN energy and forces against the JAX
    package's unsharded f64 ones, bitwise equal on every rank and in a
    second call."""
    ranks, jax_eg, _ = run
    e_j, g_j = jax_eg[case.split("/")[0]]
    e0, g0, _ = ranks[0][case]
    for res in ranks:
        e, g, again = res[case]
        assert abs(e - e_j) <= RTOL * abs(e_j)
        assert _rel(g, g_j) <= RTOL
        assert e == e0 and np.array_equal(g, g0) and np.array_equal(g, again)


@pytest.mark.parametrize("name", ESCN)
def test_uma_factory_spatial_escn_premerged(run, name):
    """make_uma_calculator(model=escn-*, spatial=4) premerges the MoLE
    banks, pads to a multiple of 4 and matches the unsharded, unmerged
    closure's calculator in f64; forces bitwise equal on every rank and
    across calls."""
    ranks, _, _ = run
    first = ranks[0][f"factory/{name}"]
    for res in ranks:
        r0, r1, again, n_pad, premerged = res[f"factory/{name}"]
        assert premerged and n_pad % RANKS == 0
        assert abs(r1["energy"] - r0["energy"]) <= RTOL * abs(r0["energy"])
        assert _rel(r1["forces"], r0["forces"]) <= RTOL
        assert np.array_equal(r1["forces"], again)
        assert np.array_equal(r1["forces"], first[1]["forces"])


def test_sharded_escn_opt_matches_unsharded(run):
    """A 3-cycle sharded escn-test L-BFGS opt (f64) on every rank against
    the unsharded one: the same calls, energies within rtol 1e-10."""
    ranks, _, _ = run
    e0, calls0, x0 = ranks[0]["escn_opt"][0]
    for res in ranks:
        (e, calls, x), (e_u, calls_u, x_u) = res["escn_opt"]
        assert (e, calls) == (e0, calls0) and np.array_equal(x, x0)
        assert calls == calls_u and calls >= 2
        assert abs(e - e_u) <= RTOL * abs(e_u)
        np.testing.assert_allclose(x, x_u, rtol=0, atol=1e-8)


def test_spatial_without_a_group_raises(tmp_path):
    zs, xyz = _structure(10, seed=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_uma_calculator(Structure(zs, xyz), device="cpu", spatial=4)
    # the CLI refuses --spatial 4 unless launched as 4 ranks
    path = tmp_path / "x.xyz"
    write_xyz(path, Structure(zs, xyz))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-m", "pdb2reaction_tpu_torch", "opt", "-i",
         str(path), "--device", "cpu", "--spatial", "4"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "torchrun" in r.stderr


@pytest.mark.parametrize("model", ["small", "escn-test"])
def test_opt_cli_under_torchrun(tmp_path, model):
    """``torchrun --nproc-per-node 2 -m pdb2reaction_tpu_torch opt ...
    --spatial 2 --device cpu --model M``, PaiNN-class and eSCN: both
    ranks converge (exit 0; torchrun reports a rank's exit 3, not
    converged, as a failure), rank 0 writes."""
    zs, xyz = _structure(10, seed=3)
    path = tmp_path / "x.xyz"
    write_xyz(path, Structure(zs, xyz))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "pdb2reaction_tpu_torch", "opt", "-i",
         str(path), "--device", "cpu", "--spatial", "2", "--model", model,
         "-q", "0",
         "--thresh", "gau_loose", "--max-cycles", "200"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "result_opt" / "final_geometry.xyz"
    assert out.exists() and out.read_text().splitlines()[0] == "10"
    assert r.stdout.count("[opt] wrote") == 1
