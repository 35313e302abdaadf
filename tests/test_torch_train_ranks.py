"""Training over four gloo CPU ranks (``tests/test_torch_train_worker.py``,
spawned once for the module; the ranks run the "tp" suite on
``make_mesh(data=2, model=2)``, then the "ep" suite on ``make_mesh(data=2,
expert=2)``), and the escn-test loss against JAX's:

- one ``make_sharded_train_step`` step of the PaiNN-class model (JAX
  tests/test_train.py's configuration) against the port's single-rank
  step and against JAX's single-device step on the same numpy batch and
  the same (JAX's) weights: loss rel 1e-4, parameters within 1e-5 (the
  twin of tests/test_train.py::test_sharded_train_step_matches_single),
  and the step's gradients (its first moments) within 1e-5 of each
  leaf's max of the single rank's;
  the matrices really are laid over "model", every rank ends with the
  same whole parameters;
- tensor-parallel inference, the twin of
  tests/test_calculator.py::test_tensor_parallel_inference_identical:
  ``make_uma_calculator(model="small", mesh=...)`` then
  ``shard_params_model()`` against the replicated calculator: energy rel
  1e-6, forces within 1e-8 Hartree/Bohr, the batched call through the
  same laid-out parameters; the analytic Hessian within 1e-5 of max|H|,
  and an escn-test calculator laid out the same way (float64, its
  weights gathered whole each call) at 1e-10;
- ``escn_batched_loss`` of escn-test (the port's default "pallas-mega"
  layout on its plain versions, JAX's default "xla") against JAX's, with
  JAX's weights carried across: loss rel 1e-5, every gradient leaf
  within 1e-4 of its max|g|;
- one ``make_escn_sharded_train_step`` step of escn-test (dp x ep)
  against the port's single-rank step and against JAX's single-device
  step: loss rel 1e-4, parameters within 1e-5 (the twin of
  tests/test_train.py::test_escn_expert_parallel_step_matches_single),
  first moments within 1e-5 of each leaf's max of the single rank's; the
  banks really are laid over "expert".

JAX runs with x64 off (float32 throughout, as the port)."""

import jax
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from pdb2reaction_tpu.mlip import train as JT
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import train as T
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS
from pdb2reaction_tpu_torch.mlip.model import ModelConfig
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

from test_torch_train import (SMALL, check_escn_loss, jax32, jax_batch,
                              jax_escn_loss, jax_painn, np_batch, port_of,
                              torch_batch)
import test_torch_train_worker as worker

LR = 1e-3


def molecule():
    rng = np.random.default_rng(9)
    zs = np.array([6, 1, 1, 8, 1, 7, 1, 1], np.int32)
    return zs, rng.normal(scale=1.3, size=(8, 3))


def np_tree(tree):
    return jtu.tree_map(lambda t: t.detach().numpy(), tree)


def jax_step(jp, g):
    opt = optax.adam(LR)
    up, _ = opt.update(g, opt.init(jp), jp)
    return optax.apply_updates(jp, up)


def port_step(make, cfg, params, b):
    opt = T.adam(LR)
    p1, s1, l1 = make(cfg, opt)(params, opt.init(params), torch_batch(b))
    return float(l1), p1, [m.numpy() for m in s1.mu]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{"tp": ..., "ep": ...}: each suite's ranks, the port's single-rank
    step (loss, parameters, first moments) and JAX's step (loss,
    parameters); "ep" also JAX's loss, gradients and weights."""
    # dp x tp: the PaiNN-class model
    jcfg, jp = jax_painn()
    b = np_batch(4)
    lj, g = jax32(jax.jit(jax.value_and_grad(JT.batched_loss),
                          static_argnums=2), jp, jax_batch(b), jcfg)
    cfg = ModelConfig(**SMALL)
    params = port_of(jp)
    tp = {"single": port_step(T.make_train_step, cfg, params, b),
          "jax": (float(lj), jax_step(jp, g))}
    tp_in = {"params": np_tree(params), "cfg": cfg, "batch": b, "lr": LR,
             "st": molecule()}
    # dp x ep: escn-test
    be = np_batch(2, B=4)
    lje, gje, jpe = jax_escn_loss("escn-test", be)
    ecfg = ESCN_CONFIGS["escn-test"]
    pe = port_of(jpe)
    ep = {"single": port_step(T.make_escn_train_step, ecfg, pe, be),
          "jax": (lje, jax_step(jpe, gje)), "loss": (be, lje, gje, jpe)}
    ep_in = {"params": np_tree(pe), "cfg": ecfg, "batch": be, "lr": LR}
    ranks = worker.spawn(tmp_path_factory.mktemp("train_ranks"),
                         {"tp": tp_in, "ep": ep_in})
    tp["ranks"] = [r["tp"] for r in ranks]
    ep["ranks"] = [r["ep"] for r in ranks]
    return {"tp": tp, "ep": ep}


def test_mesh_has_four_ranks_data_by_model(run):
    ranks = run["tp"]["ranks"]
    assert [r["mesh"] for r in ranks] == [
        ({"data": 2, "model": 2}, d, m) for d in range(2) for m in range(2)]


def assert_moments_close(mu, ref, tol):
    """First moments (0.1 x the step's gradients), each leaf within
    ``tol`` of its max: Adam's first update is +-lr wherever |g| >> eps,
    so the parameters alone would not show a gradient off by a factor."""
    assert len(mu) == len(ref)
    for a, b in zip(mu, ref):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def test_dp_tp_step_matches_single_rank_and_jax(run):
    ranks = run["tp"]["ranks"]
    (l1, p1, mu1), (lj, pj) = run["tp"]["single"], run["tp"]["jax"]
    p1 = np_tree(p1)
    for r in ranks:
        s = r["step"]
        assert s["loss"] == pytest.approx(l1, rel=1e-4)
        assert s["loss"] == pytest.approx(lj, rel=1e-4)
        assert s["count"] == 1
        for a, b, c in zip(jtu.tree_leaves(s["params"]),
                           jtu.tree_leaves(p1), jtu.tree_leaves(pj)):
            assert np.abs(a - b).max() < 1e-5
            assert np.abs(a - np.asarray(c)).max() < 1e-5
        assert_moments_close(s["mu"], mu1, 1e-5)
    # the matrices are laid over "model" (half their columns a rank);
    # every rank gathers the same whole parameters back
    shards = ranks[0]["step"]["shards"]
    assert shards and all(ax == "model" for _, ax, _ in shards)
    assert ("Shard", "model", (32, 48)) in shards     # phi[1]: [32, 96]
    for r in ranks[1:]:
        for a, b in zip(jtu.tree_leaves(r["step"]["params"]),
                        jtu.tree_leaves(ranks[0]["step"]["params"])):
            np.testing.assert_array_equal(a, b)


def test_shard_params_model_inference_matches_replicated(run):
    ranks = run["tp"]["ranks"]
    st = Structure(*molecule())
    ref = make_uma_calculator(st, model="small", charge=0, spin=1, seed=2,
                              device="cpu")
    base = st.coords_bohr.reshape(-1)
    r0 = ref.get_forces(base)
    for r in ranks:
        assert r["n_shards"] > 0
        r1 = r["forces"]
        # f32 parameters: the laid-out products sum in another order, so
        # identity holds to f32 epsilon
        assert r1["energy"] == pytest.approx(r0["energy"], rel=1e-6)
        np.testing.assert_allclose(r1["forces"], r0["forces"], atol=1e-8)
        rb = r["batch"]
        assert rb["energy"][0] == pytest.approx(r0["energy"], rel=1e-6)
        np.testing.assert_allclose(rb["forces"][0], r0["forces"], atol=1e-8)
        assert rb["energy"][1] != rb["energy"][0]


def test_shard_params_model_hessian_and_escn_match_replicated(run):
    """The Hessian of the laid-out PaiNN calculator (its closures rebuilt
    on the laid-out parameters) within 1e-5 of max|H| of the replicated
    one's; an escn-test calculator (float64) laid out over "model",
    which gathers its weights whole each call: forces within 1e-10 of
    the replicated ones, energy at rel 1e-12."""
    ranks = run["tp"]["ranks"]
    st = Structure(*molecule())
    base = st.coords_bohr.reshape(-1)
    H0 = make_uma_calculator(st, model="small", charge=0, spin=1, seed=2,
                             device="cpu").get_hessian(base)["hessian"]
    e0 = make_uma_calculator(st, model="escn-test", charge=0, spin=1,
                             seed=2, device="cpu",
                             dtype=torch.float64).get_forces(base)
    for r in ranks:
        assert np.abs(r["hessian"] - H0).max() <= 1e-5 * np.abs(H0).max()
        assert r["escn_shards"] > 0
        assert r["escn"]["energy"] == pytest.approx(e0["energy"],
                                                    rel=1e-12)
        np.testing.assert_allclose(r["escn"]["forces"], e0["forces"],
                                   rtol=0, atol=1e-10)


def test_tensor_parallel_calculator_without_mesh_is_unchanged():
    """``shard_params_model`` without a mesh leaves the calculator as it
    is, as the JAX calculator's does."""
    st = Structure(*molecule())
    calc = make_uma_calculator(st, model="small", seed=2, device="cpu")
    params = calc.params
    assert calc.shard_params_model() is calc and calc.params is params



def test_escn_loss_and_gradients_match_jax(run):
    check_escn_loss("escn-test", *run["ep"]["loss"])


def test_dp_ep_step_matches_single_rank_and_jax(run):
    ep = run["ep"]
    (l1, p1, mu1), (lj, p_jax) = ep["single"], ep["jax"]
    assert [r["mesh"] for r in ep["ranks"]] == [
        ({"data": 2, "model": 1, "expert": 2}, d, e)
        for d in range(2) for e in range(2)]
    for r in ep["ranks"]:
        s = r["step"]
        assert s["loss"] == pytest.approx(l1, rel=1e-4)
        assert s["loss"] == pytest.approx(lj, rel=1e-4)
        for a, b, c in zip(jtu.tree_leaves(s["params"]),
                           T.tree_leaves(p1), jtu.tree_leaves(p_jax)):
            assert np.abs(a - b.numpy()).max() < 1e-5
            assert np.abs(a - np.asarray(c)).max() < 1e-5
        assert_moments_close(s["mu"], mu1, 1e-5)


def test_dp_ep_lays_every_bank_over_expert(run):
    """Every MoLE bank ({"w": [E, in, out], "b": [E, out]}) is laid over
    "expert", half of escn-test's two experts a rank; nothing else is."""
    ep = run["ep"]
    shards = ep["ranks"][0]["step"]["shards"]
    banks = [x for x in T._leaves(ep["single"][1]) if x.ndim >= 2
             and x.shape[0] == ESCN_CONFIGS["escn-test"].num_experts]
    assert len(shards) == len(banks) > 0
    assert all(ax == "expert" and shape[0] == 1 for _, ax, shape in shards)
