"""Hessians through the sharded call (``make_spatial_hessian_energy_fn``
and the collectives' double backward) on four gloo CPU model ranks,
against the JAX package on the 8-device CPU mesh: the twin of
tests/test_spatial.py:52-72.

The ranks (``test_torch_mesh_worker.py``, suite "hess") are spawned once
for the module on a 12-atom cluster padded to 16 atoms (four rows a
rank). Tolerances, relative to max|H|:
- PaiNN ``gather`` in f64 on JAX weights: JAX's ``make_spatial_energy_fn``
  calculator Hessian at 1e-9;
- escn-test in f64 ("pallas-mega", whose force path takes K3's plain
  version under the shard, and "xla"; both Hessians on the sharded
  "xla" closure): JAX's unsharded XLA calculator Hessian and an HVP at
  1e-9;
- PaiNN ``pallas`` through its plain closure (K6's plain version; the
  pallas layout computes in f32 in both packages, so no f64 case): the
  port's unsharded plain closure, and on the gather case's weights JAX's
  f64 ``make_spatial_energy_fn`` Hessian, each at 1e-5;
- the same bits on every rank;
- the all-gather with its old first-order backward (detached): the
  Hessian loses the terms that cross the row blocks and misses JAX's by
  more than 1e-4, so a dropped second-order term fails the checks
  above."""

import pickle

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu.parallel.mesh import make_mesh as j_make_mesh
from pdb2reaction_tpu.parallel.spatial import (
    make_spatial_energy_fn as j_spatial_fn)

from test_torch_escn import jax_weights_np
from test_torch_mesh import spawn_ranks
from test_torch_spatial import CFG, _jax_weights, _structure

RANKS = 4
RTOL = 1e-9


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() \
        / max(np.abs(np.asarray(b)).max(), 1e-30)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("spatial_hessian")
    zs, xyz = _structure(12, seed=21, spacing=1.3)
    jst = JStructure(zs, xyz)
    x0 = jst.coords_bohr.reshape(-1)
    mesh = j_make_mesh(data=2, model=RANKS)
    pg, cfg = _jax_weights("gather", jnp.float64, seed=1)
    jg = JCalculator(jst, j_spatial_fn(cfg, mesh, axis="model"),
                     params=jtu.tree_map(jnp.asarray, pg))
    pe, ecfg = jax_weights_np("escn-test", jnp.float64, seed=3)
    je = JCalculator(jst, ESCN_FN_FOR(ecfg),
                     params=j_premerge(jtu.tree_map(jnp.asarray, pe), ecfg))
    v = np.random.default_rng(4).normal(size=(je.n_pad, 3))
    xp = je.pad_bohr(x0)
    jax_ref = {"gather": jg.get_hessian(x0)["hessian"],
               "escn": je.get_hessian(x0)["hessian"],
               "escn_hvp": np.asarray(je.au_hvp_fn()(xp, jnp.asarray(v)))}
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"system": (zs, xyz), "cfg": CFG, "gather_weights": pg,
                     "escn_weights": pe, "tangent": v}, fh)
    return spawn_ranks("hess", RANKS, d), jax_ref


def test_gather_f64_hessian_matches_jax_spatial(run):
    ranks, jax_ref = run
    for res in ranks:
        assert _rel(res["gather"], jax_ref["gather"]) <= RTOL


@pytest.mark.parametrize("layout", ["pallas-mega", "xla"])
def test_escn_f64_hessian_and_hvp_match_jax(run, layout):
    ranks, jax_ref = run
    for res in ranks:
        H, hv = res[f"escn/{layout}"]
        assert _rel(H, jax_ref["escn"]) <= RTOL
        assert _rel(hv, jax_ref["escn_hvp"]) <= RTOL


def test_pallas_plain_closure_hessian_matches_unsharded(run):
    ranks, _ = run
    for res in ranks:
        H_sharded, H_one = res["pallas"]
        assert _rel(H_sharded, H_one) <= 1e-5


def test_pallas_sharded_hessian_matches_jax_spatial(run):
    """The sharded PaiNN pallas calculator (its Hessian closure on K6's
    plain version, float32 compute in both packages) on the gather case's
    JAX weights, against JAX's f64 ``make_spatial_energy_fn`` Hessian of
    the same model within 1e-5 of max|H|."""
    ranks, jax_ref = run
    for res in ranks:
        assert _rel(res["pallas_jax"], jax_ref["gather"]) <= 1e-5


def test_hessians_bitwise_equal_across_ranks(run):
    ranks, _ = run
    first = ranks[0]
    for res in ranks[1:]:
        for key in ("gather", "pallas_jax", "dropped"):
            assert np.array_equal(res[key], first[key])
        for key in ("escn/pallas-mega", "escn/xla"):
            assert np.array_equal(res[key][0], first[key][0])
        assert np.array_equal(res["pallas"][0], first["pallas"][0])


def test_dropped_second_order_terms_fail_the_check(run):
    """The old all-gather (a first-order backward only) gives a Hessian
    that misses JAX's far outside the tolerance: the checks above see a
    collective whose second-order term is dropped."""
    ranks, jax_ref = run
    for res in ranks:
        assert _rel(res["dropped"], jax_ref["escn"]) > 1e-4
