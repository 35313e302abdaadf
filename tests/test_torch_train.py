"""The port's fine-tuning (``mlip/train.py``) against the JAX package's
``mlip/train.py`` on the CPU: the PaiNN-class losses and their gradients,
the optimizer against ``optax.adam``, an optax state carried across, the
loss going down, the layouts' specs and the refusals.

Inputs are made with numpy and fed to both packages; the weights are
JAX's, carried across with ``from_jax``. JAX runs with x64 off (``jax.
enable_x64(False)``): under x64 its radial bases are computed in float64,
which the port's float32 is not. Tolerances (float32 on both sides):
- the loss rel 1e-5, every gradient leaf within 1e-4 of its max|g|
  (``dense``; ``pallas`` on the plain paths: K5's plain version in the
  port, the jnp reference in JAX);
- the optimizer on the same gradients, and a step after a carried
  state: 1e-6.
The escn-test loss, the dp x tp and dp x ep steps and tensor-parallel
inference are in ``tests/test_torch_train_ranks.py``, the escn-test-gate
loss in ``tests/test_torch_train_gate.py``, the kernels' weight
cotangents in ``tests/test_torch_train_wgrad.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from pdb2reaction_tpu.mlip import train as JT
from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JESCN
from pdb2reaction_tpu.mlip.escn import make_escn_model
from pdb2reaction_tpu.mlip.model import ModelConfig as JModelConfig
from pdb2reaction_tpu.mlip.model import init_params as j_init_params
from pdb2reaction_tpu.parallel.mesh import make_mesh as j_make_mesh
from pdb2reaction_tpu_torch.mlip import train as T
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS, init_escn_params
from pdb2reaction_tpu_torch.mlip.from_jax import (adam_state_from_jax,
                                                  params_from_jax)
from pdb2reaction_tpu_torch.mlip.model import ModelConfig
from pdb2reaction_tpu_torch.parallel import Mesh, SpatialGroup

# JAX tests/test_train.py's configuration
SMALL = dict(hidden=32, n_layers=2, n_radial=6, cutoff=4.0, max_neighbors=8)


def np_batch(seed, B=8, P=8, n=5):
    """A TrainBatch as numpy arrays: JAX ``random_batch``'s layout (the
    first n slots real, elements 1-8, coordinates in [0, 4) Angstrom,
    normal targets)."""
    rng = np.random.default_rng(seed)
    mask = np.broadcast_to((np.arange(P) < n).astype(np.float32), (B, P))
    numbers = (rng.integers(1, 9, size=(B, P)) * mask).astype(np.int32)
    coords = (rng.uniform(0, 4, size=(B, P, 3)) * mask[..., None]) \
        .astype(np.float32)
    energy = rng.normal(size=B).astype(np.float32)
    forces = (rng.normal(size=(B, P, 3)) * mask[..., None]) \
        .astype(np.float32)
    return numbers, coords, np.ascontiguousarray(mask), energy, forces


def jax_batch(b):
    return JT.TrainBatch(*(jnp.asarray(a) for a in b))


def torch_batch(b):
    return T.TrainBatch(*(torch.as_tensor(a) for a in b))


def f32(tree):
    """Every float leaf in float32 (JAX's initialisers give float64
    under x64)."""
    return jtu.tree_map(lambda a: jnp.asarray(a, jnp.float32)
                        if jnp.asarray(a).dtype.kind == "f" else a, tree)


def jax_painn(mode="dense"):
    cfg = JModelConfig(dtype=jnp.float32, mp_mode=mode, **SMALL)
    p = f32(j_init_params(jax.random.PRNGKey(0), cfg))
    p["charge"] = jnp.asarray(0.0, jnp.float32)
    p["spin"] = jnp.asarray(1.0, jnp.float32)
    return cfg, p


def port_of(jp):
    return params_from_jax(jtu.tree_map(np.asarray, jp))


def port_grads(loss_fn, params):
    leaves = [x.detach().requires_grad_(True) for x in T.tree_leaves(params)]
    loss = loss_fn(T._with_leaves(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss), [torch.zeros_like(x) if g is None else g
                         for x, g in zip(leaves, grads)]


def assert_leaves_close(port, jax_leaves, tol):
    assert len(port) == len(jax_leaves)
    for a, b in zip(port, jax_leaves):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def jax32(fn, *args):
    """``fn(*args)`` with JAX's x64 off: float32 throughout."""
    with jax.enable_x64(False):
        return fn(*args)


def jax_escn_loss(name, b):
    """JAX's eSCN loss, its gradient tree and the weights for ``name``
    (float32, x64 off)."""
    _, jp, jcfg = make_escn_model(name, seed=0)
    jp = f32(jp)
    lj, gj = jax32(jax.jit(jax.value_and_grad(JT.escn_batched_loss),
                           static_argnums=2), jp, jax_batch(b), jcfg)
    return float(lj), gj, jp


def check_escn_loss(name, b, lj, gj, jp):
    """The port's eSCN loss and gradients against JAX's: loss rel 1e-5,
    every gradient leaf within 1e-4 of its max|g|."""
    cfg = ESCN_CONFIGS[name]
    lt, gt = port_grads(lambda p: T.escn_batched_loss(p, torch_batch(b),
                                                      cfg), port_of(jp))
    assert lt == pytest.approx(lj, rel=1e-5)
    assert_leaves_close(gt, jtu.tree_leaves(gj), 1e-4)


@pytest.fixture(scope="module")
def jax_dense():
    """JAX's dense PaiNN loss and gradient, jitted once for the module."""
    cfg, p = jax_painn("dense")
    vg = jax.jit(jax.value_and_grad(JT.batched_loss), static_argnums=2)
    return cfg, p, lambda *a: jax32(vg, *a)


@pytest.mark.parametrize("mode", ["dense", "pallas"])
def test_batched_loss_and_gradients_match_jax(mode, jax_dense):
    b = np_batch(1)
    if mode == "dense":
        jcfg, jp, vg = jax_dense
        lj, gj = vg(jp, jax_batch(b), jcfg)
    else:
        jcfg, jp = jax_painn(mode)
        lj, gj = jax32(jax.jit(jax.value_and_grad(JT.batched_loss),
                               static_argnums=2), jp, jax_batch(b), jcfg)
    tcfg = ModelConfig(mp_mode=mode, **SMALL)
    lt, gt = port_grads(lambda p: T.batched_loss(p, torch_batch(b), tcfg),
                        port_of(jp))
    assert lt == pytest.approx(float(lj), rel=1e-5)
    assert_leaves_close(gt, jtu.tree_leaves(gj), 1e-4)


def rel_leaf_err(got, want):
    """The largest leaf error, each relative to its leaf's max|want|."""
    return max(np.abs(np.asarray(a) - np.asarray(b)).max()
               / max(np.abs(np.asarray(b)).max(), 1e-30)
               for a, b in zip(got, want))


def test_ill_conditioned_batch_matches_jax_in_float64(jax_dense):
    """``np_batch(4)``: its structures 4 and 6 carry channels whose |vv|
    lies at or below the update block's sqrt(|vv|^2 + 1e-8) floor
    (1.2e-5 and 1.1e-9), where that norm bends sharply: the force loss's
    parameter gradient moves by 4.4e-4 to 2.1e-3 of max|g| when the
    float64 coordinates move by 6e-8 relative, float32's rounding
    (``python tests/test_torch_train_f32_scan.py --probe 4``). Float32
    gradients there part from the exact ones by more than the 1e-4 held
    on ``np_batch(1)``, in both packages. So on this batch the packages
    are held to each other in float64 (the loss rel 1e-9, every leaf
    within 1e-7 of its max|g|: both readouts sum the atom energies in
    float32), and each package's float32 gradient to the float64 one
    within 1e-3 of max|g| (measured 6.3e-4 for the port, 1.2e-4 for
    JAX)."""
    b = np_batch(4)
    b64 = [a.astype(np.float64) if a.dtype.kind == "f" else a for a in b]
    jcfg, jp, vg = jax_dense
    with jax.enable_x64(True):
        jp64 = jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64)
                            if jnp.asarray(a).dtype.kind == "f" else a, jp)
        lj64, gj64 = jax.jit(jax.value_and_grad(JT.batched_loss),
                             static_argnums=2)(
            jp64, jax_batch(b64), dataclasses.replace(jcfg,
                                                      dtype=jnp.float64))
        gj64 = jtu.tree_leaves(gj64)
    _, gj32 = vg(jp, jax_batch(b), jcfg)
    p64 = jtu.tree_map(lambda t: t.double() if t.is_floating_point() else t,
                       port_of(jp))
    lt64, gt64 = port_grads(lambda p: T.batched_loss(
        p, torch_batch(b64), ModelConfig(dtype=torch.float64, **SMALL)),
        p64)
    assert lt64 == pytest.approx(float(lj64), rel=1e-9)
    assert_leaves_close(gt64, gj64, 1e-7)
    _, gt32 = port_grads(lambda p: T.batched_loss(
        p, torch_batch(b), ModelConfig(**SMALL)), port_of(jp))
    assert rel_leaf_err([g.numpy() for g in gt32], gj64) <= 1e-3
    assert rel_leaf_err(jtu.tree_leaves(gj32), gj64) <= 1e-3


def test_adam_matches_optax():
    """Three steps of the port's Adam and of optax.adam on the same
    gradients: updates, moments and the count."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "c": ()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt_j = optax.adam(1e-3)
    st_j = opt_j.init(jtu.tree_map(jnp.asarray, params))
    opt_t = T.adam(1e-3)
    pt = {k: torch.as_tensor(v) for k, v in params.items()}
    st_t = opt_t.init(pt)
    pj = jtu.tree_map(jnp.asarray, params)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        g["c"] = np.float32(0.0)              # a leaf with no gradient
        up_j, st_j = opt_j.update(jtu.tree_map(jnp.asarray, g), st_j, pj)
        pj = optax.apply_updates(pj, up_j)
        up_t, st_t = opt_t.update([torch.as_tensor(g[k])
                                   for k in sorted(g)], st_t, pt)
        pt = T.apply_updates(pt, up_t)
        for k, u in zip(sorted(g), up_t):
            np.testing.assert_allclose(u.numpy(), np.asarray(up_j[k]),
                                       rtol=0, atol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=1e-6)
    assert int(st_t.count) == int(st_j[0].count) == 3
    for mom_t, mom_j in ((st_t.mu, st_j[0].mu), (st_t.nu, st_j[0].nu)):
        for k, m in zip(sorted(shapes), mom_t):
            np.testing.assert_allclose(m.numpy(), np.asarray(mom_j[k]),
                                       rtol=1e-6, atol=1e-9)


def test_train_step_reduces_loss():
    """The twin of tests/test_train.py::test_train_step_reduces_loss: 30
    Adam steps at 3e-3 on the dense surrogate bring the loss below 0.9 x
    its first value."""
    cfg = ModelConfig(**SMALL)
    _, jp = jax_painn()
    params = port_of(jp)
    opt = T.adam(3e-3)
    state = opt.init(params)
    step = T.make_train_step(cfg, opt)
    batch = torch_batch(np_batch(1))
    losses = []
    for _ in range(30):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    assert int(state.count) == 30


def test_from_jax_carries_the_adam_state(jax_dense):
    """Three JAX steps, then the parameters and the optax state carried
    across: the port's fourth step equals JAX's fourth step."""
    jcfg, jp, vg = jax_dense
    opt_j = optax.adam(1e-3)
    st_j = opt_j.init(jp)
    bj = jax_batch(np_batch(1))
    for _ in range(3):
        _, g = vg(jp, bj, jcfg)
        up, st_j = opt_j.update(g, st_j, jp)
        jp = optax.apply_updates(jp, up)
    params = port_of(jp)
    state = adam_state_from_jax(jtu.tree_map(np.asarray, st_j), params)
    assert int(state.count) == 3
    assert len(state.mu) == len(T.tree_leaves(params))
    _, g = vg(jp, bj, jcfg)
    up, st_j = opt_j.update(g, st_j, jp)
    jp = optax.apply_updates(jp, up)
    opt = T.adam(1e-3)
    params, state, _ = T.make_train_step(ModelConfig(**SMALL), opt)(
        params, state, torch_batch(np_batch(1)))
    assert int(state.count) == 4
    for a, b in zip(T.tree_leaves(params), jtu.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def _spec_of(sharding):
    return tuple(sharding.spec)


def spec_leaves(tree):
    """A spec tree's tuples in JAX's leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in spec_leaves(v)]
    return [tuple(tree)]


def test_layout_specs_match_jax():
    """``param_shardings`` (model 2) and ``escn_param_shardings`` (expert
    2) name the same dimension of the same leaves as JAX's
    NamedShardings."""
    _, jp = jax_painn()
    jmesh = j_make_mesh(data=4, model=2)
    want = jtu.tree_leaves(jtu.tree_map(_spec_of,
                                        JT.param_shardings(jp, jmesh)),
                           is_leaf=lambda x: isinstance(x, tuple))
    g = SpatialGroup(0, 2, torch.device("cpu"), "gloo")
    mesh = Mesh({"data": 4, "model": 2}, g, g)
    got = spec_leaves(T.param_shardings(port_of(jp), mesh))
    assert got == [tuple(s) for s in want]
    assert (None, "model") in got

    ecfg = JESCN["escn-test"]
    tp = init_escn_params(ESCN_CONFIGS["escn-test"], seed=0)
    ep = jtu.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                              ("data", "expert"))
    want = jtu.tree_leaves(jtu.tree_map(
        _spec_of, JT.escn_param_shardings(ep, ecfg, jmesh)),
        is_leaf=lambda x: isinstance(x, tuple))
    mesh = Mesh({"data": 4, "model": 1, "expert": 2}, g, g, g)
    got = spec_leaves(T.escn_param_shardings(
        tp, ESCN_CONFIGS["escn-test"], mesh))
    assert got == [tuple(s) for s in want]
    assert ("expert", None, None) in got


def test_uneven_batch_is_refused():
    """A batch that does not divide the data axis is refused, never
    padded by repeating a structure (it would weigh twice)."""
    d = SpatialGroup(0, 2, torch.device("cpu"), "gloo")
    m = SpatialGroup(0, 1, torch.device("cpu"), "gloo")
    mesh = Mesh({"data": 2, "model": 1}, d, m)
    cfg = ModelConfig(**SMALL)
    _, jp = jax_painn()
    opt = T.adam(1e-3)
    params = port_of(jp)
    step, params, state = T.make_sharded_train_step(cfg, opt, mesh, params,
                                                    opt.init(params))
    with pytest.raises(ValueError, match="never padded"):
        step(params, state, torch_batch(np_batch(1, B=3)))


@pytest.mark.parametrize("cfg,refused", [
    (ModelConfig(mp_mode="pallas", **SMALL), True),
    (ModelConfig(mp_mode="dense", **SMALL), False),
    (ESCN_CONFIGS["escn-test"], True),
    (dataclasses.replace(ESCN_CONFIGS["escn-test"], edge_kernel="xla"),
     False)], ids=["pallas", "dense", "pallas-mega", "xla"])
def test_kernel_configurations_refused_on_the_card(cfg, refused):
    """On the card a kernel configuration is refused before anything
    launches, naming the plain configuration; the CPU runs every
    configuration on its plain versions."""
    T.check_trainable(cfg, "cpu")
    if refused:
        with pytest.raises(RuntimeError, match="mp_mode=|edge_kernel="):
            T.check_trainable(cfg, "cuda")
    else:
        T.check_trainable(cfg, "cuda")


def test_random_batch_layout():
    gen = torch.Generator().manual_seed(0)
    b = T.random_batch(gen, None, batch=4, n_atoms=5, n_pad=8)
    assert b.coords.shape == (4, 8, 3) and b.energy.shape == (4,)
    assert (b.numbers[:, 5:] == 0).all() and (b.numbers[:, :5] > 0).all()
    assert (b.coords[:, 5:] == 0).all() and (b.forces[:, 5:] == 0).all()
    again = T.random_batch(torch.Generator().manual_seed(0), None, 4, 5, 8)
    assert all(torch.equal(x, y) for x, y in zip(b, again))
