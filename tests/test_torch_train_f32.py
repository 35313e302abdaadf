"""Why the port's float32 gradient of the PaiNN-class fit loss strays
further from float64 than JAX's on some batches: the value of one op.

The update block's ``vv = v @ upd_vv`` enters ``vv_norm = sqrt(sum vv^2
+ 1e-8)``. On ill-conditioned batches some real atoms' channels have
|vv| at or below that 1e-4 floor, where the norm bends sharply, and the
force loss's parameter gradient there moves by up to ~2e-3 of max|g|
when vv moves by float32's rounding (``tests/test_torch_train_f32_scan.py
--probe SEED``). The two packages' float32 vv part by ~1e-6 absolute:
JAX computes it inside XLA's compiled CPU program (fusions, contracted
multiply-adds, reordered reductions), whose rounding eager PyTorch's one
kernel an op cannot reproduce. The JAX package's own code run eagerly, op
by op (``jax.disable_jit``), lands elsewhere too: 3.42e-4 off float64 on
``np_batch(4)`` against its jitted 1.17e-4. Nor is the port's op the less
accurate one: a vv computed in float64 from the port's own float32 v and
rounded once leaves the port's error where it was (6.34e-4 there).

Here JAX's float32 vv is recorded from its own jitted loss gradient
(``jax.debug.callback``; the recorded run's gradient is JAX's bit for
bit), and fed into the port's forward value of that op, the port's
backward left as it is (``vv + (vv_jax - vv).detach()``). The port's
float32 gradient then lands within 2x JAX's own error of float64 (on
``np_batch(4)``: 1.16e-4 against JAX's 1.17e-4, from 6.25e-4 unfed).
So the whole difference is that op's float32 value. Float64 parity
with JAX is held in ``tests/test_torch_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.mlip import model as JM
from pdb2reaction_tpu_torch.mlip import model as M

from test_torch_train import (JT, SMALL, T, ModelConfig, jax32, jax_batch,
                              jax_painn, np_batch, port_grads, port_of,
                              rel_leaf_err, torch_batch)


def make_programs():
    """(cfg, weights, JAX's jitted value_and_grad of the loss, the same
    recording every update block's vv, the record)."""
    jcfg, jp = jax_painn("dense")
    record = []
    update = JM._update_block

    def recording(lp, s, v, mask):
        jax.debug.callback(lambda a: record.append(np.asarray(a)),
                           v @ lp["upd_vv"])
        return update(lp, s, v, mask)

    def vg_of(fn):
        return jax.jit(jax.value_and_grad(fn), static_argnums=2)

    def recorded_loss(params, batch, cfg):
        JM._update_block = recording
        try:
            return JT.batched_loss(params, batch, cfg)
        finally:
            JM._update_block = update

    return (jcfg, jp, vg_of(JT.batched_loss), vg_of(recorded_loss),
            record)


@pytest.fixture(scope="module")
def programs():
    return make_programs()


def fed_error(programs, seed, monkeypatch):
    """(JAX's float32 error, the port's with JAX's vv fed, the match
    gaps), each error the largest leaf's against JAX's float64 gradient
    relative to its max|g|; JAX's gradient recorded and unrecorded
    checked equal."""
    jcfg, jp, vg, vg_rec, record = programs
    b = np_batch(seed)
    g64 = jax64_grads(jcfg, jp, b)
    _, gj = jax32(vg, jp, jax_batch(b), jcfg)
    record.clear()
    _, gj_rec = jax32(vg_rec, jp, jax_batch(b), jcfg)
    jax.effects_barrier()
    gj, gj_rec = jtu.tree_leaves(gj), jtu.tree_leaves(gj_rec)
    # recording leaves JAX's program as it was
    for a, c in zip(gj, gj_rec):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    # one vv a structure and layer
    assert len(record) == b[0].shape[0] * SMALL["n_layers"]
    fed, gaps = port_grads_fed(jp, b, list(record), monkeypatch)
    assert len(gaps) == len(record)
    return rel_leaf_err(gj, g64), rel_leaf_err(fed, g64), gaps, g64


def jax64_grads(jcfg, jp, b):
    b64 = [a.astype(np.float64) if a.dtype.kind == "f" else a for a in b]
    with jax.enable_x64(True):
        jp64 = jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64)
                            if jnp.asarray(a).dtype.kind == "f" else a, jp)
        _, g = jax.jit(jax.value_and_grad(JT.batched_loss),
                       static_argnums=2)(
            jp64, jax_batch(b64),
            dataclasses.replace(jcfg, dtype=jnp.float64))
        return jtu.tree_leaves(g)


def port_grads_fed(jp, b, fed, monkeypatch):
    """The port's float32 gradient with each update block's vv taking the
    value of its nearest recorded JAX vv (the same structure and layer:
    the two differ by ~1e-6, other structures and layers by O(1))."""
    params = port_of(jp)
    upd_vv = {id(lp["upd_vv"]) for lp in params["layers"]}
    mm = M._mm
    gaps = []

    def feeding(x, w):
        out = mm(x, w)
        if id(w) not in upd_vv:
            return out
        own = out.detach().numpy()
        dist = sorted((np.abs(r - own).max(), i) for i, r in enumerate(fed))
        gaps.append((dist[0][0], dist[1][0]))
        return out + (torch.as_tensor(fed[dist[0][1]]) - out).detach()

    monkeypatch.setattr(M, "_mm", feeding)
    # the loss takes its leaves from a copy: match on the copy's leaves
    leaves = [x.detach().requires_grad_(True) for x in T.tree_leaves(params)]
    tree = T._with_leaves(params, leaves)
    upd_vv.clear()
    upd_vv.update(id(lp["upd_vv"]) for lp in tree["layers"])
    loss = T.batched_loss(tree, torch_batch(b), ModelConfig(**SMALL))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.setattr(M, "_mm", mm)
    return [np.zeros(x.shape, np.float32) if g is None else g.numpy()
            for x, g in zip(leaves, grads)], gaps


@pytest.mark.parametrize("seed", [4, 2, 6])
def test_jax_vv_fed_into_the_port_lands_on_jax_error(seed, programs,
                                                    monkeypatch):
    err_jax, err_fed, gaps, g64 = fed_error(programs, seed, monkeypatch)
    # each vv matched unambiguously
    assert max(g[0] for g in gaps) < 1e-4
    assert min(g[1] for g in gaps) > 1e-2
    assert err_fed <= 2.0 * err_jax
    if seed == 4:
        _, jp = programs[:2]
        b = np_batch(seed)
        # the fault as it stands unfed: the port's float32 gradient
        # further from float64 than 2x JAX's
        _, gt = port_grads(lambda p: T.batched_loss(
            p, torch_batch(b), ModelConfig(**SMALL)), port_of(jp))
        assert rel_leaf_err([g.numpy() for g in gt], g64) > 2.0 * err_jax
