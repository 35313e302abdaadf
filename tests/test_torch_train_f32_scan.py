"""How far float32 gradients of the PaiNN-class fit loss stray from the
float64 ones, in the port and in the JAX package, over many batches.

A CPU script behind the float32 figures that PERF.md quotes for the
port's ``batched_loss``; it holds no test, so pytest collects nothing
here. For
each seed it builds ``np_batch(seed)`` of ``tests/test_torch_train.py``
(JAX tests/test_train.py's configuration), takes the loss gradient in
float32 in both packages (JAX with x64 off) and in float64 in JAX, and
prints each float32 gradient's largest leaf error against the float64
one, relative to that leaf's max|g|, the port's against JAX's, and the
port's with JAX's float32 ``vv = v @ upd_vv`` fed into its update blocks
(``tests/test_torch_train_f32.py``). Over seeds 0-39 (a CPU run): median
2.19e-5 for JAX, 2.77e-5 for the port, above 1e-4 in 5 and 9 batches,
the port the further in 28; with JAX's vv fed, the port's median 2.48e-5,
above 1e-4 in 5, above 2x JAX's own error in none. So the difference is
that op's float32 value, which XLA's fused CPU program rounds otherwise
than eager PyTorch. ``--probe SEED`` instead shows why one batch strays:
the smallest
|vv| of a real atom's channel in each layer's update block (its norm is
sqrt(|vv|^2 + 1e-8)), and how far the float64 gradient moves when the
float64 coordinates move by 6e-8 relative (float32 rounding; three
seeded moves).

    JAX_PLATFORMS=cpu python tests/test_torch_train_f32_scan.py [first] [end]
    JAX_PLATFORMS=cpu python tests/test_torch_train_f32_scan.py --probe 4
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from test_torch_train import (JT, SMALL, T, ModelConfig,  # noqa: E402
                              jax32, jax_batch, jax_painn, np_batch,
                              port_grads, port_of, rel_leaf_err,
                              torch_batch)


def main(first=0, end=40):
    import pytest

    from test_torch_train_f32 import fed_error, make_programs
    jax.config.update("jax_enable_x64", True)
    programs = make_programs()
    jcfg, jp = jax_painn("dense")
    vg = jax.jit(jax.value_and_grad(JT.batched_loss), static_argnums=2)
    cfg64 = dataclasses.replace(jcfg, dtype=jnp.float64)
    jp64 = jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.asarray(a).dtype.kind == "f" else a, jp)
    tcfg = ModelConfig(**SMALL)
    rows = []
    for seed in range(first, end):
        b = np_batch(seed)
        b64 = [a.astype(np.float64) if a.dtype.kind == "f" else a
               for a in b]
        _, g64 = vg(jp64, jax_batch(b64), cfg64)
        _, gj = jax32(vg, jp, jax_batch(b), jcfg)
        _, gt = port_grads(lambda p: T.batched_loss(p, torch_batch(b),
                                                    tcfg), port_of(jp))
        g64, gj = jtu.tree_leaves(g64), jtu.tree_leaves(gj)
        gt = [g.numpy() for g in gt]
        with pytest.MonkeyPatch.context() as mp:
            fed = fed_error(programs, seed, mp)[1]
        rows.append((seed, rel_leaf_err(gj, g64), rel_leaf_err(gt, g64),
                     rel_leaf_err(gt, gj), fed))
        print("seed %d  jax32-f64 %.2e  port32-f64 %.2e  port32-jax32 %.2e"
              "  port32(jax vv)-f64 %.2e" % rows[-1], flush=True)
    r = np.array(rows)
    print("batches %d; median jax32-f64 %.2e, port32-f64 %.2e; "
          "above 1e-4: jax32-f64 %d, port32-f64 %d, port32-jax32 %d; "
          "port32 further from f64 than jax32 in %d; with JAX's vv fed "
          "(tests/test_torch_train_f32.py): median %.2e, above 1e-4 %d, "
          "above 2x jax32-f64 %d"
          % (len(r), np.median(r[:, 1]), np.median(r[:, 2]),
             (r[:, 1] > 1e-4).sum(), (r[:, 2] > 1e-4).sum(),
             (r[:, 3] > 1e-4).sum(), (r[:, 2] > r[:, 1]).sum(),
             np.median(r[:, 4]), (r[:, 4] > 1e-4).sum(),
             (r[:, 4] > 2 * r[:, 1]).sum()))


def probe(seed):
    import torch

    from pdb2reaction_tpu_torch.mlip import model as M
    _, jp = jax_painn("dense")
    p64 = jtu.tree_map(lambda t: t.double() if t.is_floating_point() else t,
                       port_of(jp))
    cfg = ModelConfig(dtype=torch.float64, **SMALL)
    b = np_batch(seed)
    b64 = [a.astype(np.float64) if a.dtype.kind == "f" else a for a in b]
    seen = []
    update = M._update_block

    def recording(lp, s, v, mask):
        vv = v @ lp["upd_vv"]
        norm = torch.sqrt((vv * vv).sum(1))[mask > 0]
        seen.append(float(norm.min()))
        return update(lp, s, v, mask)
    M._update_block = recording
    try:
        with torch.no_grad():
            for k in range(b[0].shape[0]):
                seen.clear()
                c = torch.as_tensor(b64[1][k])
                m = torch.as_tensor(b64[2][k])
                M.energy_fn(c, T._system_of(torch.as_tensor(b[0][k]), c, m),
                            p64, cfg)
                print("structure %d: min |vv| over real atoms' channels by "
                      "layer %s" % (k, ["%.3e" % x for x in seen]))
    finally:
        M._update_block = update

    def grads(coords):
        bb = list(b64)
        bb[1] = coords
        _, g = port_grads(lambda p: T.batched_loss(
            p, T.TrainBatch(*(torch.as_tensor(a) for a in bb)), cfg), p64)
        return [x.numpy() for x in g]
    g0 = grads(b64[1])
    rng = np.random.default_rng(0)
    for t in range(3):
        g1 = grads(b64[1] * (1 + 6e-8 * rng.standard_normal(b64[1].shape)))
        print("move %d of the coordinates by 6e-8 relative: the float64 "
              "gradient moves by %.2e of max|g| (largest leaf)"
              % (t, rel_leaf_err(g1, g0)))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe(int(sys.argv[2]))
    else:
        main(*(int(a) for a in sys.argv[1:3]))
