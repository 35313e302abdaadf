"""Weight cotangents of the eSCN kernels K1, K3, K4 and K2 on the CPU.

- The plain versions' cotangents of every weight (the conv 1 and conv 2
  blocks and biases of K1 / K3 / K4, W1, b1, W2 and b2 of K2) against
  ``jax.vjp`` of the JAX package's kernel entries in interpret mode at
  escn-test widths, on the same weights: within 1e-5 of each leaf's
  max|g|. The JAX kernels' ``custom_vjp`` rules give them by an XLA
  replay of the chain; the port's CUDA backwards replay the plain
  versions, which is what this holds to JAX.
- The CUDA autograd functions' replay itself (``_save`` /
  ``_weight_cotangents``, which run inside their backwards on the card)
  on CPU tensors against autograd through the plain version, with only
  some weights asking for a cotangent; nothing is saved or replayed when
  no weight does. The CUDA kernels are held to the plain versions, weight
  cotangents included, by ``tests/test_torch_gpu.py`` on a card.
"""

import types

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_block as j_fused_edge_block
from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_chain as j_fused_edge_chain
from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_mega as j_fused_edge_mega
from pdb2reaction_tpu.mlip.escn_ffn_kernel import \
    fused_node_ffn as j_fused_node_ffn
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS as TCFG

from test_torch_escn_edge_variants import _block_inputs, _chain_inputs
from test_torch_escn_kernels import (_edge_inputs, _ffn_inputs,
                                     _jax_weights, _torch_weights)

TOL = 1e-5
P = 64          # escn-test, two forward tiles of the JAX kernel


def _mega_inputs(seed):
    jcfg, tcfg, w, (x, src, es, dp, dpe), tabs, g = _edge_inputs(
        "escn-test", {}, P, seed)
    return jcfg, tcfg, w, (x, src, es, dp, dpe), tabs, g


CASES = {
    "K1": (_mega_inputs, j_fused_edge_mega, ek.fused_edge_mega),
    "K3": (lambda s: _block_inputs("escn-test", {}, P, s),
           j_fused_edge_block, ek.fused_edge_block),
    "K4": (lambda s: _chain_inputs("escn-test", {}, P, s),
           j_fused_edge_chain, ek.fused_edge_chain),
}


def _j_args(kind, ins):
    if kind == "K1":           # the JAX entry takes the source as floats
        x, src, es, dp, dpe = ins
        return (jnp.asarray(x), jnp.asarray(src, jnp.float32),
                *(jnp.asarray(a) for a in (es, dp, dpe)))
    return tuple(jnp.asarray(a) for a in ins)


def _t_args(ins):
    return tuple(torch.as_tensor(a) for a in ins)


def _close_leaves(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("kind", ["K1", "K3", "K4", "K2"])
def test_weight_cotangents_match_jax_interpret(kind):
    if kind == "K2":
        x, w, tab, ct = _ffn_inputs(11)
        tj = tuple(jnp.asarray(a) for a in tab)
        _, vjp = jax.vjp(lambda ww: j_fused_node_ffn(JCFG["escn-test"],
                                                     jnp.asarray(x), ww, tj),
                         tuple(jnp.asarray(a) for a in w))
        ref = jtu.tree_leaves(vjp(jnp.asarray(ct))[0])
        wt = [torch.tensor(a, requires_grad=True) for a in w]
        y = fk.fused_node_ffn(TCFG["escn-test"], torch.as_tensor(x), wt,
                              tuple(torch.as_tensor(a) for a in tab))
        _close_leaves(torch.autograd.grad(y, wt, torch.as_tensor(ct)), ref)
        return
    make, j_fn, t_fn = CASES[kind]
    jcfg, tcfg, w, ins, tabs, g = make(13)
    tab_j = tuple(jnp.asarray(t, jnp.float32) for t in tabs)
    jargs = _j_args(kind, ins)
    _, vjp = jax.vjp(lambda ww: j_fn(jcfg, *jargs, ww, tab_j),
                     _jax_weights(w))
    ref = jtu.tree_leaves(vjp(jnp.asarray(g))[0])
    flat = [torch.tensor(a, requires_grad=True)
            for a in ek._flat_weights(w)]
    y = t_fn(tcfg, *_t_args(ins), ek._unflat_weights(flat),
             tuple(torch.as_tensor(t, dtype=torch.float32) for t in tabs))
    _close_leaves(torch.autograd.grad(y, flat, torch.as_tensor(g)), ref)


class _Ctx(types.SimpleNamespace):
    def save_for_backward(self, *ts):
        self.saved_tensors = ts


@pytest.mark.parametrize("kind", ["K1", "K3", "K4"])
def test_edge_replay_gives_the_plain_cotangents(kind):
    """``_save`` + ``_weight_cotangents`` as the CUDA backwards call them:
    every second weight asks for a cotangent; they equal autograd's
    through the plain version bit for bit, the others are None."""
    make = CASES[kind][0]
    _, cfg, w, ins, tabs, g = make(17)
    plain = {"K1": ek.fused_edge_mega_plain, "K3": ek.fused_edge_block_plain,
             "K4": ek.fused_edge_chain_plain}[kind]
    args = _t_args(ins)
    tt = tuple(torch.as_tensor(t, dtype=torch.float32) for t in tabs)
    flat = ek._flat_weights(_torch_weights(w))
    needs = [i % 2 == 0 for i in range(len(flat))]
    lv = [f.clone().requires_grad_(n) for f, n in zip(flat, needs)]
    want = torch.autograd.grad(
        plain(cfg, *args, ek._unflat_weights(lv), tt),
        [f for f in lv if f.requires_grad], torch.as_tensor(g))
    n_in = 1 + len(args) + len(tt)             # (cfg, inputs, tables)
    ctx = _Ctx(cfg=cfg, n_w=len(flat),
               needs_input_grad=(False,) * n_in + tuple(needs))
    kernel_saved = (torch.zeros(1),) * 3       # the kernel's own buffers
    ek._save(ctx, kernel_saved, (*args, *tt, *flat))
    got = ek._weight_cotangents(ctx, plain, torch.as_tensor(g))
    assert [x is None for x in got] == [not n for n in needs]
    for a, b in zip([x for x in got if x is not None], want):
        assert torch.equal(a, b)
    # no weight asks: nothing is saved for a replay, nothing replayed
    ctx = _Ctx(cfg=cfg, n_w=len(flat), needs_input_grad=(True,) * n_in
               + (False,) * len(flat))
    ek._save(ctx, kernel_saved, (*args, *tt, *flat))
    assert len(ctx.saved_tensors) == len(kernel_saved)
    assert ek._weight_cotangents(ctx, plain, None) == (None,) * len(flat)


def test_ffn_replay_gives_the_plain_cotangents():
    """K2's ``_weight_cotangents`` on the tensors ``_FfnFn`` saves: W1
    and W2 ask, b1 and b2 do not."""
    x, w, tab, ct = _ffn_inputs(19)
    x, ct = torch.as_tensor(x), torch.as_tensor(ct)
    w = [torch.as_tensor(a) for a in w]
    tab = [torch.as_tensor(a) for a in tab]
    needs = (True, False, True, False)
    lv = [t.clone().requires_grad_(n) for t, n in zip(w, needs)]
    want = torch.autograd.grad(fk.ffn_plain(x, lv, tab),
                               [lv[0], lv[2]], ct)
    ops = fk.route_operands(w, tab)
    ctx = types.SimpleNamespace(
        need_w=True, needs_input_grad=(True, *needs, False, False),
        saved_tensors=(fk.node_cols(x, ops.tgp.shape[1]), *ops, x, *w,
                       *tab))
    got = fk._weight_cotangents(ctx, ct)
    assert got[1] is None and got[3] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[1])
