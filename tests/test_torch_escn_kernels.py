"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the JAX kernels run in interpret mode at f32 (``_interpret``,
``_bf``) and the port's wrappers take their plain PyTorch versions (CPU
tensors), so these tests hold the plain versions to the JAX kernels at
the JAX repo's own kernel tolerance (1e-5). The CUDA kernels themselves
are held to the plain versions by ``test_torch_gpu.py`` on a card.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn import _edge_grid_tables as j_edge_tables
from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_mega as j_fused_edge_mega
from pdb2reaction_tpu.mlip.escn_ffn_kernel import \
    fused_node_ffn as j_fused_node_ffn
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS as TCFG
from pdb2reaction_tpu_torch.mlip.escn import _edge_grid_tables

_MD_SMALL = dict(sphere_channels=8, hidden_channels=8, edge_channels=8,
                 ffn_hidden=16, num_layers=2, num_experts=2, route_dim=4,
                 num_gauss=8, max_neighbors=8)
# (name, config overrides, P): md-shape block structure (lmax=4, mmax=2)
# at P=16, and escn-test at P=64 (two forward tiles of the JAX kernel)
EDGE_CASES = [("escn-md", _MD_SMALL, 16), ("escn-test", {}, 64)]


def _edge_inputs(name, over, P, seed):
    jcfg = dataclasses.replace(JCFG[name], **over)
    tcfg = dataclasses.replace(TCFG[name], **over)
    nl0, nls, U, G = ek._dims(tcfg)
    M = (tcfg.lmax + 1) ** 2
    C, h, Ce = (tcfg.sphere_channels, tcfg.hidden_channels,
                tcfg.edge_channels)
    K = tcfg.max_neighbors
    E = P * K
    nnz = len(ek._rot_nz(tcfg.lmax, tcfg.mmax)[0])
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.3):
        return (rng.normal(size=s) * scale).astype(np.float32)

    # 12-tuple of merged conv weights with non-zero biases
    w = (f(nl0 * 2 * C + Ce, nl0 * h), [f(nl * 2 * C, nl * h) for nl in nls],
         [f(nl * 2 * C, nl * h) for nl in nls], f(nl0 * h, scale=0.1),
         [f(nl * h, scale=0.1) for nl in nls],
         [f(nl * h, scale=0.1) for nl in nls],
         f(nl0 * h, nl0 * C), [f(nl * h, nl * C) for nl in nls],
         [f(nl * h, nl * C) for nl in nls], f(nl0 * C, scale=0.1),
         [f(nl * C, scale=0.1) for nl in nls],
         [f(nl * C, scale=0.1) for nl in nls])
    x = f(M * C, P, scale=1.0)
    src = rng.integers(0, P, size=E)
    es = f(Ce, E, scale=1.0)
    dp = f(nnz, E, scale=0.5)
    dpe = f(nnz, E, scale=0.5)
    tg, fg = _edge_grid_tables(tcfg.lmax, tcfg.mmax)
    g = f(M * C, P, scale=1.0)
    return jcfg, tcfg, w, (x, src, es, dp, dpe), (tg, fg), g


def _jax_weights(w):
    return tuple(tuple(jnp.asarray(a) for a in v) if isinstance(v, list)
                 else jnp.asarray(v) for v in w)


def _torch_weights(w, **kw):
    return tuple(tuple(torch.as_tensor(a, **kw) for a in v)
                 if isinstance(v, list) else torch.as_tensor(v, **kw)
                 for v in w)


@pytest.mark.parametrize("name,over,P", EDGE_CASES)
def test_edge_mega_plain_matches_jax_interpret(name, over, P):
    jcfg, tcfg, w, (x, src, es, dp, dpe), (tg, fg), g = _edge_inputs(
        name, over, P, seed=5)
    np.testing.assert_allclose(
        np.asarray(j_edge_tables(jcfg.lmax, jcfg.mmax)[0]), tg, atol=1e-14)
    tab_j = (jnp.asarray(tg, jnp.float32), jnp.asarray(fg, jnp.float32))
    srcf = jnp.asarray(src, jnp.float32)

    def jf(x_, es_, dp_, dpe_):
        return j_fused_edge_mega(jcfg, x_, srcf, es_, dp_, dpe_,
                                 _jax_weights(w), tab_j)

    y_j, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (x, es, dp, dpe)))
    gj = vjp(jnp.asarray(g))

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, es, dp, dpe)]
    y_t = ek.fused_edge_mega(tcfg, leaves[0], torch.as_tensor(src),
                             leaves[1], leaves[2], leaves[3],
                             _torch_weights(w),
                             (torch.as_tensor(tg, dtype=torch.float32),
                              torch.as_tensor(fg, dtype=torch.float32)))
    gt = torch.autograd.grad(y_t, leaves, torch.as_tensor(g))
    scale = max(1.0, float(np.abs(np.asarray(y_j)).max()))
    assert np.abs(y_t.detach().numpy() - np.asarray(y_j)).max() < 1e-5 * scale
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() < 1e-5 * max(1.0, np.abs(b).max())


def _ffn_inputs(seed):
    rng = np.random.default_rng(seed)
    P, M, C, H, G = 11, 9, 8, 16, 30          # odd P: node padding in JAX
    x = rng.normal(size=(P, M, C)).astype(np.float32)
    W1 = (rng.normal(size=(C, H)) * 0.3).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    W2 = (rng.normal(size=(H, C)) * 0.3).astype(np.float32)
    b2 = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    tg = rng.normal(size=(G, M)).astype(np.float32)
    fg = (rng.normal(size=(M, G)) / G).astype(np.float32)
    ct = rng.normal(size=(P, M, C)).astype(np.float32)
    return x, (W1, b1, W2, b2), (tg, fg), ct


def test_node_ffn_plain_matches_jax_interpret():
    x, w, tab, ct = _ffn_inputs(7)
    cfg = JCFG["escn-test"]
    wj = tuple(jnp.asarray(a) for a in w)
    tj = tuple(jnp.asarray(a) for a in tab)
    y_j, vjp = jax.vjp(lambda xx: j_fused_node_ffn(cfg, xx, wj, tj),
                       jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    y_t = fk.fused_node_ffn(TCFG["escn-test"], xt,
                            tuple(torch.as_tensor(a) for a in w),
                            tuple(torch.as_tensor(a) for a in tab))
    (gx_t,) = torch.autograd.grad(y_t, [xt], torch.as_tensor(ct))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors go to the plain version, and no kernel launch is
    counted."""
    _, tcfg, w, (x, src, es, dp, dpe), (tg, fg), _ = _edge_inputs(
        "escn-test", {}, 8, seed=1)
    before = dict(ek.launches)
    wt = _torch_weights(w)
    tabs = (torch.as_tensor(tg, dtype=torch.float32),
            torch.as_tensor(fg, dtype=torch.float32))
    args = (torch.as_tensor(x), torch.as_tensor(src), torch.as_tensor(es),
            torch.as_tensor(dp), torch.as_tensor(dpe))
    y = ek.fused_edge_mega(tcfg, *args, wt, tabs)
    y_p = ek.fused_edge_mega_plain(tcfg, *args, wt, tabs)
    assert torch.equal(y, y_p)
    assert ek.launches == before
