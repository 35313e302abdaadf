"""K2's route on the CPU: the launches of ``csrc/escn_ffn.cu`` in plain
PyTorch, on the operands the wrapper builds for them.

``ffn_route_plain`` / ``ffn_route_vjp_plain`` mirror ``k2_fwd`` /
``k2_bwd`` GEMM by GEMM: the (node, grid point) rows in (g, p) order, M
padded to a multiple of 4 with zero columns in both operands of the table
products, the forward's products by W1^T and W2^T, the backward's by W1
and W2 as stored, the activations in the GEMMs' epilogues, and the sums
over g back to the nodes (``grid_sum_plain``). They are held to
``ffn_plain`` and its autograd VJP in float64 (1e-12 of max|ref|), and to
the JAX package's ``fused_node_ffn`` in interpret mode, which multiplies
in f32 (1e-5, the JAX repo's kernel tolerance). Mirrors with non-zero
padding columns, or with a weight read in the other orientation, must
fail. The CUDA kernels are held to ``ffn_plain`` by
``test_torch_gpu.py`` on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn_ffn_kernel import \
    fused_node_ffn as j_fused_node_ffn
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS
from pdb2reaction_tpu_torch.mlip.so3 import s2_grid_tables

F64 = torch.float64
# (config, overrides, P): escn-md's tables (M = 25, G = 460) at narrow
# widths, and escn-test (M = 9, G = 180); P odd, G*P not a multiple of 128
CASES = {"escn-md-narrow": ("escn-md", dict(sphere_channels=32,
                                             ffn_hidden=64), 13),
         "escn-test": ("escn-test", {}, 13)}


def _inputs(case, seed=3):
    """f32-exact numpy inputs: x, (W1, b1, W2, b2), (tg, fg), cotangent."""
    name, over, P = CASES[case]
    cfg = dataclasses.replace(ESCN_CONFIGS[name], **over)
    C, H = cfg.sphere_channels, cfg.ffn_hidden
    tg, fg = (t.astype(np.float32) for t in s2_grid_tables(cfg.lmax,
                                                           *cfg.grid))
    M = tg.shape[1]
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.3):
        return (rng.normal(size=s) * scale).astype(np.float32)

    w = (f(C, H), f(H, scale=0.1), f(H, C), f(C, scale=0.1))
    return f(P, M, C, scale=1.0), w, (tg, fg), f(P, M, C, scale=1.0)


def _t64(arrs):
    return tuple(torch.as_tensor(a, dtype=F64) for a in arrs)


def _route_and_plain(case, o=None):
    """(route fwd, route cotangent, plain fwd, plain cotangent), f64."""
    x, w, tab, g = _inputs(case)
    x, g = torch.as_tensor(x, dtype=F64), torch.as_tensor(g, dtype=F64)
    w, tab = _t64(w), _t64(tab)
    o = fk.route_operands(w, tab) if o is None else o(w, tab)
    xv = x.clone().requires_grad_(True)
    y = fk.ffn_plain(xv, w, tab)
    (gx,) = torch.autograd.grad(y, [xv], g)
    return (fk.ffn_route_plain(x, o), fk.ffn_route_vjp_plain(x, g, o),
            y.detach(), gx)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1.0))


@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_ffn_plain_f64(case):
    yr, gr, yp, gp = _route_and_plain(case)
    assert yr.shape == yp.shape and gr.shape == gp.shape
    assert _rel(yr, yp) < 1e-12
    assert _rel(gr, gp) < 1e-12


@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_jax_interpret(case):
    x, w, tab, g = _inputs(case)
    wj = tuple(jnp.asarray(a) for a in w)
    tj = tuple(jnp.asarray(a) for a in tab)
    y_j, vjp = jax.vjp(lambda xx: j_fused_node_ffn(JCFG["escn-test"], xx,
                                                   wj, tj), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    o = fk.route_operands(_t64(w), _t64(tab))
    xt, gt = torch.as_tensor(x, dtype=F64), torch.as_tensor(g, dtype=F64)
    for got, ref in ((fk.ffn_route_plain(xt, o), y_j),
                     (fk.ffn_route_vjp_plain(xt, gt, o), gx_j)):
        ref = torch.as_tensor(np.array(ref), dtype=F64)
        assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_route_operands_layout(case):
    """Zero padding columns in both table operands and in the node
    columns; x[p, m, c] at row p*C + c, column m; weights in both
    orientations."""
    x, w, tab, _ = _inputs(case)
    P, M, C = x.shape
    o = fk.route_operands(_t64(w), _t64(tab))
    Mp = o.tgp.shape[1]
    assert Mp % 4 == 0 and M < Mp < M + 4
    xc = fk.node_cols(torch.as_tensor(x, dtype=F64), Mp)
    assert xc.shape == (P * C, Mp)
    for t in (o.tgp, o.fgtp, xc):
        assert torch.count_nonzero(t[:, M:]) == 0
    assert torch.equal(o.tgp[:, :M], torch.as_tensor(tab[0], dtype=F64))
    assert torch.equal(o.fgtp[:, :M], torch.as_tensor(tab[1].T, dtype=F64))
    p, m, c = P - 1, M - 1, 5
    assert float(xc[p * C + c, m]) == float(x[p, m, c])
    assert torch.equal(o.w1t, torch.as_tensor(w[0].T, dtype=F64))
    assert torch.equal(o.w2t, torch.as_tensor(w[2].T, dtype=F64))
    assert o.w1t.is_contiguous() and o.w2t.is_contiguous()


def test_grid_sum_plain_sums_over_the_grid():
    """The sum over g of a padded table's first M columns times the grid
    rows; the padding columns are never read."""
    rng = np.random.default_rng(0)
    P, C, M, G = 5, 12, 9, 31
    T = torch.as_tensor(rng.normal(size=(G, M)))
    Y = torch.as_tensor(rng.normal(size=(G, P * C)))
    ref = torch.einsum("gm,gpc->pmc", T, Y.reshape(G, P, C))
    Tp = torch.cat([T, torch.full((G, 3), 7.0, dtype=T.dtype)], 1)
    assert _rel(fk.grid_sum_plain(Tp, Y, P, C, M), ref) < 1e-13


@pytest.mark.parametrize("case", list(CASES))
def test_nonzero_padding_mirror_fails(case, monkeypatch):
    """Ones in the padding columns of both table-product operands (the
    fault that cp.async's zero fill would not catch) must show."""
    def pad_ones(t, Mp):
        out = t.new_ones(*t.shape[:-1], Mp)
        out[..., :t.shape[-1]] = t
        return out

    monkeypatch.setattr(fk, "_pad_m", pad_ones)
    yr, gr, yp, gp = _route_and_plain(case)
    assert _rel(yr, yp) > 1e-3
    assert _rel(gr, gp) > 1e-3


def _w1_fwd_untransposed(w, tab):
    o = fk.route_operands(w, tab)
    return o._replace(w1t=o.w1.reshape(o.w1t.shape))


def _w1_bwd_transposed(w, tab):
    o = fk.route_operands(w, tab)
    return o._replace(w1=o.w1t.reshape(o.w1.shape))


@pytest.mark.parametrize("fault", [_w1_fwd_untransposed, _w1_bwd_transposed],
                         ids=["fwd-W1-for-W1T", "bwd-W1T-for-W1"])
@pytest.mark.parametrize("case", list(CASES))
def test_misoriented_weight_mirror_fails(case, fault):
    """W1's memory passed where W1^T belongs (the forward's hidden step),
    or W1^T's where W1 belongs (the backward's dgrid step): the same
    bytes read in the other orientation must show."""
    yr, gr, yp, gp = _route_and_plain(case, o=fault)
    bad = _rel(yr, yp) if fault is _w1_fwd_untransposed else _rel(gr, gp)
    assert bad > 1e-3


def test_cpu_tensors_take_ffn_plain():
    """CPU tensors go to ffn_plain, and no kernel launch is counted."""
    x, w, tab, _ = _inputs("escn-test")
    wt = tuple(torch.as_tensor(a) for a in w)
    tt = tuple(torch.as_tensor(a) for a in tab)
    before = dict(fk.launches)
    y = fk.fused_node_ffn(None, torch.as_tensor(x), wt, tt)
    assert torch.equal(y, fk.ffn_plain(torch.as_tensor(x), wt, tt))
    assert fk.launches == before
