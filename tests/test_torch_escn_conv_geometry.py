"""The offsets and operand orientations the eSCN edge kernels' conv
products read, pinned on the CPU.

``_geo`` mirrors ``make_geo`` of ``pdb2reaction_tpu_torch/csrc/escn_edge.cu``
(column of each |m| block in the conv-1 input ``abuf`` / its cotangent
``gpr``, in ``msg`` / ``act`` and in the conv-2 output, and the offset of
each block in the flat weight packs). With it, conv 1 -> S2 activation ->
conv 2 runs as plain products on the kernels' own layouts: the forward
reads each block's input columns out of ``abuf`` (``Dtot`` columns, the
edge scalars after the m0 rows) and multiplies by the k-contiguous
transposed packs, as the tensor-core GEMM does; the backward multiplies by
the untransposed packs into the ``gpr`` layout. Both are held to
``_chain_plain`` and its autograd VJP in float64. A mirror whose m > 0
blocks read ``Ce`` columns too early must fail.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS, _edge_grid_tables

F64 = torch.float64
CASES = {"escn-test": {},
         "escn-md-narrow": dict(sphere_channels=16, hidden_channels=16,
                                edge_channels=8)}


def _cfg(case):
    base = "escn-md" if case.startswith("escn-md") else case
    return dataclasses.replace(ESCN_CONFIGS[base], **CASES[case])


def _geo(C, H, Ce, lmax, mmax, es_shift=True):
    """make_geo in Python: per |m| block b, its rows of the reduced basis,
    conv-1 input width, columns in abuf (in_col), msg (hid_col) and the
    conv-2 output (out_col), and its offsets in the flat packs.
    ``es_shift=False`` leaves the edge scalars out of the m > 0 blocks'
    columns (the fault the tests must catch)."""
    nl0 = lmax + 1
    g = {k: [] for k in ("nl", "inC", "in_col", "hid_col", "out_col",
                         "w1_off", "b1_off", "w2_off", "b2_off")}
    in_col = hid = out = w1 = b1 = w2 = b2 = 0
    for b in range(mmax + 1):
        rows = nl0 if b == 0 else 2 * (lmax + 1 - b)
        inC = rows * 2 * C + (Ce if b == 0 else 0)
        for k, v in zip(g, (rows, inC, in_col, hid, out, w1, b1, w2, b2)):
            g[k].append(v)
        in_col += inC if (b > 0 or es_shift) else rows * 2 * C
        hid += rows * H
        out += rows * C
        w1 += inC * rows * H
        b1 += rows * H
        w2 += rows * H * rows * C
        b2 += rows * C
    g["U"] = sum(g["nl"])
    return g


def _inputs(cfg, E, seed):
    nl0, nls, U, G = ek._dims(cfg)
    C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    rng = np.random.default_rng(seed)

    def f(*s, scale=0.3):
        # f32-exact values: the wrapper's packs are float32
        return torch.as_tensor((rng.normal(size=s) * scale).astype(np.float32),
                               dtype=F64)

    w = (f(nl0 * 2 * C + Ce, nl0 * H), tuple(f(nl * 2 * C, nl * H)
                                             for nl in nls),
         tuple(f(nl * 2 * C, nl * H) for nl in nls), f(nl0 * H),
         tuple(f(nl * H) for nl in nls), tuple(f(nl * H) for nl in nls),
         f(nl0 * H, nl0 * C), tuple(f(nl * H, nl * C) for nl in nls),
         tuple(f(nl * H, nl * C) for nl in nls), f(nl0 * C),
         tuple(f(nl * C) for nl in nls), tuple(f(nl * C) for nl in nls))
    tg, fg = _edge_grid_tables(cfg.lmax, cfg.mmax)
    tabs = (torch.as_tensor(tg, dtype=F64), torch.as_tensor(fg, dtype=F64))
    return w, tabs, f(E, U, 2 * C, scale=1.0), f(E, Ce, scale=1.0), \
        f(E, U, C, scale=1.0)


def _packs(w):
    """The wrapper's flat packs, in float64."""
    return [t.double() for t in ek._pack_weights(w)]


def _forward_on_layouts(cfg, geo, w, tabs, pr, es):
    """abuf -> conv 1 (transposed pack) -> S2 -> conv 2 (transposed pack),
    each block at the mirror's offsets; returns [E, U, C] and msg."""
    C, H = cfg.sphere_channels, cfg.hidden_channels
    E, U, nl0 = pr.shape[0], geo["U"], cfg.lmax + 1
    w1, b1, w2, b2, w1t, w2t = _packs(w)
    abuf = torch.cat([pr[:, :nl0].reshape(E, -1), es,
                      pr[:, nl0:].reshape(E, -1)], 1)
    msg = pr.new_zeros(E, U * H)
    out = pr.new_zeros(E, U * C)
    for b, nl in enumerate(geo["nl"]):
        inC, n1, n2 = geo["inC"][b], nl * H, nl * C
        Bt = w1t[geo["w1_off"][b]:geo["w1_off"][b] + n1 * inC].view(n1, inC)
        a = abuf[:, geo["in_col"][b]:geo["in_col"][b] + inC]
        msg[:, geo["hid_col"][b]:geo["hid_col"][b] + n1] = \
            a @ Bt.T + b1[geo["b1_off"][b]:geo["b1_off"][b] + n1]
    act = ek.s2_act_plain(msg.view(E, U, H), *tabs).reshape(E, U * H)
    for b, nl in enumerate(geo["nl"]):
        n1, n2 = nl * H, nl * C
        Bt = w2t[geo["w2_off"][b]:geo["w2_off"][b] + n2 * n1].view(n2, n1)
        out[:, geo["out_col"][b]:geo["out_col"][b] + n2] = \
            act[:, geo["hid_col"][b]:geo["hid_col"][b] + n1] @ Bt.T \
            + b2[geo["b2_off"][b]:geo["b2_off"][b] + n2]
    return out.view(E, U, C), msg


def _backward_on_layouts(cfg, geo, w, tabs, msg, gout):
    """conv2^T (untransposed pack) -> S2 VJP -> conv1^T (untransposed pack)
    into the gpr layout; returns the cotangents of pr [E, U, 2C] and es."""
    C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    E, U, nl0 = gout.shape[0], geo["U"], cfg.lmax + 1
    w1, b1, w2, b2, w1t, w2t = _packs(w)
    go = gout.reshape(E, U * C)
    gact = go.new_zeros(E, U * H)
    for b, nl in enumerate(geo["nl"]):
        n1, n2 = nl * H, nl * C
        Bt = w2[geo["w2_off"][b]:geo["w2_off"][b] + n1 * n2].view(n1, n2)
        gact[:, geo["hid_col"][b]:geo["hid_col"][b] + n1] = \
            go[:, geo["out_col"][b]:geo["out_col"][b] + n2] @ Bt.T
    m = msg.view(E, U, H).detach().requires_grad_(True)
    (gmsg,) = torch.autograd.grad(ek.s2_act_plain(m, *tabs), [m],
                                  gact.view(E, U, H))
    gmsg = gmsg.reshape(E, U * H)
    gpr = go.new_zeros(E, U * 2 * C + Ce)
    for b, nl in enumerate(geo["nl"]):
        inC, n1 = geo["inC"][b], nl * H
        Bt = w1[geo["w1_off"][b]:geo["w1_off"][b] + inC * n1].view(inC, n1)
        gpr[:, geo["in_col"][b]:geo["in_col"][b] + inC] = \
            gmsg[:, geo["hid_col"][b]:geo["hid_col"][b] + n1] @ Bt.T
    w0 = nl0 * 2 * C
    g_pr = torch.cat([gpr[:, :w0], gpr[:, w0 + Ce:]], 1).view(E, U, 2 * C)
    return g_pr, gpr[:, w0:w0 + Ce]


def _errors(case, es_shift=True):
    """max |mirror - _chain_plain| of the forward and of the VJP (pr, es),
    relative to the largest reference value."""
    cfg = _cfg(case)
    nl0, nls, U, G = ek._dims(cfg)
    geo = _geo(cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels,
               cfg.lmax, cfg.mmax, es_shift)
    assert geo["U"] == U
    w, tabs, pr, es, gout = _inputs(cfg, E=37, seed=3)
    prl, esl = pr.clone().requires_grad_(True), es.clone().requires_grad_(True)
    ref = ek._chain_plain(prl, esl, w, tabs, nl0, nls)
    ref_g = torch.autograd.grad(ref, [prl, esl], gout)
    out, msg = _forward_on_layouts(cfg, geo, w, tabs, pr, es)
    got_g = _backward_on_layouts(cfg, geo, w, tabs, msg, gout)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(out, ref.detach()), max(rel(a, b) for a, b in zip(got_g, ref_g))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_kernel_layouts_match_chain_plain(case, direction):
    e_fwd, e_bwd = _errors(case)
    assert (e_fwd if direction == "forward" else e_bwd) <= 1e-12


@pytest.mark.parametrize("case", list(CASES))
def test_misplaced_blocks_fail(case):
    """A mirror whose m > 0 blocks read their abuf columns Ce too early
    (the edge scalars left out of the offsets) is caught both ways."""
    e_fwd, e_bwd = _errors(case, es_shift=False)
    assert e_fwd > 1e-3 and e_bwd > 1e-3


def test_geo_matches_the_packs_and_dims():
    """The mirror's widths add up to the wrapper's flat packs and to the
    kernels' Dtot = U * 2C + Ce, at escn-md's full widths too, and every
    offset is a multiple of 4 floats."""
    for cfg in (_cfg("escn-test"), _cfg("escn-md-narrow"),
                ESCN_CONFIGS["escn-md"]):
        C, H, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
        geo = _geo(C, H, Ce, cfg.lmax, cfg.mmax)
        nl0, nls, U, G = ek._dims(cfg)
        last = len(geo["nl"]) - 1
        assert geo["in_col"][last] + geo["inC"][last] == U * 2 * C + Ce
        assert geo["in_col"][1] == nl0 * 2 * C + Ce
        n_w1 = sum(i * n * H for i, n in zip(geo["inC"], geo["nl"]))
        n_w2 = sum(n * H * n * C for n in geo["nl"])
        w1, b1, w2, b2, w1t, w2t = _packs(_inputs(cfg, E=1, seed=0)[0])
        assert (w1.numel(), w1t.numel(), w2.numel()) == (n_w1, n_w1, n_w2)
        assert b1.numel() == U * H and b2.numel() == U * C
        # every offset the 16-byte copies take is a multiple of 4 floats
        for k in ("in_col", "hid_col", "out_col", "w1_off", "w2_off",
                  "b1_off", "b2_off"):
            assert all(v % 4 == 0 for v in geo[k]), k
