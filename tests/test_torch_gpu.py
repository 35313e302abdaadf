"""Card tests of the port: each CUDA kernel against its plain PyTorch
version, and the escn calculator in each edge-kernel layout and the
PaiNN pallas-mode calculator on the card against the CPU plain path.

Every test is marked ``gpu`` and skips without a CUDA card (decided
inside the test). The file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        tests/test_torch_gpu.py -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdb2reaction_tpu_torch.constants import ANG2BOHR
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip import radial_contract as rcm
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS, _edge_grid_tables
from pdb2reaction_tpu_torch.mlip.escn import init_escn_params, tree_to
from pdb2reaction_tpu_torch.mlip.model import CONFIGS, ModelConfig, make_model
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

pytestmark = pytest.mark.gpu
TOL = 1e-4          # max|kernel - plain| / max|plain|: f32 sums reordered
F32 = dict(device="cuda", dtype=torch.float32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _close(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) <= TOL * float(b.abs().max())


def _weight_cotangents_match(kern, plain, cfg, ins, w, tabs, key):
    """Every weight's cotangent through the kernel (its backward replays
    the plain version for them) against autograd through the plain
    version, inputs' cotangents with them; one backward launch; a
    ``create_graph`` backward through the kernel still raises."""
    flat = ek._flat_weights(w)
    g = None
    outs = []
    for fn in (kern, plain):
        lv = [t.clone().requires_grad_(True) for t in ins]
        wv = [t.clone().requires_grad_(True) for t in flat]
        y = fn(cfg, *lv, ek._unflat_weights(wv), tabs)
        if g is None:
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                11)).to(**F32)
        n0 = ek.launches[key]
        outs.append(torch.autograd.grad(y, lv + wv, g))
        if fn is kern:
            assert ek.launches[key] == n0 + 1
    assert len(outs[0]) == len(ins) + len(flat)
    for a, b in zip(*outs):
        assert _close(a, b)
    lv = [t.clone().requires_grad_(True) for t in ins]
    y = kern(cfg, *lv, w, tabs)
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(y, lv, g, create_graph=True)


def _edge_inputs(cfg, P, seed):
    nl0, nls, U, G = ek._dims(cfg)
    M = (cfg.lmax + 1) ** 2
    C, h, Ce = cfg.sphere_channels, cfg.hidden_channels, cfg.edge_channels
    E = P * cfg.max_neighbors
    nnz = len(ek._rot_nz(cfg.lmax, cfg.mmax)[0])
    gen = torch.Generator().manual_seed(seed)

    def f(*s, scale=0.3):
        return (torch.randn(s, generator=gen) * scale).to(**F32)

    w = (f(nl0 * 2 * C + Ce, nl0 * h), tuple(f(nl * 2 * C, nl * h)
                                             for nl in nls),
         tuple(f(nl * 2 * C, nl * h) for nl in nls), f(nl0 * h),
         tuple(f(nl * h) for nl in nls), tuple(f(nl * h) for nl in nls),
         f(nl0 * h, nl0 * C), tuple(f(nl * h, nl * C) for nl in nls),
         tuple(f(nl * h, nl * C) for nl in nls), f(nl0 * C),
         tuple(f(nl * C) for nl in nls), tuple(f(nl * C) for nl in nls))
    tg, fg = _edge_grid_tables(cfg.lmax, cfg.mmax)
    tabs = (torch.as_tensor(tg, **F32), torch.as_tensor(fg, **F32))
    src = torch.randint(0, P, (E,), generator=gen).cuda()
    ins = (f(M * C, P, scale=1.0), f(Ce, E, scale=1.0), f(nnz, E, scale=.5),
           f(nnz, E, scale=.5))
    ins[3][:, ::5] = 0.0        # masked edges: all-zero Dpe columns
    return w, tabs, src, ins, f(M * C, P, scale=1.0)


@pytest.mark.parametrize("name,over,P", [
    ("escn-md", dict(sphere_channels=16, hidden_channels=16,
                     edge_channels=8, max_neighbors=8), 24),
    ("escn-test", {}, 40)])
def test_edge_mega_kernel_matches_plain(name, over, P):
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS[name], **over)
    w, tabs, src, ins, g = _edge_inputs(cfg, P, seed=3)
    n0 = ek.launches["fused_edge_mega_bwd"]
    outs = []
    for fn in (ek.fused_edge_mega, ek.fused_edge_mega_plain):
        lv = [t.clone().requires_grad_(True) for t in ins]
        y = fn(cfg, lv[0], src, lv[1], lv[2], lv[3], w, tabs)
        outs.append([y, *torch.autograd.grad(y, lv, g)])
    for a, b in zip(*outs):
        assert _close(a, b)
    assert ek.launches["fused_edge_mega_bwd"] == n0 + 1
    _weight_cotangents_match(
        lambda c, x, es, dp, dpe, ww, tt: ek.fused_edge_mega(
            c, x, src, es, dp, dpe, ww, tt),
        lambda c, x, es, dp, dpe, ww, tt: ek.fused_edge_mega_plain(
            c, x, src, es, dp, dpe, ww, tt),
        cfg, ins, w, tabs, "fused_edge_mega_bwd")
    with pytest.raises(TypeError):
        ek.fused_edge_mega(cfg, ins[0].double(), src, ins[1], ins[2],
                           ins[3], w, tabs)


# ragged edge counts: E = 23 * 8 = 184 and 37 * 16 = 592, neither a
# multiple of the 128-edge GEMM tile nor of a warp block
VARIANT_CASES = [
    ("escn-md", dict(sphere_channels=16, hidden_channels=16,
                     edge_channels=8, max_neighbors=8), 23),
    ("escn-test", {}, 37)]


def _kernel_vs_plain(kern, plain, cfg, ins, w, tabs, key):
    """Values and every input cotangent of the kernel against its plain
    version; the kernel's backward launch is counted once. Returns the
    kernel's [value, cotangents...] and the output cotangent used."""
    n0 = ek.launches[key]
    outs, g = [], None
    for fn in (kern, plain):
        lv = [t.clone().requires_grad_(True) for t in ins]
        y = fn(cfg, *lv, w, tabs)
        if g is None:
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                9)).to(**F32)
        outs.append([y, *torch.autograd.grad(y, lv, g)])
    torch.cuda.synchronize()
    assert len(outs[0]) == len(ins) + 1
    for a, b in zip(*outs):
        assert _close(a, b)
    assert ek.launches[key] == n0 + 1
    return outs[0], g


@pytest.mark.parametrize("name,over,P", VARIANT_CASES)
def test_edge_block_kernel_matches_plain(name, over, P):
    """K3 at ragged E with masked (all-zero Dpe) edges: values and the
    cotangents of xs, xt, es, Dp and Dpe; a second run repeats bit for
    bit; guards raise."""
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS[name], **over)
    w, tabs, src, (x, es, dp, dpe), _ = _edge_inputs(cfg, P, seed=5)
    xs = x[:, src].contiguous()
    xt = x.repeat_interleave(cfg.max_neighbors, dim=1)
    ins = (xs, xt, es, dp, dpe)
    first, g = _kernel_vs_plain(ek.fused_edge_block,
                                ek.fused_edge_block_plain, cfg, ins, w, tabs,
                                "fused_edge_block_bwd")
    lv = [t.clone().requires_grad_(True) for t in ins]
    y = ek.fused_edge_block(cfg, *lv, w, tabs)
    again = [y, *torch.autograd.grad(y, lv, g)]
    assert all(torch.equal(a, b) for a, b in zip(again, first))
    _weight_cotangents_match(ek.fused_edge_block, ek.fused_edge_block_plain,
                             cfg, ins, w, tabs, "fused_edge_block_bwd")
    with pytest.raises(TypeError):
        ek.fused_edge_block(cfg, xs.double(), *ins[1:], w, tabs)
    with pytest.raises(ValueError):
        ek.fused_edge_block(cfg, xs[:, :-1], *ins[1:], w, tabs)


@pytest.mark.parametrize("name,over,P", VARIANT_CASES)
def test_edge_chain_kernel_matches_plain(name, over, P):
    """K4 at ragged E: values and the cotangents of pr and es; guards
    raise."""
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS[name], **over)
    w, tabs, src, (x, es, dp, dpe), _ = _edge_inputs(cfg, P, seed=6)
    nl0, nls, U, G = ek._dims(cfg)
    gen = torch.Generator().manual_seed(7)
    pr = torch.randn(U * 2 * cfg.sphere_channels, src.numel(),
                     generator=gen).to(**F32)
    _kernel_vs_plain(ek.fused_edge_chain, ek.fused_edge_chain_plain, cfg,
                     (pr, es), w, tabs, "fused_edge_chain_bwd")
    _weight_cotangents_match(ek.fused_edge_chain, ek.fused_edge_chain_plain,
                             cfg, (pr, es), w, tabs, "fused_edge_chain_bwd")
    with pytest.raises(ValueError):
        ek.fused_edge_chain(cfg, pr[:-1], es, w, tabs)


def _edge_kernel_args(kind, cfg, ins, src):
    """(kernel, plain, differentiable inputs, call) of K1, K3 or K4 on the
    inputs of ``_edge_inputs``."""
    x, es, dp, dpe = ins
    if kind == "mega":
        return (ek.fused_edge_mega, ek.fused_edge_mega_plain, (x, es, dp, dpe),
                lambda fn, w, tabs, a, b, c, d: fn(cfg, a, src, b, c, d, w,
                                                   tabs))
    if kind == "block":
        xs = x[:, src].contiguous()
        xt = x.repeat_interleave(cfg.max_neighbors, dim=1)
        return (ek.fused_edge_block, ek.fused_edge_block_plain,
                (xs, xt, es, dp, dpe),
                lambda fn, w, tabs, *a: fn(cfg, *a, w, tabs))
    nl0, nls, U, G = ek._dims(cfg)
    pr = torch.randn(U * 2 * cfg.sphere_channels, src.numel(),
                     generator=torch.Generator().manual_seed(2)).to(**F32)
    return (ek.fused_edge_chain, ek.fused_edge_chain_plain, (pr, es),
            lambda fn, w, tabs, *a: fn(cfg, *a, w, tabs))


EDGE_KINDS = {"mega": "fused_edge_mega", "block": "fused_edge_block",
              "chain": "fused_edge_chain"}
NARROW_MD = dict(sphere_channels=16, hidden_channels=16, edge_channels=8)


@pytest.mark.parametrize("kind", list(EDGE_KINDS))
@pytest.mark.parametrize("name,over", [("escn-test", {}),
                                       ("escn-md", NARROW_MD)])
def test_edge_kernel_ragged_tiles_repeat_bit_for_bit(kind, name, over):
    """K1, K3 and K4 at P = 13, K = 16 (E = 208: a ragged 128-edge tile of
    the conv products; at escn-test also N = 24 / 32 and k = 56 / 64, all
    ragged): values and every input cotangent against the plain version,
    one forward and one backward launch counted per call, and a second
    call equal bit for bit."""
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS[name], max_neighbors=16, **over)
    w, tabs, src, ins, _ = _edge_inputs(cfg, 13, seed=11)
    kern, plain, leaves, call = _edge_kernel_args(kind, cfg, ins, src)
    key = EDGE_KINDS[kind]
    got, g = [], None
    for fn in (kern, plain, kern):
        n0 = dict(ek.launches)
        lv = [t.clone().requires_grad_(True) for t in leaves]
        y = call(fn, w, tabs, *lv)
        if g is None:
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                12)).to(**F32)
        got.append([y.detach(), *torch.autograd.grad(y, lv, g)])
        ran = 1 if fn is kern else 0
        assert ek.launches[f"{key}_fwd"] == n0[f"{key}_fwd"] + ran
        assert ek.launches[f"{key}_bwd"] == n0[f"{key}_bwd"] + ran
    torch.cuda.synchronize()
    for a, b in zip(got[0], got[1]):
        assert _close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[2]))


@pytest.mark.parametrize("kind", list(EDGE_KINDS))
def test_edge_kernel_refuses_misaligned_widths(kind):
    """An edge-channel width that is not a multiple of 4 would put the conv
    products' 16-byte copies off alignment: the wrappers raise."""
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS["escn-test"], edge_channels=6)
    w, tabs, src, ins, _ = _edge_inputs(cfg, 5, seed=13)
    kern, _, leaves, call = _edge_kernel_args(kind, cfg, ins, src)
    with pytest.raises(ValueError, match="multiples of 4"):
        call(kern, w, tabs, *leaves)


def test_gather_src_backward_is_a_deterministic_scatter():
    """The K3/K4 paths' source gather: its backward equals index_add over
    the live edges and repeats bit for bit."""
    _need_card()
    gen = torch.Generator().manual_seed(8)
    P, E, F = 53, 53 * 16, 200
    x = torch.randn(P, F, generator=gen).to(**F32)
    src = torch.randint(0, P, (E,), generator=gen).cuda()
    live = torch.rand(E, generator=gen).cuda() > 0.2
    g = torch.randn(E, F, generator=gen).to(**F32) * live[:, None]
    got = []
    for _ in range(2):
        xv = x.clone().requires_grad_(True)
        y = ek.gather_src(xv, src, live)
        assert torch.equal(y, x[src])
        got.append(torch.autograd.grad(y, [xv], g)[0])
    ref = torch.zeros_like(x).index_add_(0, src, g)
    assert torch.equal(got[0], got[1])
    assert _close(got[0], ref)


def test_node_ffn_kernel_matches_plain():
    _need_card()
    gen = torch.Generator().manual_seed(4)
    P, M, C, H, G = 13, 25, 32, 64, 460

    def f(*s, scale=0.3):
        return (torch.randn(s, generator=gen) * scale).to(**F32)

    w = (f(C, H), f(H, scale=0.1), f(H, C), f(C, scale=0.1))
    tabs = (f(G, M, scale=1.0), f(M, G, scale=1.0 / G))
    x, g = f(P, M, C, scale=1.0), f(P, M, C, scale=1.0)
    outs = []
    for fn in (fk.fused_node_ffn, lambda c, v, ww, tt: fk.ffn_plain(v, ww,
                                                                    tt)):
        xv = x.clone().requires_grad_(True)
        y = fn(None, xv, w, tabs)
        outs.append((y, torch.autograd.grad(y, [xv], g)[0]))
    for a, b in zip(*outs):
        assert _close(a, b)


def test_node_ffn_kernel_weight_cotangents_match_plain():
    """K2's cotangents of W1, b1, W2 and b2 (a replay of ``ffn_plain``
    inside the kernel's backward) and of x against autograd through
    ``ffn_plain``; one backward launch."""
    _need_card()
    x, w, tabs, g = _ffn_inputs(13, 25, 32, 64, 460, seed=8)
    outs = []
    for fn in (fk.fused_node_ffn, lambda c, v, ww, tt: fk.ffn_plain(v, ww,
                                                                    tt)):
        xv = x.clone().requires_grad_(True)
        wv = [t.clone().requires_grad_(True) for t in w]
        n0 = fk.launches["fused_node_ffn_bwd"]
        y = fn(None, xv, wv, tabs)
        outs.append(torch.autograd.grad(y, [xv, *wv], g))
        if fn is fk.fused_node_ffn:
            assert fk.launches["fused_node_ffn_bwd"] == n0 + 1
    for a, b in zip(*outs):
        assert _close(a, b)


def _ffn_inputs(P, M, C, H, G, seed):
    gen = torch.Generator().manual_seed(seed)

    def f(*s, scale=0.3):
        return (torch.randn(s, generator=gen) * scale).to(**F32)

    w = (f(C, H), f(H, scale=0.1), f(H, C), f(C, scale=0.1))
    tabs = (f(G, M, scale=1.0), f(M, G, scale=1.0 / G))
    return f(P, M, C, scale=1.0), w, tabs, f(P, M, C, scale=1.0)


# (P, M, C, H, G): G*P rows ragged against the 128-row GEMM tile (5980,
# 1260, 2300); columns under 128 (C = 32, H = 64; escn-test's 8 and 16)
# and past it (C = 132, H = 260: a ragged second column tile)
FFN_SHAPES = [(13, 25, 32, 64, 460), (7, 9, 8, 16, 180),
              (5, 25, 132, 260, 460)]


@pytest.mark.parametrize("P,M,C,H,G", FFN_SHAPES)
def test_node_ffn_kernel_ragged_repeat_bit_for_bit(P, M, C, H, G):
    """K2 at ragged row and column counts: value and input cotangent
    against the plain version, one forward and one backward launch counted
    per call, and a second call equal bit for bit."""
    _need_card()
    x, w, tabs, g = _ffn_inputs(P, M, C, H, G, seed=14)
    got = []
    for fn in (fk.fused_node_ffn, lambda c, v, ww, tt: fk.ffn_plain(v, ww, tt),
               fk.fused_node_ffn):
        n0 = dict(fk.launches)
        xv = x.clone().requires_grad_(True)
        y = fn(None, xv, w, tabs)
        got.append((y.detach(), torch.autograd.grad(y, [xv], g)[0]))
        ran = 1 if fn is fk.fused_node_ffn else 0
        assert fk.launches["fused_node_ffn_fwd"] == \
            n0["fused_node_ffn_fwd"] + ran
        assert fk.launches["fused_node_ffn_bwd"] == \
            n0["fused_node_ffn_bwd"] + ran
    torch.cuda.synchronize()
    for a, b in zip(got[0], got[1]):
        assert _close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[2]))


@pytest.mark.parametrize("P,M,C,H,match", [
    (5, 25, 30, 64, "multiples of 4"), (5, 25, 32, 62, "multiples of 4"),
    (5, 36, 32, 64, "M <= 32")])
def test_node_ffn_kernel_refuses_unsupported_shapes(P, M, C, H, match):
    """C or H not a multiple of 4 (the GEMM's 16-byte copies) or more than
    32 coefficients a node (grid_sum's accumulators): the wrapper raises,
    and nothing falls back to the plain version."""
    _need_card()
    x, w, tabs, _ = _ffn_inputs(P, M, C, H, 60, seed=15)
    n0 = dict(fk.launches)
    with pytest.raises(ValueError, match=match):
        fk.fused_node_ffn(None, x, w, tabs)
    assert fk.launches == n0


@pytest.mark.parametrize("epi", list(fk.EPI))
def test_conv_tf32_epilogues_match_torch(epi):
    """K2's instantiations of the 3xTF32 GEMM alone, each epilogue, at a
    ragged size (300 rows, 72 columns, k = 36: one full and one ragged
    32-k slice) against the plain product in full f32."""
    _need_card()
    gen = torch.Generator().manual_seed(16)
    rows, n, k = 300, 72, 36
    a = torch.randn(rows, k, generator=gen).to(**F32)
    b = torch.randn(n, k, generator=gen).to(**F32)
    bias = None if epi == "mul" else torch.randn(n, generator=gen).to(**F32)
    c0 = torch.randn(rows, n, generator=gen).to(**F32)
    ref = fk.gemm_plain(a, b, bias, epi, c=c0)
    got = fk.gemm_tf32(a, b, bias, epi, c=c0.clone())
    torch.cuda.synchronize()
    assert _close(got, ref)


@pytest.mark.parametrize("M,Mp", [(25, 28), (9, 12), (32, 32)])
def test_grid_sum_kernel_matches_plain_and_repeats(M, Mp):
    """grid_sum at a ragged column count (P*C = 13 * 36, not a multiple of
    its 32-column blocks) on a padded table whose padding columns hold
    garbage (never read into the output), against the plain sum; two
    launches equal bit for bit."""
    _need_card()
    gen = torch.Generator().manual_seed(17)
    P, C, G = 13, 36, 460
    T = torch.randn(G, Mp, generator=gen).to(**F32)
    Y = torch.randn(G, P * C, generator=gen).to(**F32)
    got = [fk.grid_sum_cuda(T, Y, P, C, M) for _ in range(2)]
    torch.cuda.synchronize()
    assert got[0].shape == (P, M, C)
    assert _close(got[0], fk.grid_sum_plain(T, Y, P, C, M))
    assert torch.equal(got[0], got[1])


EDGE_FN = {"pallas-mega": "fused_edge_mega", "pallas-full": "fused_edge_block",
           "pallas": "fused_edge_chain"}


@pytest.mark.parametrize("edge_kernel", list(EDGE_FN))
def test_calculator_on_card_matches_cpu_f64(edge_kernel):
    """Each edge-kernel layout on the card against the CPU float64 plain
    path: forces within TOL, only that layout's edge kernels launched,
    and a second call repeats the forces bit for bit."""
    _need_card()
    rng = np.random.default_rng(2)
    st = Structure(rng.choice([1, 6, 8], size=20).astype(np.int32),
                   rng.normal(scale=2.0, size=(20, 3)))
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=1)
    gpu = make_uma_calculator(st, model="escn-test", params=w,
                              edge_kernel=edge_kernel)
    cpu = make_uma_calculator(st, model="escn-test", params=w, device="cpu",
                              dtype=torch.float64)
    cb = st.coords_bohr.reshape(-1)
    n0 = dict(ek.launches), dict(fk.launches)
    rg, rc = gpu.get_forces(cb), cpu.get_forces(cb)
    assert np.abs(rg["forces"] - rc["forces"]).max() \
        <= TOL * np.abs(rc["forces"]).max()
    ran = {k for k in ek.launches if ek.launches[k] > n0[0][k]}
    base = EDGE_FN[edge_kernel]
    assert ran == {f"{base}_fwd", f"{base}_bwd"}
    assert all(fk.launches[k] > n0[1][k] for k in fk.launches)
    assert np.array_equal(gpu.get_forces(cb)["forces"], rg["forces"])


def _k5_system(P, system, gen):
    """A jittered 1.8 A lattice with ~10% masked atoms (at the origin),
    in lattice order; "shuffled" permutes it; "blobs" is two such
    lattices 40 A apart, shuffled (tiles of one never reach the other's);
    "masked_tile" masks 64 more atoms, which fill whole plan tiles."""
    n = P // 2 if system == "blobs" else P
    side = round(n ** (1 / 3)) + 1
    grid = torch.stack(torch.meshgrid(*[torch.arange(side)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    coords = grid[:n] * 1.8 + 0.15 * torch.randn(n, 3, generator=gen)
    if system == "blobs":
        coords = torch.cat([coords, coords[:P - n] + 40.0])
    mask = (torch.rand(P, generator=gen) > 0.1).float()
    if system == "masked_tile":
        mask[torch.randperm(P, generator=gen)[:64]] = 0.0
    if system in ("shuffled", "blobs"):
        coords = coords[torch.randperm(P, generator=gen)]
    coords[mask == 0] = 0.0
    return coords.to(**F32), mask.to(**F32)


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("P,F,R,system", [
    (300, 72, 24, "lattice"), (77, 16, 32, "lattice"), (50, 16, 62, "lattice"),
    (300, 72, 24, "shuffled"), (300, 40, 24, "blobs"),
    (300, 16, 24, "masked_tile"), (20, 16, 24, "lattice"),
    (200, 16, 40, "shuffled")])
def test_radial_contract_kernels_match_plain(div_d, P, F, R, system):
    """Ragged atom and feature tiles, masked atoms, atom orders the tile
    plan has to restore (shuffled, two separated blobs), an all-masked
    tile, P < 32, and both tilings of the coordinate gradient (R + 1 <= 32
    on the tensor cores, > 32 on CUDA cores, up to the limit of 63 radial
    channels; 64 is refused). Forward rows and coordinate gradients of
    masked atoms are exactly 0."""
    _need_card()
    gen = torch.Generator().manual_seed(P + R)
    coords, mask = _k5_system(P, system, gen)
    feats = torch.randn(P, F, generator=gen).to(**F32)
    g = torch.randn(P, R + 1, F, generator=gen).to(**F32)
    n0 = dict(rcm.launches)
    outs = []
    for fn in (rcm.radial_contract, rcm.radial_contract_plain):
        c = coords.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = fn(c, mask, f, 6.0, R, div_d)
        outs.append([T, *torch.autograd.grad(T, [c, f], g)])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert _close(a, b)
    assert all(rcm.launches[k] == n0[k] + 1 for k in n0)
    masked = mask == 0
    assert bool((outs[0][0][masked] == 0).all())
    assert bool((outs[0][1][masked] == 0).all())
    # no atomics: a second run repeats every result bit for bit
    c = coords.clone().requires_grad_(True)
    f = feats.clone().requires_grad_(True)
    T = rcm.radial_contract(c, mask, f, 6.0, R, div_d)
    again = [T, *torch.autograd.grad(T, [c, f], g)]
    assert all(torch.equal(a, b) for a, b in zip(again, outs[0]))
    with pytest.raises(TypeError):
        rcm.radial_contract(coords.double(), mask, feats, 6.0, R, div_d)
    with pytest.raises(ValueError):
        rcm.radial_contract(coords, mask, feats[:, :5], 6.0, R, div_d)
    with pytest.raises(ValueError):
        rcm.radial_contract(coords, mask, feats, 6.0, 63, div_d)


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("R", [24, 40])
def test_radial_contract_given_plan_matches_own_plan(div_d, R):
    """A tile plan passed in serves all three kernels: the result and both
    gradients are bitwise those of the call that builds its own plan, no
    plan is built, and a plan of another system size raises. R + 1 = 25
    (tensor cores) and 41 (CUDA cores)."""
    _need_card()
    gen = torch.Generator().manual_seed(R)
    coords, mask = _k5_system(300, "shuffled", gen)
    feats = torch.randn(300, 40, generator=gen).to(**F32)
    g = torch.randn(300, R + 1, 40, generator=gen).to(**F32)
    plan = rcm.tile_plan(coords, mask, 6.0)

    def run(**kw):
        c = coords.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = rcm.radial_contract(c, mask, f, 6.0, R, div_d, **kw)
        return [T, *torch.autograd.grad(T, [c, f], g)]

    own = run()
    built = rcm.plans["built"]
    given = run(plan=plan)
    assert rcm.plans["built"] == built
    assert all(torch.equal(a, b) for a, b in zip(given, own))
    other = rcm.tile_plan(coords[:299], mask[:299], 6.0)
    with pytest.raises(ValueError):
        rcm.radial_contract(coords, mask, feats, 6.0, R, div_d, plan=other)


def test_pallas_force_call_builds_one_tile_plan():
    """A uma-s-1p1 pallas-mode force call builds one tile plan and hands
    it to all of its K5 calls (8 forward, 7 feats-gradient and 8
    coordinate-gradient launches)."""
    _need_card()
    rng = np.random.default_rng(6)
    st = Structure(rng.choice([1, 6, 8], size=96).astype(np.int32),
                   rng.normal(scale=3.0, size=(96, 3)))
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    fn, w, _ = make_model(cfg, seed=3)
    calc = Calculator(st, fn, params=tree_to(w, device="cuda"),
                      device="cuda")
    cb = st.coords_bohr.reshape(-1)
    calc.get_forces(cb)
    built, n0 = rcm.plans["built"], dict(rcm.launches)
    calc.get_forces(cb)
    assert rcm.plans["built"] == built + 1
    assert [rcm.launches[k] - n0[k] for k in n0] == [8, 7, 8]


def test_pallas_calculator_on_card_matches_cpu_f64():
    _need_card()
    rng = np.random.default_rng(5)
    st = Structure(rng.choice([1, 6, 8], size=40).astype(np.int32),
                   rng.normal(scale=2.5, size=(40, 3)))
    cfg = dataclasses.replace(CONFIGS["small"], mp_mode="pallas")
    fn, w, _ = make_model(cfg, seed=2)
    gpu = Calculator(st, fn, params=tree_to(w, device="cuda"),
                     device="cuda")
    cpu = make_uma_calculator(st, model="small", params=w, device="cpu",
                              dtype=torch.float64)
    cb = st.coords_bohr.reshape(-1)
    n0 = dict(rcm.launches)
    rg, rc = gpu.get_forces(cb), cpu.get_forces(cb)
    assert np.abs(rg["forces"] - rc["forces"]).max() \
        <= TOL * np.abs(rc["forces"]).max()
    assert abs(rg["energy"] - rc["energy"]) <= TOL * abs(rc["energy"])
    assert all(rcm.launches[k] > n0[k] for k in n0)


def _rc_system(P, seed):
    """Jittered lattice with ~10% masked atoms (at the origin)."""
    gen = torch.Generator().manual_seed(seed)
    side = round(P ** (1 / 3)) + 1
    grid = torch.stack(torch.meshgrid(*[torch.arange(side)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    coords = (grid[:P] * 1.8 + 0.15 * torch.randn(P, 3, generator=gen))
    mask = (torch.rand(P, generator=gen) > 0.1).float()
    coords[mask == 0] = 0.0
    return coords.to(**F32), mask.to(**F32), gen


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("Pc,Pr,off,F,R,system", [
    (600, 184, 0, 72, 24, "lattice"), (600, 184, 184, 72, 24, "lattice"),
    (600, 184, 416, 16, 24, "lattice"), (300, 184, 116, 16, 40, "lattice"),
    (583, 150, 211, 40, 24, "shuffled"), (583, 150, 300, 40, 32, "lattice"),
    (583, 150, 433, 24, 32, "shuffled"), (600, 184, 100, 40, 24, "blobs"),
    (600, 184, 300, 40, 32, "blobs"),
    (600, 184, 200, 40, 24, "masked_tile")])
def test_radial_contract_rect_kernels_match_plain(div_d, Pc, Pr, off, F, R,
                                                  system):
    """K6 at ragged row blocks (Pr = 184, 150) and column counts (583) with
    masked atoms at nonzero offsets, in lattice order (column tiles out of
    the block's reach: their lists are empty, their feats gradient is
    zeros), shuffled (a row block spread over the whole box), as two blobs
    40 A apart and with whole tiles of masked rows (row tiles that list
    nothing: their forward rows are zeros): values
    and the feats, row and column coordinate gradients against the plain
    version, one launch of each of the three kernels on the call's one
    rect plan; both routes of every kernel (R + 1 <= 32 on the tensor
    cores, > 32 on CUDA cores); masked rows of the forward exactly 0; a
    second run repeats bit for bit; guards."""
    _need_card()
    gen = torch.Generator().manual_seed(Pc + Pr + off)
    coords, mask = _k5_system(Pc, system, gen)
    feats = torch.randn(Pc, F, generator=gen).to(**F32)
    g = torch.randn(Pr, R + 1, F, generator=gen).to(**F32)
    rows = slice(off, off + Pr)
    n0, built = dict(rcm.rect_launches), rcm.plans["rect_built"]

    def run(fn):
        cr = coords[rows].clone().requires_grad_(True)
        cc = coords.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = fn(cr, mask[rows], off, cc, mask, f, 6.0, R, div_d)
        return [T, *torch.autograd.grad(T, [f, cr, cc], g)]

    got = run(rcm.radial_contract_rect)
    assert [rcm.rect_launches[k] - n0[k] for k in n0] == [1, 1, 1]
    assert rcm.plans["rect_built"] == built + 1
    ref = run(rcm.radial_contract_rect_plain)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _close(a, b)
    assert bool((got[0][mask[rows] == 0] == 0).all())
    assert all(torch.equal(a, b)
               for a, b in zip(run(rcm.radial_contract_rect), got))
    args = (coords[rows], mask[rows], off, coords, mask, feats, 6.0, R,
            div_d)
    with pytest.raises(TypeError):
        rcm.radial_contract_rect(coords[rows].double(), *args[1:])
    with pytest.raises(ValueError):
        rcm.radial_contract_rect(*args[:5], feats[:, :5], *args[6:])
    with pytest.raises(ValueError):
        rcm.radial_contract_rect(*args[:5], feats[:-1], *args[6:])
    with pytest.raises(ValueError):
        rcm.radial_contract_rect(*args[:7], 63, div_d)


@pytest.mark.parametrize("div_d", [False, True])
def test_radial_contract_rect_blocks_stack_to_square(div_d):
    """Four K6 row blocks of a system stacked: the forward equals K5's
    kernel output, and the summed gradients (the rows' and columns'
    coordinate gradients, the feats gradients) equal K5's."""
    _need_card()
    P, F, R, n = 512, 64, 24, 4
    coords, mask, gen = _rc_system(P, 17)
    feats = torch.randn(P, F, generator=gen).to(**F32)
    g = torch.randn(P, R + 1, F, generator=gen).to(**F32)
    c = coords.clone().requires_grad_(True)
    f = feats.clone().requires_grad_(True)
    T = rcm.radial_contract(c, mask, f, 6.0, R, div_d)
    dc, df = torch.autograd.grad(T, [c, f], g)
    T = T.detach()
    b = P // n
    blocks, dc_sum, df_sum = [], torch.zeros_like(c), torch.zeros_like(f)
    for k in range(n):
        cr = coords[k * b:(k + 1) * b].clone().requires_grad_(True)
        cc = coords.clone().requires_grad_(True)
        fk = feats.clone().requires_grad_(True)
        Tk = rcm.radial_contract_rect(cr, mask[k * b:(k + 1) * b], k * b, cc,
                                      mask, fk, 6.0, R, div_d)
        dfk, dcr, dcc = torch.autograd.grad(Tk, [fk, cr, cc],
                                            g[k * b:(k + 1) * b])
        blocks.append(Tk.detach())
        dc_sum += dcc
        dc_sum[k * b:(k + 1) * b] += dcr
        df_sum += dfk
    torch.cuda.synchronize()
    stacked = torch.cat(blocks)
    assert float((stacked - T).abs().max()) <= 1e-5 * float(T.abs().max())
    assert _close(dc_sum, dc) and _close(df_sum, df)


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("R,shuffled", [(24, False), (24, True),
                                        (32, False), (32, True)])
def test_radial_contract_rect_fused_coords_match_plain(div_d, R, shuffled):
    """Both coordinate gradients, ``autograd.grad(T, [cr, cc], g)``, from
    one launch of the coordinate kernel on the rect tile plan against the
    plain version, at R + 1 = 25 (tensor cores) and 33 (CUDA cores), with
    the system in lattice order and shuffled (a row block spread over the
    whole box), at a ragged block with masked atoms; no feats-gradient
    launch; masked rows and columns exactly 0; two calls bit for bit
    equal."""
    _need_card()
    Pc, Pr, off, F = 700, 203, 331, 24
    coords, mask, gen = _rc_system(Pc, R + 7 * shuffled)
    if shuffled:
        sh = torch.randperm(Pc, generator=gen)
        coords, mask = coords[sh.cuda()], mask[sh.cuda()]
    feats = torch.randn(Pc, F, generator=gen).to(**F32)
    g = torch.randn(Pr, R + 1, F, generator=gen).to(**F32)
    rows = slice(off, off + Pr)

    def run(fn):
        cr = coords[rows].clone().requires_grad_(True)
        cc = coords.clone().requires_grad_(True)
        T = fn(cr, mask[rows], off, cc, mask, feats, 6.0, R, div_d)
        return torch.autograd.grad(T, [cr, cc], g)

    n0 = dict(rcm.rect_launches)
    got = run(rcm.radial_contract_rect)
    assert [rcm.rect_launches[k] - n0[k] for k in n0] == [1, 0, 1]
    ref = run(rcm.radial_contract_rect_plain)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _close(a, b)
    assert bool((got[0][mask[rows] == 0] == 0).all())
    assert bool((got[1][mask == 0] == 0).all())
    assert all(torch.equal(a, b)
               for a, b in zip(run(rcm.radial_contract_rect), got))


@pytest.mark.parametrize("div_d", [False, True])
@pytest.mark.parametrize("R,system", [(24, "lattice"), (40, "lattice"),
                                      (24, "shuffled"), (32, "blobs")])
def test_radial_contract_rect_given_plan_matches_own_plan(div_d, R, system):
    """A rect tile plan passed in serves all three kernels: the result and
    all three gradients are bitwise those of the call that builds its own
    plan (one, in the forward, kept for the backward), no plan is built,
    each kernel launches once a call, and two calls are bit for bit
    equal; a plan of other rows, columns or offset raises."""
    _need_card()
    Pc, Pr, off, F = 500, 125, 250, 16
    coords, mask = _k5_system(Pc, system, torch.Generator().manual_seed(R))
    gen = torch.Generator().manual_seed(R + 1)
    feats = torch.randn(Pc, F, generator=gen).to(**F32)
    g = torch.randn(Pr, R + 1, F, generator=gen).to(**F32)
    rows = slice(off, off + Pr)
    plan = rcm.rect_tile_plan(coords[rows], mask[rows], off, coords, mask,
                              6.0)

    def run(**kw):
        cr = coords[rows].clone().requires_grad_(True)
        cc = coords.clone().requires_grad_(True)
        f = feats.clone().requires_grad_(True)
        T = rcm.radial_contract_rect(cr, mask[rows], off, cc, mask, f, 6.0,
                                     R, div_d, **kw)
        return [T, *torch.autograd.grad(T, [cr, cc, f], g)]

    built, n0 = rcm.plans["rect_built"], dict(rcm.rect_launches)
    own = run()
    assert rcm.plans["rect_built"] == built + 1
    given = run(plan=plan)
    again = run(plan=plan)
    assert rcm.plans["rect_built"] == built + 1
    assert [rcm.rect_launches[k] - n0[k] for k in n0] == [3, 3, 3]
    assert all(torch.equal(a, b) for a, b in zip(given, own))
    assert all(torch.equal(a, b) for a, b in zip(again, given))
    args = (coords[rows], mask[rows], off, coords, mask, feats, 6.0, R,
            div_d)
    for other in (
            rcm.rect_tile_plan(coords[off:off + Pr - 1],
                               mask[off:off + Pr - 1], off, coords, mask,
                               6.0),
            rcm.rect_tile_plan(coords[rows], mask[rows], off, coords[:-1],
                               mask[:-1], 6.0),
            rcm.rect_tile_plan(coords[rows], mask[rows], off + 1, coords,
                               mask, 6.0)):
        with pytest.raises(ValueError):
            rcm.radial_contract_rect(*args, plan=other)


class _OneRank:
    """A sharding of one rank: the sharded pallas branch (K6 against all
    columns) without collectives."""
    rank, size = 0, 1

    @staticmethod
    def replicate_in(x):
        return x

    all_gather_rows = sum_out = replicate_in


def test_sharded_pallas_force_call_builds_one_rect_plan():
    """A uma-s-1p1 force call through the sharded pallas branch builds one
    rect tile plan and hands it to all of its K6 calls (8 forward, 7
    feats-gradient and 8 coordinate launches, no K5 launch); its forces,
    and the unsharded pallas call's, match the CPU float64 plain path on a
    jittered lattice (the smoke cluster's geometry)."""
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn)
    _need_card()
    rng = np.random.default_rng(8)
    grid = np.stack(np.meshgrid(*[np.arange(5)] * 3), -1).reshape(-1, 3)
    st = Structure(rng.choice([1, 6, 8], size=96).astype(np.int32),
                   grid[:96] * 1.8 + rng.normal(scale=0.15, size=(96, 3)))
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    fn, w, _ = make_model(cfg, seed=3)
    wc = tree_to(w, device="cuda")
    shard = Calculator(st, make_spatial_energy_fn(cfg, _OneRank()),
                       params=wc, device="cuda")
    cb = st.coords_bohr.reshape(-1)
    shard.get_forces(cb)
    built, n0, k0 = rcm.plans["rect_built"], dict(rcm.rect_launches), \
        dict(rcm.launches)
    res = shard.get_forces(cb)
    assert rcm.plans["rect_built"] == built + 1
    assert [rcm.rect_launches[k] - n0[k] for k in n0] == [8, 7, 8]
    assert rcm.launches == k0
    one = Calculator(st, fn, params=wc, device="cuda").get_forces(cb)
    ref = make_uma_calculator(st, model="uma-s-1p1", params=w,
                              device="cpu",
                              dtype=torch.float64).get_forces(cb)
    for got in (res, one):
        assert np.abs(got["forces"] - ref["forces"]).max() \
            <= TOL * np.abs(ref["forces"]).max()


def _cloud():
    """96 atoms at normal coordinates (scale 3 A; closest pair 0.31 A):
    the random normal cloud of ``scripts/gpu_random_cloud.py``."""
    rng = np.random.default_rng(8)
    return Structure(rng.choice([1, 6, 8], size=96).astype(np.int32),
                     rng.normal(scale=3.0, size=(96, 3)))


def test_sharded_pallas_random_cloud_matches_cpu_f64():
    """uma-s-1p1 pallas on a random normal cloud (close pairs: the model's
    split of the edge-direction stream amplifies the K6 forward's float32
    rounding there, as the lattice never shows): the sharded branch (K6,
    one rank) and the unsharded call (K5) on the card within 1e-4 of the
    CPU float64 plain path (max|dF| / max|F|); one rect plan and 8 / 7 /
    8 K6 launches a sharded call."""
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn)
    _need_card()
    st = _cloud()
    cfg = dataclasses.replace(CONFIGS["uma-s-1p1"], mp_mode="pallas")
    fn, w, _ = make_model(cfg, seed=3)
    wc = tree_to(w, device="cuda")
    cb = st.coords_bohr.reshape(-1)
    ref = make_uma_calculator(st, model="uma-s-1p1", params=w, device="cpu",
                              dtype=torch.float64).get_forces(cb)["forces"]
    shard = Calculator(st, make_spatial_energy_fn(cfg, _OneRank()),
                       params=wc, device="cuda")
    built, n0 = rcm.plans["rect_built"], dict(rcm.rect_launches)
    res = shard.get_forces(cb)["forces"]
    assert rcm.plans["rect_built"] == built + 1
    assert [rcm.rect_launches[k] - n0[k] for k in n0] == [8, 7, 8]
    one = Calculator(st, fn, params=wc, device="cuda").get_forces(cb)
    for got in (res, one["forces"]):
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Hessians, HVPs and the GSM string on the card
# ---------------------------------------------------------------------------

HESS_TOL = 1e-3     # max|dH| / max|H_cpu64|: the outer limit
HESS_FLOOR = 1e-5   # the floor under twice CPU float32's own error
MAIN_PATH = ("fused_edge_mega_fwd", "fused_edge_mega_bwd",
             "fused_node_ffn_fwd", "fused_node_ffn_bwd")


def _all_counts():
    return {**ek.launches, **fk.launches, **rcm.launches,
            **rcm.rect_launches}


def _moved(before):
    return {k: v - before[k] for k, v in _all_counts().items()
            if v != before[k]}


def _lattice(n, seed):
    """Jittered 1.8 A lattice of n atoms (the smoke cluster's geometry)."""
    rng = np.random.default_rng(seed)
    zs = rng.choice([1, 6, 7, 8], size=n).astype(np.int32)
    g = int(np.ceil(n ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(g)] * 3), -1).reshape(-1, 3)
    return Structure(zs, pts[:n] * 1.8 + rng.normal(scale=0.15,
                                                    size=(n, 3)))


def _hess_limit(err32):
    """What the card's Hessian error may be: twice CPU float32's own, at
    least HESS_FLOOR, at most HESS_TOL."""
    return min(HESS_TOL, max(2 * err32, HESS_FLOOR))


def _hvp_columns(calc, cb, cols):
    hvp, x = calc.au_hvp_fn(), calc.pad_bohr(cb)
    out = []
    for k in cols:
        v = torch.zeros_like(x)
        v.view(-1)[k] = 1.0
        out.append(hvp(x, v).reshape(-1)[:cb.size].double().cpu().numpy())
    return np.stack(out)


def test_escn_hessian_on_card_matches_cpu_f64():
    """escn-test on the card (forces through K1 and K2, the Hessian through
    the all-plain variant) against the CPU: the analytic Hessian and HVPs
    within ``_hess_limit`` of float64, and no kernel launched but
    get_hessian's one force call."""
    _need_card()
    st = _lattice(10, seed=3)
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=2)
    kw = dict(model="escn-test", params=w, freeze_atoms=[0])
    gpu = make_uma_calculator(st, **kw)
    c64 = make_uma_calculator(st, device="cpu", dtype=torch.float64, **kw)
    c32 = make_uma_calculator(st, device="cpu", dtype=torch.float32, **kw)
    cb = st.coords_bohr.reshape(-1)
    before = _all_counts()
    H = gpu.get_hessian(cb)["hessian"]
    assert _moved(before) == {k: 2 for k in MAIN_PATH}   # 2 layers, 1 call
    H64 = c64.get_hessian(cb)["hessian"]
    err = np.abs(H - H64).max() / np.abs(H64).max()
    err32 = np.abs(c32.get_hessian(cb)["hessian"] - H64).max() \
        / np.abs(H64).max()
    assert err <= _hess_limit(err32)
    np.testing.assert_array_equal(H, H.T)
    assert np.all(H[:3] == 0) and np.all(H[:, :3] == 0)
    cols = [3, 7, 20]
    before = _all_counts()
    hv = _hvp_columns(gpu, cb, cols)
    assert _moved(before) == {}
    hv64 = _hvp_columns(c64, cb, cols)
    err = np.abs(hv - hv64).max() / np.abs(hv64).max()
    err32 = np.abs(_hvp_columns(c32, cb, cols) - hv64).max() \
        / np.abs(hv64).max()
    assert err <= _hess_limit(err32)


def test_escn_md_hvp_columns_on_card_64_atoms():
    """escn-md at 64 atoms: three HVP columns on the card (the all-plain
    variant) against CPU float64 within ``_hess_limit``, with no kernel
    launched; a create_graph backward through the kernels raises."""
    _need_card()
    st = _lattice(64, seed=1)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=0)
    gpu = make_uma_calculator(st, model="escn-md", params=w)
    cpu = make_uma_calculator(st, model="escn-md", params=w, device="cpu",
                              dtype=torch.float64)
    c32 = make_uma_calculator(st, model="escn-md", params=w, device="cpu",
                              dtype=torch.float32)
    cb = st.coords_bohr.reshape(-1)
    cols = [0, 95, 191]
    before = _all_counts()
    hv = _hvp_columns(gpu, cb, cols)
    assert _moved(before) == {}
    hv64 = _hvp_columns(cpu, cb, cols)
    scale = np.abs(hv64).max()
    err32 = np.abs(_hvp_columns(c32, cb, cols) - hv64).max() / scale
    assert np.abs(hv - hv64).max() / scale <= _hess_limit(err32)
    c = gpu._to_pad_ang(cb).requires_grad_(True)
    e = gpu.energy_fn(c, gpu.system, gpu.params)
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(e, c, create_graph=True)


def test_morse_gsm_on_card_matches_cpu():
    """The Morse H3 string with the climbing image and Lanczos tangents,
    float64 throughout: the card run equals the CPU run."""
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    from pdb2reaction_tpu_torch.mlip import potentials
    _need_card()
    a = [[0, 0, 0], [0.686, 0, 0], [2.4, 0, 0]]
    b = np.array([[0, 0, 0], [2.4 - 0.686, 0, 0], [2.4, 0, 0]]) * ANG2BOHR
    runs = []
    for dev in ("cuda", "cpu"):
        st = Structure.from_symbols(["H"] * 3, a, freeze=[0, 2])
        c = Calculator(st, potentials.make_morse(), device=dev)
        runs.append(gsm_mep(c.au_energy_force_batch_fn(),
                            c.pad_bohr(st.coords_bohr), c.pad_bohr(b),
                            c.system.free_mask, max_nodes=9, max_cycles=300,
                            conv_perp_rms=5e-4, hvp_fn=c.au_hvp_fn()))
    g, c = runs
    assert g.converged and (g.cycles, g.hei_idx) == (c.cycles, c.hei_idx)
    assert np.abs(g.images - c.images).max() <= 1e-10
    assert np.abs(g.energies - c.energies).max() <= 1e-12


def test_flagship_gsm_accounting_on_card():
    """escn-md on the 300-atom cluster, max_nodes=10, 8 cycles, the host
    loop: (cycles + 1) x 12 force calls, counted once on the calculator,
    and K1 and K2 launched 4 times each (fwd and bwd) per force call."""
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    _need_card()
    st = _lattice(300, seed=0)
    calc = make_uma_calculator(st, model="escn-md", seed=0, pad_multiple=64)
    rng = np.random.default_rng(1)
    xB = st.coords + rng.normal(scale=0.08, size=st.coords.shape)
    before, n0 = _all_counts(), calc.force_calls
    res = gsm_mep(calc.au_energy_force_batch_fn(),
                  calc.pad_bohr(st.coords_bohr),
                  calc.pad_bohr(xB * ANG2BOHR), calc.system.free_mask,
                  max_nodes=10, max_cycles=8, stop_in_when_full=2,
                  conv_perp_rms=2e-2, climb=False, loop="host")
    fc = res.force_calls
    assert fc == (res.cycles + 1) * 12 and calc.force_calls - n0 == fc
    assert _moved(before) == {k: 4 * fc for k in MAIN_PATH}
    assert np.all(np.isfinite(res.energies))


def test_compare_structures_on_card_equals_cpu():
    """Bond changes on the card: the same formed and broken sets as the
    CPU, both distance matrices within 1e-12 Bohr."""
    from pdb2reaction_tpu_torch.bio.bonds import compare_structures
    _need_card()
    st = _lattice(300, seed=0)
    rng = np.random.default_rng(2)
    xb = st.coords + rng.normal(scale=0.12, size=st.coords.shape)
    a, b = st.coords * ANG2BOHR, xb * ANG2BOHR
    g = compare_structures(st.numbers, a, b, device="cuda")
    c = compare_structures(st.numbers, a, b, device="cpu")
    assert g.formed_covalent and g.broken_covalent
    assert (g.formed_covalent, g.broken_covalent) == \
        (c.formed_covalent, c.broken_covalent)
    assert np.abs(g.distances_1 - c.distances_1).max() <= 1e-12
    assert np.abs(g.distances_2 - c.distances_2).max() <= 1e-12


@pytest.mark.parametrize("i", [0, 1])
def test_md_golden_through_pt_on_card(tmp_path, i):
    """The production-dims golden (lmax 4, mmax 2, C = 128) through
    make_uma_calculator(checkpoint=x.pt) on the card, K1 and K2 in
    float32 (2 + 2 launches a force call), against CPU float64 on the
    same converted weights and against the independent goldens: energy
    rtol 2e-5, forces rtol 1e-3 and atol 2e-5 eV/Angstrom."""
    import sys
    from pathlib import Path
    from pdb2reaction_tpu_torch.constants import AU2EV, F_EVAA_2_AU
    _need_card()
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "scripts"))
    try:
        from make_escn_golden import MD_CFG, make_state_dict
    finally:
        sys.path.remove(str(root / "scripts"))
    g = np.load(root / "tests" / "fixtures" / "escn_golden_md.npz")
    sd = make_state_dict(MD_CFG, seed=int(g["cfg_seed"]))
    pt = tmp_path / "golden_md.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in sd.items()}}, pt)
    q, s, t = (int(v) for v in g[f"struct{i}_cqt"])
    st = Structure(g[f"struct{i}_numbers"], g[f"struct{i}_coords"])
    out = {}
    for dev, dt in (("cuda", None), ("cpu", torch.float64)):
        calc = make_uma_calculator(st, checkpoint=str(pt), device=dev,
                                   dtype=dt, charge=q, spin=s, task=t)
        before = _all_counts()
        r = calc.get_forces(st.coords_bohr.reshape(-1))
        if dev == "cuda":
            assert _moved(before) == {k: 2 for k in MAIN_PATH}
        out[dev] = (r["energy"] * AU2EV,
                    r["forces"].reshape(-1, 3) / F_EVAA_2_AU)
    e, f = out["cuda"]
    for e_ref, f_ref in (out["cpu"], (float(g[f"struct{i}_energy"]),
                                      g[f"struct{i}_forces"])):
        np.testing.assert_allclose(e, e_ref, rtol=2e-5)
        np.testing.assert_allclose(f, f_ref, rtol=1e-3, atol=2e-5)


def test_morse_path_search_on_card_matches_cpu(tmp_path):
    """run_path_search on Morse H3, float64 throughout: the card's
    summary equals the CPU's (floats within 1e-9, all else exactly) and
    its bond changes ran on the card."""
    import json
    from pdb2reaction_tpu_torch.workflows.path_search import run_path_search
    _need_card()
    for name, x in (("A", 0.686), ("B", 1.714)):
        (tmp_path / f"{name}.xyz").write_text(
            f"3\n{name}\nH 0.0 0.0 0.0\nH {x} 0.0 0.0\nH 2.4 0.0 0.0\n")
    docs = {}
    for dev in ("cuda", "cpu"):
        res = run_path_search([tmp_path / "A.xyz", tmp_path / "B.xyz"],
                              charge=0, calc_mode="morse", device=dev,
                              freeze_atoms=[0, 2], verbose=False,
                              out_dir=tmp_path / dev,
                              gs_kw={"max_nodes": 9})
        assert str(res["calculator"].device).startswith(dev)
        docs[dev] = json.loads((tmp_path / dev / "summary.yaml").read_text())

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, float):
            assert abs(a - b) <= 1e-9
        else:
            assert a == b

    same(docs["cuda"], docs["cpu"])
    assert docs["cuda"]["segments"][0]["reactive"]


def _morse_h3(x1, device):
    from pdb2reaction_tpu_torch.mlip import potentials
    st = Structure.from_symbols(["H"] * 3, [[0, 0, 0], [x1, 0, 0],
                                            [2.4, 0, 0]], freeze=[0, 2])
    return Calculator(st, potentials.make_morse(), device=device), st


@pytest.mark.parametrize("engine", ["rfo", "dimer", "irc"])
def test_stage4_morse_engines_on_card_match_cpu(engine):
    """RS-I-RFO, the Hessian dimer and EulerPC on the Morse double well on
    the card against the CPU (phase 15 of chip_smoke): equal cycles and
    force calls, 1e-8 Bohr, 1e-10 Hartree, results on the card."""
    _need_card()
    from pdb2reaction_tpu_torch.engines.dimer import hessian_dimer
    from pdb2reaction_tpu_torch.engines.irc import eulerpc_irc
    from pdb2reaction_tpu_torch.engines.rfo import rfo_optimize
    out = {}
    for dev in ("cuda", "cpu"):
        c, st = _morse_h3(1.2 if engine == "irc" else 1.05, dev)
        x0 = c.pad_bohr(st.coords_bohr)
        if engine == "rfo":
            H0 = c.get_hessian(st.coords_bohr.reshape(-1))["hessian"]
            r = rfo_optimize(c.au_energy_force_fn(), x0, c.system.free_mask,
                             c.n_atoms, hessian0=H0, mode="ts", roots=[0],
                             thresh="baker", hessian_update="bofill",
                             max_cycles=300)
            assert r.x.device.type == dev and r.converged
            out[dev] = (r.x.cpu().numpy(), [r.e], r.cycles, c.force_calls)
        elif engine == "dimer":
            d = hessian_dimer(c, x0, flatten_max_iter=0)
            assert d.x.device.type == dev and d.converged
            out[dev] = (d.x.cpu().numpy(), [d.e], d.cycles, c.force_calls)
        else:
            i = eulerpc_irc(c, x0, max_cycles=80, rms_grad_thresh=5e-4)
            b = (i.forward, i.backward)
            out[dev] = (np.concatenate([np.stack(x.coords) for x in b]),
                        i.forward.energies + i.backward.energies,
                        sum(len(x.coords) for x in b), c.force_calls)
    (xg, eg, cg, fg), (xc, ec, cc, fc) = out["cuda"], out["cpu"]
    assert cg == cc and fg == fc
    assert np.abs(xg - xc).max() <= 1e-8
    assert np.abs(np.subtract(eg, ec)).max() <= 1e-10


def test_stage4_escn_hessian_on_card_free_tangents():
    """The analytic Hessian on the card with frozen atoms: one HVP a free
    DOF, no kernel launch inside, zero frozen rows, and the free block
    within 1e-4 of CPU float64 (float32 plain path)."""
    _need_card()
    rng = np.random.default_rng(3)
    zs = rng.choice([1, 6, 8], size=12).astype(np.int32)
    st = Structure(zs, rng.normal(scale=1.5, size=(12, 3)))
    free_atoms = [2, 5, 7]
    frozen = [i for i in range(12) if i not in free_atoms]
    cb = st.coords_bohr.reshape(-1)
    gpu = make_uma_calculator(st, model="escn-test", device="cuda", seed=0,
                              freeze_atoms=frozen)
    cpu = make_uma_calculator(st, model="escn-test", device="cpu", seed=0,
                              dtype=torch.float64, freeze_atoms=frozen)
    before = {**ek.launches, **fk.launches}
    Hg = gpu._analytic_hessian(cb)
    assert {**ek.launches, **fk.launches} == before
    Hc = cpu._analytic_hessian(cb)
    free = gpu.free_dof_mask
    assert free.sum() == 9
    assert np.all(Hg[~free] == 0) and np.all(Hg[:, ~free] == 0)
    fb = np.ix_(free, free)
    assert np.abs(Hg[fb] - Hc[fb]).max() <= 1e-4 * np.abs(Hc[fb]).max()


def test_biased_escn_md_on_card_kernels_in_forces_none_in_hessian():
    """The distance restraints on escn-md on the card (engines/bias.py):
    a biased force call launches K1 and K2 4 + 4 times like the plain
    one, its forces are the plain forces plus the restraint's, and its
    analytic Hessian launches no kernel (the restraint wraps the all-plain
    closure too); the Hessian's free block within 1e-4 of the CPU's in
    float64."""
    _need_card()
    from pdb2reaction_tpu_torch.engines.bias import (bias_params,
                                                     biased_calculator,
                                                     make_biased_energy_fn)
    rng = np.random.default_rng(5)
    zs = rng.choice([1, 6, 8], size=24).astype(np.int32)
    st = Structure(zs, rng.normal(scale=2.5, size=(24, 3)))
    frozen = list(range(4, 24))
    pairs, targets, k = [(0, 1), (2, 3)], [1.2, 1.6], 20.0
    cb = st.coords_bohr.reshape(-1)
    base = make_uma_calculator(st, model="escn-md", device="cuda", seed=0,
                               freeze_atoms=frozen)
    calc = biased_calculator(base, pairs, targets, k)
    alone = Calculator(st, make_biased_energy_fn(
        lambda c, s, p: 0.0 * c.sum(), pairs), params=bias_params(targets, k),
        freeze_atoms=frozen, device="cpu")
    before = {**ek.launches, **fk.launches}
    f = calc.get_forces(cb)["forces"]
    moved = {n: v - before[n] for n, v in {**ek.launches,
                                           **fk.launches}.items()}
    assert moved["fused_edge_mega_fwd"] == moved["fused_edge_mega_bwd"] \
        == moved["fused_node_ffn_fwd"] == moved["fused_node_ffn_bwd"] == 4
    want = base.get_forces(cb)["forces"] + alone.get_forces(cb)["forces"]
    assert np.abs(f - want).max() <= 1e-4 * np.abs(want).max()
    before = {**ek.launches, **fk.launches}
    H = calc._analytic_hessian(cb)
    assert {**ek.launches, **fk.launches} == before
    cpu = biased_calculator(
        make_uma_calculator(st, model="escn-md", device="cpu", seed=0,
                            dtype=torch.float64, freeze_atoms=frozen),
        pairs, targets, k)
    Hc = cpu._analytic_hessian(cb)
    free = calc.free_dof_mask
    fb = np.ix_(free, free)
    assert np.abs(H[fb] - Hc[fb]).max() <= 1e-4 * np.abs(Hc[fb]).max()


def test_extract_on_card_matches_cpu(tmp_path):
    """extract_api(device="cuda") writes the CPU's pocket byte for byte,
    with the same counts and charge summary (radius queries on the card,
    float64)."""
    _need_card()
    from pdb2reaction_tpu_torch.bio.extract import extract_api
    from pdb2reaction_tpu_torch.core.neighbors import radius_query
    import chip_smoke
    r, p = tmp_path / "R.pdb", tmp_path / "P.pdb"
    chip_smoke.build_enzyme_pdb(r, seed=0)
    chip_smoke.build_enzyme_pdb(p, stretch=2.40, seed=0)
    chip_smoke.add_outer_body(r)
    chip_smoke.add_outer_body(p)
    res = {}
    for dev in ("cuda", "cpu"):
        outs = [tmp_path / f"{dev}_{k}.pdb" for k in "RP"]
        res[dev] = extract_api([r, p], "LIG", outs, ligand_charge=0,
                               radius_het2het=3.0, device=dev)
        res[dev]["text"] = [o.read_bytes() for o in outs]
    for key in ("text", "counts", "charge_summary"):
        assert res["cuda"][key] == res["cpu"][key], key
    rng = np.random.default_rng(0)
    pts, ctr = rng.uniform(-9, 9, (3000, 3)), rng.uniform(-5, 5, (300, 3))
    hits = {dev: set(map(tuple, radius_query(pts, ctr, 2.6,
                                             device=dev).tolist()))
            for dev in ("cuda", "cpu")}
    assert hits["cuda"] == hits["cpu"] and hits["cpu"]


def _moved(before):
    return {n: v - before[n] for n, v in {**ek.launches,
                                          **fk.launches}.items()
            if v != before[n]}


def test_scans_on_card_kernels_in_forces_none_in_hessian(tmp_path,
                                                         monkeypatch):
    """The scans on escn-md on the card: a two-step run_scan launches K1
    and K2 4 + 4 times a force call and nothing else; a one-point
    run_scan_nd in rfo mode launches them 4 forward an energy call and
    none inside the biased Hessians that seed its RFO relaxations."""
    _need_card()
    from pdb2reaction_tpu_torch.core.io_xyz import write_xyz
    from pdb2reaction_tpu_torch.workflows.scan import run_scan
    from pdb2reaction_tpu_torch.workflows.scan_nd import run_scan_nd
    rng = np.random.default_rng(5)
    zs = rng.choice([1, 6, 8], size=24).astype(np.int32)
    st = Structure(zs, rng.normal(scale=2.5, size=(24, 3)))
    path = tmp_path / "m.xyz"
    write_xyz(path, st)
    d01 = float(np.linalg.norm(st.coords[0] - st.coords[1]))
    kw = dict(charge=0, model="escn-md", seed=0, device="cuda",
              freeze_atoms=list(range(4, 24)), verbose=False)
    before = {**ek.launches, **fk.launches}
    res = run_scan(path, [[(0, 1, d01 - 0.2)]], relax_max_cycles=4,
                   out_dir=tmp_path / "s", **kw)
    fc = res["force_calls"]
    assert fc > 0 and res["energy_calls"] == 0
    assert _moved(before) == {"fused_edge_mega_fwd": 4 * fc,
                              "fused_edge_mega_bwd": 4 * fc,
                              "fused_node_ffn_fwd": 4 * fc,
                              "fused_node_ffn_bwd": 4 * fc}
    inside = []
    orig = Calculator._analytic_hessian

    def hess(calc, x):
        b = {**ek.launches, **fk.launches}
        out = orig(calc, x)
        inside.append(_moved(b))
        return out

    monkeypatch.setattr(Calculator, "_analytic_hessian", hess)
    before = {**ek.launches, **fk.launches}
    d23 = float(np.linalg.norm(st.coords[2] - st.coords[3]))
    res = run_scan_nd(path, [{"pair": (0, 1), "values": [d01 - 0.1]},
                             {"pair": (2, 3), "values": [d23 + 0.1]}],
                      relax_mode="rfo", relax_max_cycles=3,
                      out_dir=tmp_path / "g", **kw)
    fc, ec = res["force_calls"], res["energy_calls"]
    assert ec == 1 and len(inside) == 2 and not any(inside)
    assert _moved(before) == {"fused_edge_mega_fwd": 4 * (fc + ec),
                              "fused_edge_mega_bwd": 4 * fc,
                              "fused_node_ffn_fwd": 4 * (fc + ec),
                              "fused_node_ffn_bwd": 4 * fc}
    assert np.all(np.isfinite(res["surface"]))


def test_mini_engine_on_card_matches_cpu():
    """The RHF/STO-3G engine on the card equals the CPU's in float64:
    energies within 1e-10 Hartree, charges within 1e-8 e."""
    _need_card()
    from pdb2reaction_tpu_torch.workflows.minidft import rhf
    for Z, X, q in (([1, 1], [[0, 0, 0], [0.74, 0, 0]], 0),
                    ([2, 1], [[0, 0, 0], [0.772, 0, 0]], 1),
                    ([1, 1, 1], [[0, 0, 0], [0.87, 0, 0],
                                 [0.435, 0.75, 0]], 1)):
        g, c = rhf(Z, X, charge=q, device="cuda"), rhf(Z, X, charge=q,
                                                       device="cpu")
        assert g["converged"] and c["converged"]
        assert abs(g["e_tot"] - c["e_tot"]) <= 1e-10
        for k in ("mulliken", "lowdin"):
            assert np.abs(np.subtract(g[k], c[k])).max() <= 1e-8


# ---------------------------------------------------------------------------
# the gate and full branches, remat_blocks, and K3 under the shard
# ---------------------------------------------------------------------------

NARROW_S = dict(sphere_channels=8, hidden_channels=8, edge_channels=8,
                ffn_hidden=16, num_experts=2, route_dim=4, num_gauss=8,
                max_neighbors=16)


def _branch_counts():
    return {**ek.launches, **fk.launches}


@pytest.mark.parametrize("name,over", [("escn-test-gate", {}),
                                       ("escn-s", NARROW_S)])
def test_branch_calculator_on_card_matches_cpu_f64(name, over, monkeypatch):
    """The gate and full configurations on the card against the CPU
    float64 plain path: forces within TOL, K2 launched once a layer each
    way, no edge kernel (their edge paths are plain), and a second call
    bit for bit equal."""
    _need_card()
    from pdb2reaction_tpu_torch.mlip import escn as escn_mod
    cfg = dataclasses.replace(ESCN_CONFIGS[name], **over)
    monkeypatch.setitem(escn_mod.ESCN_CONFIGS, name, cfg)
    st = _lattice(20, seed=4)
    w = init_escn_params(cfg, seed=1)
    gpu = make_uma_calculator(st, model=name, params=w)
    cpu = make_uma_calculator(st, model=name, params=w, device="cpu",
                              dtype=torch.float64)
    cb = st.coords_bohr.reshape(-1)
    before = _branch_counts()
    rg = gpu.get_forces(cb)
    moved = {k: v - before[k] for k, v in _branch_counts().items()
             if v != before[k]}
    L = cfg.num_layers
    assert moved == {"fused_node_ffn_fwd": L, "fused_node_ffn_bwd": L}
    rc = cpu.get_forces(cb)
    assert np.abs(rg["forces"] - rc["forces"]).max() \
        <= TOL * np.abs(rc["forces"]).max()
    assert np.array_equal(gpu.get_forces(cb)["forces"], rg["forces"])


def test_remat_blocks_on_card_repeat_forces_bit_for_bit():
    """remat_blocks recomputes each block in the backward: K1 and K2
    forwards launch twice a layer, and the forces equal the remat-off
    forces bit for bit."""
    _need_card()
    from pdb2reaction_tpu_torch.mlip.escn import escn_energy_fn
    st = _lattice(20, seed=5)
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=2)
    calc = make_uma_calculator(st, model="escn-test", params=w)
    remat = make_uma_calculator(st, model="escn-test", params=w)
    cfg_r = dataclasses.replace(remat.cfg, remat_blocks=True)
    remat.energy_fn, remat.cfg = escn_energy_fn(cfg_r), cfg_r
    cb = st.coords_bohr.reshape(-1)
    f0 = calc.get_forces(cb)["forces"]
    before = _branch_counts()
    f1 = remat.get_forces(cb)["forces"]
    moved = {k: v - before[k] for k, v in _branch_counts().items()
             if v != before[k]}
    L = cfg_r.num_layers
    assert moved == {"fused_edge_mega_fwd": 2 * L, "fused_edge_mega_bwd": L,
                     "fused_node_ffn_fwd": 2 * L, "fused_node_ffn_bwd": L}
    assert np.array_equal(f0, f1)


def test_edge_block_on_gathered_full_rows():
    """K3 as the sharded path calls it: P_loc * K edges whose sources are
    gathered (``gather_src``) from P_full = 4 P_loc node rows and whose
    targets are this rank's rows. Values and the cotangents of both row
    sets against the plain version (plain indexing), bit for bit on a
    second run."""
    _need_card()
    cfg = dataclasses.replace(ESCN_CONFIGS["escn-md"], **NARROW_MD,
                              max_neighbors=16)
    P_loc, K = 13, 16
    P_full, E = 4 * P_loc, P_loc * K
    w, tabs, _, (_, _, _, _), _ = _edge_inputs(cfg, P_loc, seed=11)
    gen = torch.Generator().manual_seed(12)
    M, C = (cfg.lmax + 1) ** 2, cfg.sphere_channels
    nnz = len(ek._rot_nz(cfg.lmax, cfg.mmax)[0])
    rows = torch.randn(P_full, M * C, generator=gen).to(**F32)
    own = rows[2 * P_loc:3 * P_loc].clone()
    src = torch.randint(0, P_full, (E,), generator=gen).cuda()
    es = torch.randn(cfg.edge_channels, E, generator=gen).to(**F32)
    dp = (torch.randn(nnz, E, generator=gen) * 0.5).to(**F32)
    dpe = dp * (torch.rand(E, generator=gen) > 0.2).to(**F32)
    live = dpe.abs().amax(0) > 0
    g = torch.randn(M * C, E, generator=gen).to(**F32)
    outs = []
    for kernel in (True, True, False):
        r = rows.clone().requires_grad_(True)
        o = own.clone().requires_grad_(True)
        xs = (ek.gather_src(r, src, live) if kernel else r[src]).T
        xt = o.repeat_interleave(K, dim=0).T
        fn = ek.fused_edge_block if kernel else ek.fused_edge_block_plain
        y = fn(cfg, xs, xt, es, dp, dpe, w, tabs)
        outs.append([y, *torch.autograd.grad(y, [r, o], g)])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and _close(a, c)


def test_escn_sharded_route_on_card_takes_k3():
    """escn_energy under a one-rank shard (the collectives identities)
    takes K3 for "pallas-mega" and matches the unsharded pallas-full
    call."""
    _need_card()
    from pdb2reaction_tpu_torch.mlip.escn import escn_energy

    class Solo:
        rank, size = 0, 1

        @staticmethod
        def replicate_in(x):
            return x

        all_gather_rows = sum_out = replicate_in

    st = _lattice(20, seed=6)
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=3)
    calc = make_uma_calculator(st, model="escn-test", params=w,
                               edge_kernel="pallas-full")
    cfg = dataclasses.replace(calc.cfg, edge_kernel="pallas-mega")
    c = calc._to_pad_ang(st.coords_bohr.reshape(-1))
    got = []
    for shard in (Solo(), None):
        x = c.clone().requires_grad_(True)
        before = _branch_counts()
        e = escn_energy(x, calc.system, calc.params,
                        cfg if shard else calc.cfg, shard)
        got.append((e, torch.autograd.grad(e, x)[0]))
        moved = {k: v - before[k] for k, v in _branch_counts().items()
                 if v != before[k]}
        assert moved == {"fused_edge_block_fwd": 2, "fused_edge_block_bwd": 2,
                         "fused_node_ffn_fwd": 2, "fused_node_ffn_bwd": 2}
    assert _close(got[0][0], got[1][0]) and _close(got[0][1], got[1][1])


# ---- ranks on the card: the data axis and the Hessian over ranks -----------

def _card_rank(rank, port, out, case):
    """One of two gloo ranks on the card (spawned below): escn-md at 64
    atoms, the batch over a data axis of two ("data") or one HVP through
    the calculator sharded over two model ranks ("hvp")."""
    import os
    import pickle
    import traceback
    try:
        from pdb2reaction_tpu_torch.parallel import (initialize_distributed,
                                                     make_mesh, shutdown)
        initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                               timeout_s=300)
        st = _lattice(64, seed=4)
        w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=3)
        if case == "data":
            calc = make_uma_calculator(st, model="escn-md", params=w,
                                       mesh=make_mesh(data=2))
            res = calc.get_forces_batch(_card_batch(st))
        else:
            make_mesh(model=2)
            calc = make_uma_calculator(st, model="escn-md", params=w,
                                       spatial=2)
            x, v = _card_tangent(calc, st)
            res = calc.au_hvp_fn()(x, v).cpu().numpy()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
        shutdown()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _card_batch(st):
    rng = np.random.default_rng(8)
    cb = st.coords_bohr.reshape(-1)
    return np.stack([cb + 0.02 * rng.normal(size=cb.shape)
                     for _ in range(5)])


def _card_tangent(calc, st):
    x = calc.pad_bohr(st.coords_bohr)
    v = torch.as_tensor(np.random.default_rng(9).normal(
        size=tuple(x.shape)), device=x.device)
    return x, v


def _spawn_card_ranks(tmp_path, case):
    import pickle
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_card_rank,
                         args=(r, port, str(tmp_path), case))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    errs = [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
            if (tmp_path / f"rank{r}.err").exists()]
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    out = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def test_data_axis_on_card_bit_for_bit(tmp_path):
    """escn-md at 64 atoms, five images over a data axis of two gloo ranks
    on the card: each rank's batch is the single process's bit for bit
    (the same K1/K2 launches on the same inputs)."""
    _need_card()
    st = _lattice(64, seed=4)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=3)
    one = make_uma_calculator(st, model="escn-md",
                              params=w).get_forces_batch(_card_batch(st))
    for res in _spawn_card_ranks(tmp_path, "data"):
        assert np.array_equal(res["energy"], one["energy"])
        assert np.array_equal(res["forces"], one["forces"])


def test_sharded_hvp_on_card_matches_unsharded(tmp_path):
    """One HVP of escn-md at 64 atoms through the calculator sharded over
    two gloo ranks on the card (the sharded plain closure and the
    collectives' double backward) against the unsharded calculator's,
    within 1e-5 of max|Hv|; the same bits on both ranks."""
    _need_card()
    st = _lattice(64, seed=4)
    w = init_escn_params(ESCN_CONFIGS["escn-md"], seed=3)
    calc = make_uma_calculator(st, model="escn-md", params=w)
    x, v = _card_tangent(calc, st)
    ref = calc.au_hvp_fn()(x, v).cpu().numpy()
    got = _spawn_card_ranks(tmp_path, "hvp")
    for hv in got:
        assert np.abs(hv - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.array_equal(got[0], got[1])


def test_train_steps_on_card_match_cpu_f64():
    """One Adam step of escn-test on the plain "xla" route and of the
    PaiNN-class model dense on the card (float32) against the same step
    on the CPU in float64: loss rel 1e-4, each gradient leaf (its first
    moment / (1 - b1)) within 1e-4 of its max|g|; a kernel configuration
    is refused on the card before any launch."""
    _need_card()
    from pdb2reaction_tpu_torch.mlip import train as T
    gen = torch.Generator().manual_seed(5)
    batch = T.random_batch(gen, None, batch=4, n_atoms=6, n_pad=8)
    small = dict(hidden=32, n_layers=2, n_radial=6, cutoff=4.0,
                 max_neighbors=8)
    cases = [(dataclasses.replace(ESCN_CONFIGS["escn-test"],
                                  edge_kernel="xla"),
              init_escn_params(ESCN_CONFIGS["escn-test"], seed=1),
              T.make_escn_train_step),
             (ModelConfig(**small), make_model(ModelConfig(**small),
                                               seed=1)[1],
              T.make_train_step)]
    for cfg, p, make in cases:
        p = dict(p, charge=torch.tensor(0.0), spin=torch.tensor(1.0))
        res = []
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            c = dataclasses.replace(cfg, dtype=dt)
            pp = tree_to(tree_to(p, device=dev), dtype=dt)
            bb = T.TrainBatch(*(t.to(dev) if not t.is_floating_point()
                                else t.to(dev, dt) for t in batch))
            opt = T.adam(1e-3)
            _, st, loss = make(c, opt)(pp, opt.init(pp), bb)
            res.append((float(loss), [m.double().cpu() / 0.1
                                      for m in st.mu]))
        (l32, g32), (l64, g64) = res
        assert abs(l32 - l64) <= 1e-4 * abs(l64)
        for a, b in zip(g32, g64):
            if b.abs().max() > 0:
                assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    cfg = ESCN_CONFIGS["escn-test"]                    # pallas-mega
    p = tree_to(dict(init_escn_params(cfg, seed=1), charge=torch.tensor(0.),
                     spin=torch.tensor(1.)), device="cuda")
    n0 = dict(ek.launches)
    with pytest.raises(RuntimeError, match='edge_kernel="xla"'):
        opt = T.adam(1e-3)
        T.make_escn_train_step(cfg, opt)(p, opt.init(p), T.TrainBatch(
            *(t.cuda() for t in batch)))
    assert ek.launches == n0


@pytest.mark.parametrize("edge_kernel", list(EDGE_FN))
def test_stacked_images_on_card_match_one_image(edge_kernel):
    """Five escn-test images in one stacked pass (batch_chunk 5) through
    K1 / K3 / K4 with K2 against the images one at a time: each kernel
    launched once a layer for the chunk, not once an image, energies
    within 1e-6 relative and forces within TOL of max|F|."""
    _need_card()
    rng = np.random.default_rng(21)
    st = Structure(rng.choice([1, 6, 8], size=10).astype(np.int32),
                   rng.normal(scale=1.5, size=(10, 3)))
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=3)
    X = st.coords_bohr.reshape(1, -1) + 0.05 * rng.normal(size=(5, 30))
    out = {}
    for chunk in (1, 5):
        calc = make_uma_calculator(st, model="escn-test", device="cuda",
                                   params=w, edge_kernel=edge_kernel,
                                   batch_chunk=chunk)
        n0 = {**ek.launches, **fk.launches}
        out[chunk] = calc.get_forces_batch(X)
        moved = {k: v - n0[k] for k, v in {**ek.launches,
                                            **fk.launches}.items()
                 if v != n0[k]}
        layers = ESCN_CONFIGS["escn-test"].num_layers
        key = EDGE_FN[edge_kernel]
        per = layers * (5 // chunk)
        assert moved == {f"{key}_fwd": per, f"{key}_bwd": per,
                         "fused_node_ffn_fwd": per,
                         "fused_node_ffn_bwd": per}
    e1, e5 = out[1]["energy"], out[5]["energy"]
    assert np.abs(e5 - e1).max() <= 1e-6 * np.abs(e1).max()
    f1, f5 = out[1]["forces"], out[5]["forces"]
    assert np.abs(f5 - f1).max() <= TOL * np.abs(f1).max()


def test_batched_hvp_on_card_matches_single_hvps():
    """Eight HVP tangents of escn-md at 64 atoms in one batched backward of
    the plain path (is_grads_batched) against eight single backwards on
    the same graph, within 1e-5 of max|Hv|, no kernel launched."""
    _need_card()
    rng = np.random.default_rng(4)
    st = Structure(rng.choice([1, 6, 7, 8], size=64).astype(np.int32),
                   rng.normal(scale=4.0, size=(64, 3)))
    calc = make_uma_calculator(st, model="escn-md", device="cuda", seed=0)
    c, g = calc._grad_graph(calc._to_pad_ang(st.coords_bohr), calc.system,
                            calc.params)
    V = torch.zeros((8, c.numel()), **F32)
    V[torch.arange(8), torch.arange(8) * 11] = 1.0
    V = V.view(8, *c.shape)
    n0 = {**ek.launches, **fk.launches}
    hb = calc._vjp(c, g, V, batched=True)
    hs = torch.stack([calc._vjp(c, g, v) for v in V])
    assert {**ek.launches, **fk.launches} == n0
    assert float((hb - hs).abs().max()) <= 1e-5 * float(hs.abs().max())


# ---- the GSM device loop: captured CUDA graphs -----------------------------

def _replay_closure(calc, x):
    """The calculator's batched closure captured in one device-loop cycle
    (``runtime.device_loop.Cycle``) and replayed: (E, F, the cycle)."""
    from pdb2reaction_tpu_torch.runtime import device_loop
    eb = calc.au_energy_force_batch_fn()
    n = x.shape[0]

    def body(s):
        e, f = eb(s[0])
        return s[0], e, f, s[3] + 1

    st = (x.clone(), x.new_zeros(n), torch.zeros_like(x),
          torch.zeros((), dtype=torch.int64, device=x.device))
    cyc = device_loop.Cycle(lambda s: s[3] < 1, body, st)
    n0 = calc.force_calls
    assert cyc.run() == (1, [False])
    assert calc.force_calls == n0 + n        # the cycle that took effect
    return cyc.state[1], cyc.state[2], cyc


@pytest.mark.parametrize("edge_kernel", list(EDGE_FN))
def test_captured_escn_closure_replays_eager_bit_for_bit(edge_kernel):
    """escn-test's batched force closure in each edge-kernel layout,
    captured into a CUDA graph: its replay gives the eager call's
    energies and forces bit for bit, and the capture recorded the layout's
    edge kernel and K2, forward and backward, once an image a layer."""
    _need_card()
    st = _lattice(24, seed=4)
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=1)
    calc = make_uma_calculator(st, model="escn-test", params=w,
                               edge_kernel=edge_kernel)
    rng = np.random.default_rng(3)
    x = torch.stack([calc.pad_bohr(st.coords_bohr + rng.normal(
        scale=0.05, size=st.coords.shape)) for _ in range(3)])
    e0, f0 = calc.au_energy_force_batch_fn()(x)
    e, f, cyc = _replay_closure(calc, x)
    assert torch.equal(e, e0) and torch.equal(f, f0)
    base = EDGE_FN[edge_kernel]
    L = ESCN_CONFIGS["escn-test"].num_layers
    assert cyc.stats()["launches"] == {
        f"{base}_fwd": 3 * L, f"{base}_bwd": 3 * L,
        "fused_node_ffn_fwd": 3 * L, "fused_node_ffn_bwd": 3 * L}
    assert cyc.stats()["replays"] == 2       # the stop, then one no-op


def test_captured_pallas_closure_replays_eager_bit_for_bit():
    """The small PaiNN model in mp_mode="pallas": K5 on its tile plan
    (``tile_plan_fixed``, no host read) inside the graph gives the eager
    call's bits; 2L / 2L - 1 / 2L K5 launches an image recorded at the
    capture."""
    _need_card()
    rng = np.random.default_rng(6)
    st = Structure(rng.choice([1, 6, 8], size=96).astype(np.int32),
                   rng.normal(scale=3.0, size=(96, 3)))
    cfg = dataclasses.replace(CONFIGS["small"], mp_mode="pallas")
    calc = make_uma_calculator(st, model="small", mp_mode="pallas", seed=2)
    x = torch.stack([calc.pad_bohr(st.coords_bohr + rng.normal(
        scale=0.05, size=st.coords.shape)) for _ in range(2)])
    e0, f0 = calc.au_energy_force_batch_fn()(x)
    e, f, cyc = _replay_closure(calc, x)
    assert torch.equal(e, e0) and torch.equal(f, f0)
    L = cfg.n_layers
    got = cyc.stats()["launches"]
    assert got == {"radial_contract_fwd": 2 * 2 * L,
                   "radial_contract_bwd_feats": 2 * (2 * L - 1),
                   "radial_contract_bwd_coords": 2 * 2 * L}, got


@pytest.mark.parametrize("model", ["escn-test", "small"])
def test_gsm_device_loop_on_card_matches_host(model):
    """A 20-atom string through loop="device" (captured graphs) and
    loop="host" on the card, the climbing image and its Lanczos tangent
    on: the same cycles, force calls, HEI and convergence, and the
    calculator counting exactly the string's force calls; images within
    1e-6 Bohr (float32 forces: the graphs run the same kernels on the
    same inputs)."""
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    from pdb2reaction_tpu_torch.runtime import device_loop
    _need_card()
    st = _lattice(20, seed=5)
    rng = np.random.default_rng(7)
    xB = st.coords + rng.normal(scale=0.1, size=st.coords.shape)
    out = {}
    for loop in ("device", "host"):
        calc = make_uma_calculator(st, model=model, seed=3,
                                   **({"mp_mode": "pallas"}
                                      if model == "small" else {}))
        n0 = calc.force_calls
        out[loop] = gsm_mep(calc.au_energy_force_batch_fn(),
                            calc.pad_bohr(st.coords_bohr),
                            calc.pad_bohr(xB * ANG2BOHR),
                            calc.system.free_mask, max_nodes=6,
                            max_cycles=14, conv_perp_rms=2e-2,
                            climb_rms=3e-2, hvp_fn=calc.au_hvp_fn(),
                            loop=loop)
        assert calc.force_calls - n0 == out[loop].force_calls
    d, h = out["device"], out["host"]
    assert (d.cycles, d.force_calls, d.hei_idx, d.converged) == \
        (h.cycles, h.force_calls, h.hei_idx, h.converged)
    assert np.abs(d.images - h.images).max() <= 1e-6
    replays = sum(c.replays for c in device_loop.cycles())
    assert replays > 0
    device_loop.clear_cache()


def test_device_loop_refuses_collective_closures_on_card():
    """A closure marked collective (a data axis, sharding) is refused by
    loop="device" on CUDA before any launch."""
    from pdb2reaction_tpu_torch.engines.gsm import gsm_mep
    _need_card()
    st = _lattice(8, seed=1)
    calc = make_uma_calculator(st, model="small", seed=0)
    eb = calc.au_energy_force_batch_fn()

    def shared(x):
        return eb(x)

    shared.collective = True
    before = _all_counts()
    with pytest.raises(ValueError, match="loop='host'"):
        gsm_mep(shared, calc.pad_bohr(st.coords_bohr),
                calc.pad_bohr(st.coords_bohr + 0.1), calc.system.free_mask,
                max_nodes=4, loop="device")
    assert _moved(before) == {}
