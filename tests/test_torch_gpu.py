"""Card tests of the port: each CUDA kernel against its plain PyTorch
version, and the escn calculator on the card against the CPU plain path.

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

from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS, _edge_grid_tables
from pdb2reaction_tpu_torch.mlip.escn import init_escn_params
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
    w_g = (w[0].clone().requires_grad_(True),) + w[1:]
    with pytest.raises(NotImplementedError):
        ek.fused_edge_mega(cfg, ins[0], src, ins[1], ins[2], ins[3], w_g,
                           tabs)
    with pytest.raises(TypeError):
        ek.fused_edge_mega(cfg, ins[0].double(), src, ins[1], ins[2],
                           ins[3], w, tabs)


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


def test_calculator_on_card_matches_cpu_f64():
    _need_card()
    rng = np.random.default_rng(2)
    st = Structure(rng.choice([1, 6, 8], size=20).astype(np.int32),
                   rng.normal(scale=2.0, size=(20, 3)))
    w = init_escn_params(ESCN_CONFIGS["escn-test"], seed=1)
    gpu = make_uma_calculator(st, model="escn-test", params=w)
    cpu = make_uma_calculator(st, model="escn-test", params=w, device="cpu",
                              dtype=torch.float64)
    cb = st.coords_bohr.reshape(-1)
    n0 = dict(ek.launches), dict(fk.launches)
    rg, rc = gpu.get_forces(cb), cpu.get_forces(cb)
    assert np.abs(rg["forces"] - rc["forces"]).max() \
        <= TOL * np.abs(rc["forces"]).max()
    assert all(ek.launches[k] > n0[0][k] for k in ek.launches)
    assert all(fk.launches[k] > n0[1][k] for k in fk.launches)
