"""The eSCN ``pallas-full`` (K3, ``fused_edge_block``) and ``pallas``
(K4, ``fused_edge_chain``) edge layouts of the port against the JAX
package.

On the CPU the JAX kernels run in interpret mode at f32 and the port's
wrappers take their plain PyTorch versions, so the kernel tests hold the
plain versions to the JAX kernels (values and every input cotangent,
1e-5 of max|ref|), and the model tests hold the port's ``escn_energy``
with each ``edge_kernel`` to JAX ``escn_energy`` with the same one (the
JAX bar of ``tests/test_escn.py``: 1e-5). The CUDA kernels are held to
the plain versions by ``test_torch_gpu.py`` on a card.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_block as j_fused_edge_block
from pdb2reaction_tpu.mlip.escn_edge_kernel import \
    fused_edge_chain as j_fused_edge_chain
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.mlip.escn import ESCN_CONFIGS as TCFG
from pdb2reaction_tpu_torch.mlip.escn import (escn_energy, escn_energy_fn,
                                              init_escn_params)
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator

from test_torch_escn import cluster, jax_energy_forces, jax_weights_np
from test_torch_escn_kernels import (EDGE_CASES, _edge_inputs, _jax_weights,
                                     _torch_weights)

VARIANTS = ("pallas-full", "pallas")


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _block_inputs(name, over, P, seed):
    """K3's inputs from the shared edge inputs: gathered source rows,
    repeated target rows, and a per-edge cotangent."""
    jcfg, tcfg, w, (x, src, es, dp, dpe), tabs, _ = _edge_inputs(
        name, over, P, seed)
    E = src.shape[0]
    g = np.random.default_rng(seed + 1).normal(
        size=(x.shape[0], E)).astype(np.float32)
    xs = np.ascontiguousarray(x[:, src])
    xt = np.repeat(x, tcfg.max_neighbors, axis=1)
    return jcfg, tcfg, w, (xs, xt, es, dp, dpe), tabs, g


def _chain_inputs(name, over, P, seed):
    jcfg, tcfg, w, (x, src, es, dp, dpe), tabs, _ = _edge_inputs(
        name, over, P, seed)
    nl0, nls, U, G = ek._dims(tcfg)
    C = tcfg.sphere_channels
    E = src.shape[0]
    rng = np.random.default_rng(seed + 2)
    pr = rng.normal(size=(U * 2 * C, E)).astype(np.float32)
    g = rng.normal(size=(U * C, E)).astype(np.float32)
    return jcfg, tcfg, w, (pr, es), tabs, g


def _both(j_fn, t_fn, jcfg, tcfg, w, ins, tabs, g):
    """(values, cotangents) of the JAX kernel and the port's wrapper."""
    tab_j = tuple(jnp.asarray(t, jnp.float32) for t in tabs)
    y_j, vjp = jax.vjp(lambda *a: j_fn(jcfg, *a, _jax_weights(w), tab_j),
                       *(jnp.asarray(a) for a in ins))
    gj = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    y_t = t_fn(tcfg, *leaves, _torch_weights(w),
               tuple(torch.as_tensor(t, dtype=torch.float32) for t in tabs))
    gt = torch.autograd.grad(y_t, leaves, torch.as_tensor(g))
    return (np.asarray(y_j), [np.asarray(a) for a in gj],
            y_t.detach().numpy(), [a.numpy() for a in gt])


@pytest.mark.parametrize("name,over,P", EDGE_CASES)
def test_edge_block_plain_matches_jax_interpret(name, over, P):
    """K3: values and the cotangents of xs, xt, es, Dp and Dpe."""
    args = _block_inputs(name, over, P, seed=7)
    y_j, gj, y_t, gt = _both(j_fused_edge_block, ek.fused_edge_block, *args)
    assert y_t.shape == y_j.shape
    assert _close(y_t, y_j)
    assert len(gt) == 5
    for a, b in zip(gt, gj):
        assert _close(a, b)


@pytest.mark.parametrize("name,over,P", EDGE_CASES)
def test_edge_chain_plain_matches_jax_interpret(name, over, P):
    """K4: values and the cotangents of pr and es."""
    args = _chain_inputs(name, over, P, seed=9)
    y_j, gj, y_t, gt = _both(j_fused_edge_chain, ek.fused_edge_chain, *args)
    assert y_t.shape == y_j.shape
    assert _close(y_t, y_j)
    assert len(gt) == 2
    for a, b in zip(gt, gj):
        assert _close(a, b)


@pytest.mark.parametrize("edge_kernel", VARIANTS)
def test_escn_variant_matches_jax_same_variant(edge_kernel):
    """Port escn_energy with an edge_kernel against JAX escn_energy with
    the same edge_kernel (Pallas in interpret mode): energy and forces to
    1e-5."""
    p, jcfg = jax_weights_np("escn-test", jnp.float32, seed=4,
                             edge_kernel=edge_kernel)
    zs, xyz, n_pad = cluster(10, 16, 4)
    e_j, f_j = jax_energy_forces(p, jcfg, zs, xyz, n_pad)
    cfg = dataclasses.replace(TCFG["escn-test"], edge_kernel=edge_kernel)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    c = sysp.coords.float().requires_grad_(True)
    e_t = escn_energy(c, sysp, params_from_jax(p, dtype=torch.float32), cfg)
    (g,) = torch.autograd.grad(e_t, c)
    assert abs(float(e_t.detach()) - e_j) <= 1e-5 * max(1.0, abs(e_j))
    assert _close(-g.numpy(), f_j)


def _perturbed(tree, rng):
    """Every float array of a weight tree plus N(0, 0.05) noise (non-zero
    biases)."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, rng) for v in tree]
    if tree.is_floating_point() and tree.ndim > 0:
        return tree + torch.as_tensor(0.05 * rng.normal(size=tree.shape),
                                      dtype=tree.dtype)
    return tree


def test_variants_agree_in_f64():
    """The three layouts are one function: f64 energies and forces agree
    to 1e-10 on the CPU (the port's own seeded weights, perturbed)."""
    cfg64 = dataclasses.replace(TCFG["escn-test"], dtype=torch.float64)
    params = _perturbed(init_escn_params(cfg64, seed=6),
                        np.random.default_rng(6))
    params.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0),
                  task=torch.tensor(0.0))
    zs, xyz, n_pad = cluster(11, 16, 6)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    got = []
    for ek_name in ("pallas-mega",) + VARIANTS:
        cfg = dataclasses.replace(cfg64, edge_kernel=ek_name)
        c = sysp.coords.clone().requires_grad_(True)
        e = escn_energy(c, sysp, params, cfg)
        (g,) = torch.autograd.grad(e, c)
        got.append((float(e.detach()), g.numpy()))
    (e0, g0) = got[0]
    for e, g in got[1:]:
        assert abs(e - e0) <= 1e-10 * max(1.0, abs(e0))
        assert np.abs(g - g0).max() <= 1e-10 * max(1.0, np.abs(g0).max())


@pytest.mark.parametrize("edge_kernel", ["xla", "pallas-mega-v2"])
def test_unported_or_unknown_edge_kernel_raises(edge_kernel):
    """An unknown edge layout raises. "xla", the all-plain variant, is
    ported: it runs the plain reduced edge path and gives the default
    layout's plain-path (plain K1) energy in float64."""
    zs, xyz, n_pad = cluster(4, 8, 0)
    sysp = pad_to(Structure(zs, xyz), n_pad=n_pad)
    cfg = dataclasses.replace(TCFG["escn-test"], edge_kernel=edge_kernel,
                              dtype=torch.float64)
    params = init_escn_params(cfg)
    st = Structure(zs, xyz)
    if edge_kernel == "xla":
        params.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0),
                      task=torch.tensor(0.0))
        e = escn_energy(sysp.coords, sysp, params, cfg)
        e0 = escn_energy(sysp.coords, sysp, params,
                         dataclasses.replace(cfg, edge_kernel="pallas-mega"))
        assert abs(float(e) - float(e0)) <= 1e-12 * abs(float(e0))
        make_uma_calculator(st, model="escn-test", device="cpu",
                            edge_kernel=edge_kernel)
        return
    with pytest.raises(ValueError, match="edge_kernel"):
        escn_energy(sysp.coords.float(), sysp, params, cfg)
    with pytest.raises(ValueError):
        make_uma_calculator(st, model="escn-test", device="cpu",
                            edge_kernel=edge_kernel)


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors go to the plain versions, and no launch is counted."""
    before = dict(ek.launches)
    _, tcfg, w, ins, tabs, _ = _block_inputs("escn-test", {}, 8, seed=1)
    wt = _torch_weights(w)
    tt = tuple(torch.as_tensor(t, dtype=torch.float32) for t in tabs)
    ins = tuple(torch.as_tensor(a) for a in ins)
    assert torch.equal(ek.fused_edge_block(tcfg, *ins, wt, tt),
                       ek.fused_edge_block_plain(tcfg, *ins, wt, tt))
    _, tcfg, w, ins, tabs, _ = _chain_inputs("escn-test", {}, 8, seed=1)
    ins = tuple(torch.as_tensor(a) for a in ins)
    assert torch.equal(ek.fused_edge_chain(tcfg, *ins, wt, tt),
                       ek.fused_edge_chain_plain(tcfg, *ins, wt, tt))
    x = torch.randn(5, 3)
    src = torch.tensor([4, 0, 0, 2])
    assert torch.equal(ek.gather_src(x, src, src > 0), x[src])
    assert ek.launches == before


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_factory_honours_edge_kernel(how, monkeypatch):
    rng = np.random.default_rng(0)
    st = Structure(rng.choice([1, 6, 8], size=6).astype(np.int32),
                   rng.normal(scale=1.4, size=(6, 3)))
    kw = {}
    if how == "argument":
        kw["edge_kernel"] = "pallas"
    else:
        monkeypatch.setenv("PDB2R_TPU_ESCN_KERNEL", "pallas")
    calc = make_uma_calculator(st, model="escn-test", device="cpu", seed=1,
                               dtype=torch.float64, **kw)
    assert calc.cfg.edge_kernel == "pallas"
    monkeypatch.delenv("PDB2R_TPU_ESCN_KERNEL", raising=False)
    ref = make_uma_calculator(st, model="escn-test", device="cpu", seed=1,
                              dtype=torch.float64)
    assert ref.cfg.edge_kernel == "pallas-mega"
    cb = st.coords_bohr.reshape(-1)
    r, r0 = calc.get_forces(cb), ref.get_forces(cb)
    assert abs(r["energy"] - r0["energy"]) < 1e-10
    assert np.abs(r["forces"] - r0["forces"]).max() < 1e-10


def test_calculator_defaults_to_the_card():
    """Calculator() with no device asks for the card: without one it
    raises; device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    st = Structure(np.array([1, 1], np.int32), [[0, 0, 0], [0.7, 0, 0]])
    fn = escn_energy_fn(TCFG["escn-test"])
    with pytest.raises(RuntimeError, match="cuda"):
        Calculator(st, fn)
    assert Calculator(st, fn, device="cpu").device.type == "cpu"
