"""Port Hessians and Hessian-vector products (``Calculator.get_hessian``,
``au_hvp_fn``, ``free_dof_mask``) against the JAX Calculator on the same
inputs and weights:

- Morse, escn-test (JAX: its XLA path; port: the kernel layout's
  calculator, whose Hessian closure is the all-plain "xla" variant) and
  the PaiNN-class ``small`` model in the dense mode, all float64: the
  analytic and finite-difference Hessians and the HVPs to 1e-8 x max|H|;
- ``small`` in the pallas mode, which computes in float32 in both
  packages: the Hessian through K5's plain version to 1e-5 x max|H| (a
  float32 tolerance: the two frameworks order the float32 sums
  differently), and to 1e-4 x max|H| against the port's own dense-mode
  float64 Hessian (what float32 itself loses in a second derivative);
- partial Hessians with frozen atoms, force-call counts of the FD
  Hessian, the refusals under atom-axis sharding, and a second
  derivative that reaches a kernel's autograd function raising."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip import potentials as jpot
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.model import energy_fn as j_painn_energy
from pdb2reaction_tpu_torch.constants import H_EVAA_2_AU
from pdb2reaction_tpu_torch.core.structure import Structure
from pdb2reaction_tpu_torch.mlip import escn_edge_kernel as ek
from pdb2reaction_tpu_torch.mlip import escn_ffn_kernel as fk
from pdb2reaction_tpu_torch.mlip import potentials
from pdb2reaction_tpu_torch.mlip import radial_contract as rc
from pdb2reaction_tpu_torch.mlip.cuda_build import first_order
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
from pdb2reaction_tpu_torch.parallel import SpatialGroup
from pdb2reaction_tpu_torch.parallel.spatial import (
    make_spatial_energy_fn, make_spatial_hessian_energy_fn)

from test_torch_calculator import _pair
from test_torch_painn import jax_painn, molecule

TOL = 1e-8          # max|dH| / max|H|, float64 paths


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _hvps(calc, cb, cols, jax_side):
    """HVPs of the unit tangents ``cols`` at cb through ``au_hvp_fn``."""
    hvp = calc.au_hvp_fn()
    x = calc.pad_bohr(cb)
    out = []
    for k in cols:
        if jax_side:
            v = np.zeros(x.shape)
            v.reshape(-1)[k] = 1.0
            out.append(np.asarray(hvp(x, jnp.asarray(v))))
        else:
            v = torch.zeros_like(x)
            v.view(-1)[k] = 1.0
            out.append(hvp(x, v).numpy())
    return np.stack(out)


def _morse_pair(freeze=(), **kw):
    rng = np.random.default_rng(3)
    zs = np.array([8, 1, 1, 6, 1], np.int32)
    xyz = rng.normal(scale=1.0, size=(5, 3))
    jc = JCalculator(JStructure(zs, xyz), jpot.make_morse(),
                     freeze_atoms=list(freeze), **kw)
    tc = Calculator(Structure(zs, xyz), potentials.make_morse(),
                    freeze_atoms=list(freeze), device="cpu", **kw)
    return jc, tc, Structure(zs, xyz).coords_bohr.reshape(-1)


def _painn_pair(mp_mode, freeze=(), weights=None):
    jdt = jnp.float32 if mp_mode == "pallas" else jnp.float64
    p, cfg = weights or jax_painn("small", jdt, seed=3)
    cfg = dataclasses.replace(cfg, mp_mode=mp_mode)
    zs, xyz = molecule(5, seed=8)

    def jfn(coords, system, params):
        return j_painn_energy(coords, system, params, cfg)

    jc = JCalculator(JStructure(zs, xyz), jfn,
                     params=jtu.tree_map(jnp.asarray, p),
                     freeze_atoms=list(freeze))
    tc = make_uma_calculator(
        Structure(zs, xyz), model="small", mp_mode=mp_mode, device="cpu",
        dtype=torch.float64 if mp_mode != "pallas" else torch.float32,
        params=params_from_jax(p), freeze_atoms=list(freeze))
    return jc, tc, Structure(zs, xyz).coords_bohr.reshape(-1)


def _pair_of(kind, freeze=()):
    if kind == "morse":
        return _morse_pair(freeze)
    if kind == "escn-test":
        return _pair(freeze=list(freeze), seed=4, n=5)
    return _painn_pair(kind.split("-")[1], freeze)


@pytest.mark.parametrize("kind", ["morse", "escn-test", "small-dense"])
def test_analytic_hessian_and_hvps_match_jax(kind):
    jc, tc, cb = _pair_of(kind, freeze=[1])
    assert tc.hessian_calc_mode == "Analytical"
    if kind == "escn-test":
        # the force path is the kernel layout; the Hessian closure the
        # all-plain variant
        assert tc.cfg.edge_kernel == "pallas-mega"
        assert tc.energy_fn_hessian is not None
    np.testing.assert_array_equal(tc.free_dof_mask, jc.free_dof_mask)
    H_j = jc.get_hessian(cb)["hessian"]
    H_t = tc.get_hessian(cb)["hessian"]
    assert H_t.shape == H_j.shape == (cb.size, cb.size)
    assert H_t.dtype == np.float64
    assert _rel(H_t, H_j) <= TOL
    np.testing.assert_array_equal(H_t, H_t.T)
    assert np.all(H_t[3:6] == 0.0) and np.all(H_t[:, 3:6] == 0.0)
    assert tc.force_calls == 1                  # get_hessian's own forces
    cols = [0, 4, 7, 3 * cb.size // 3 - 1]
    hv_j = _hvps(jc, cb, cols, True)
    hv_t = _hvps(tc, cb, cols, False)
    assert _rel(hv_t, hv_j) <= TOL
    assert np.all(hv_t[:, 1] == 0.0) and np.all(hv_t[:, tc.n_atoms:] == 0.0)
    assert tc.force_calls == 1                  # HVPs count no force call


def test_pallas_mode_hessian_plain_route_f32():
    """PaiNN pallas mode: the Hessian closure runs K5's plain version; the
    mode computes in float32 in both packages."""
    jc, tc, cb = _painn_pair("pallas", freeze=[0])
    assert tc.energy_fn_hessian is not None
    H_j = jc.get_hessian(cb)["hessian"]
    H_t = tc.get_hessian(cb)["hessian"]
    assert _rel(H_t, H_j) <= 1e-5
    # the same weights in the port's dense mode, float64
    p, cfg = jax_painn("small", jnp.float32, seed=3)
    p64 = jtu.tree_map(lambda a: a.astype(np.float64)
                       if a.dtype.kind == "f" else a, p)
    _, td, _ = _painn_pair("dense", freeze=[0],
                           weights=(p64, dataclasses.replace(
                               cfg, dtype=jnp.float64)))
    assert _rel(H_t, td.get_hessian(cb)["hessian"]) <= 1e-4
    hv_j = _hvps(jc, cb, [3, 8], True)
    hv_t = _hvps(tc, cb, [3, 8], False)
    assert _rel(hv_t, hv_j) <= 1e-5


@pytest.mark.parametrize("kind", ["morse", "escn-test"])
def test_fd_hessian_matches_jax_and_counts(kind):
    jc, tc, cb = _pair_of(kind, freeze=[2])
    for c in (jc, tc):
        c.hessian_calc_mode = "FiniteDifference"
    H_j = jc.get_hessian(cb)["hessian"]
    n0 = tc.force_calls
    H_t = tc.get_hessian(cb)["hessian"]
    assert _rel(H_t, H_j) <= TOL
    n_free = int(tc.free_dof_mask.sum())
    assert n_free == cb.size - 3
    # 2 n_free displaced force calls and one at the point, as in JAX
    assert tc.force_calls - n0 == jc.force_calls == 2 * n_free + 1
    # and the analytic Hessian agrees to the FD truncation error
    tc.hessian_calc_mode = "Analytical"
    assert _rel(H_t, tc.get_hessian(cb)["hessian"]) <= 1e-5


def test_partial_hessian_frozen():
    """The JAX package's partial-Hessian checks (``test_calculator.py``):
    the free block alone, or the full matrix with frozen rows and columns
    zero; float32 on request."""
    jc, tc, cb = _morse_pair(freeze=[0, 3], return_partial_hessian=True)
    H = tc.get_hessian(cb)["hessian"]
    assert H.shape == (9, 9)
    assert _rel(H, jc.get_hessian(cb)["hessian"]) <= TOL
    _, tc2, _ = _morse_pair(freeze=[0, 3], hessian_double=False)
    H2 = tc2.get_hessian(cb)["hessian"]
    assert H2.shape == (15, 15) and H2.dtype == np.float32
    assert np.all(H2[:3] == 0.0) and np.all(H2[:, 9:12] == 0.0)
    free = tc2.free_dof_mask
    np.testing.assert_allclose(H2[np.ix_(free, free)], H, rtol=1e-6)
    # H2 atoms: analytic Morse Hessian against the FD one (test_calculator)
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.85, 0, 0]])
    ca = Calculator(st, potentials.make_morse(), device="cpu")
    cf = Calculator(st, potentials.make_morse(), device="cpu",
                    hessian_calc_mode="FiniteDifference")
    x0 = st.coords_bohr.reshape(-1)
    np.testing.assert_allclose(ca.get_hessian(x0)["hessian"],
                               cf.get_hessian(x0)["hessian"], atol=1e-5)


def test_sharded_hessian_raises_and_kernel_guard():
    # the Hessian and an HVP through the sharded closures of a one-rank
    # group (no process group needed) equal the unsharded calculator's,
    # eSCN on its "xla" Hessian closure and the PaiNN pallas mode on K6's
    # plain version
    rng = np.random.default_rng(5)
    st = Structure(np.array([8, 1, 1, 6, 1, 7], np.int32),
                   rng.normal(scale=1.1, size=(6, 3)))
    group = SpatialGroup(0, 1, torch.device("cpu"), "gloo")
    cb = st.coords_bohr.reshape(-1)
    for model, kw, rtol in (("escn-test", {"dtype": torch.float64}, 1e-10),
                            ("small", {"mp_mode": "pallas"}, 1e-5)):
        ref = make_uma_calculator(st, model=model, device="cpu", **kw)
        sh = Calculator(
            st, make_spatial_energy_fn(ref.cfg, group), params=ref.params,
            device="cpu",
            energy_fn_hessian=make_spatial_hessian_energy_fn(ref.cfg, group))
        H0 = ref.get_hessian(cb)["hessian"]
        np.testing.assert_allclose(sh.get_hessian(cb)["hessian"], H0,
                                   rtol=rtol, atol=rtol * np.abs(H0).max())
        x = ref.pad_bohr(cb)
        v = torch.as_tensor(rng.normal(size=tuple(x.shape)))
        hv0 = ref.au_hvp_fn()(x, v).numpy()
        np.testing.assert_allclose(sh.au_hvp_fn()(x, v).numpy(), hv0,
                                   rtol=rtol, atol=rtol * np.abs(hv0).max())
    # a second derivative through a kernel's autograd function raises
    # instead of dropping the kernel's missing double-backward terms,
    # for the Hessian and for an HVP alike
    st = Structure.from_symbols(["H", "H"], [[0, 0, 0], [0.9, 0, 0]])
    calc = Calculator(st, _through_a_first_order_fn(), device="cpu")
    assert np.isfinite(calc.get_forces(st.coords_bohr)["forces"]).all()
    with pytest.raises(RuntimeError, match="double backward"):
        calc.get_hessian(st.coords_bohr)
    x = calc.pad_bohr(st.coords_bohr)
    with pytest.raises(RuntimeError, match="double backward"):
        calc.au_hvp_fn()(x, torch.ones_like(x))


class _SquareFn(torch.autograd.Function):
    """x**2 with a first-order-only backward, as the kernels' functions."""
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    @first_order
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 2.0 * x * g


def _through_a_first_order_fn():
    """Morse with its coordinates passed through ``_SquareFn`` and back,
    so its energy is unchanged but its gradient crosses the function."""
    morse = potentials.make_morse()

    def fn(c, system, params):
        return morse(_SquareFn.apply(c + 10.0).sqrt() - 10.0, system,
                     params)
    return fn


def test_first_order_backward_refuses_create_graph():
    """``first_order`` passes a plain backward through unchanged and
    raises on one taken with ``create_graph=True``, also where the
    incoming cotangent is a constant (``once_differentiable`` would let
    that one through without the function's second-order terms)."""
    x = torch.tensor([1.5, -2.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(_SquareFn.apply(x).sum(), x)
    np.testing.assert_array_equal(g.numpy(), [3.0, -4.0])
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(_SquareFn.apply(x).sum(), x, create_graph=True)


@pytest.mark.parametrize("fn", [
    ek._GatherFn, ek._MegaFn, ek._BlockFn, ek._ChainFn, fk._FfnFn,
    rc._RadialContractFn, rc._RadialContractRectFn],
    ids=lambda f: f.__name__)
def test_kernel_functions_refuse_double_backward(fn):
    """Every CUDA kernel's autograd function is first order only: its
    backward raises under grad mode (a create_graph backward) before it
    reads its context or launches anything."""
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="double backward"):
        fn.backward(None, torch.zeros(1))


def test_analytic_hessian_takes_free_tangents_only():
    """The analytic Hessian runs one HVP a free DOF: on a frozen
    escn-test system it equals, bit for bit on the free block, the
    symmetrised rows of every real-atom tangent, and is zero elsewhere."""
    _, tc, cb = _pair_of("escn-test", freeze=[0, 3])
    n3 = cb.size
    free = tc.free_dof_mask
    seen = []
    orig = Calculator._vjp

    def spy(c, g, v):
        seen.append(int(torch.nonzero(v.reshape(-1))[0]))
        return orig(c, g, v)

    Calculator._vjp = staticmethod(spy)
    try:
        H = tc._analytic_hessian(cb)
    finally:
        Calculator._vjp = staticmethod(orig)
    assert seen == list(np.nonzero(free)[0])
    c, g = tc._grad_graph(tc._to_pad_ang(cb), tc.system, tc.params)
    rows = []
    for k in range(n3):
        v = torch.zeros_like(c)
        v.view(-1)[k] = 1.0
        rows.append(Calculator._vjp(c, g, v).reshape(-1)[:n3])
    R = torch.stack(rows).double().numpy()
    full = 0.5 * (R + R.T) * H_EVAA_2_AU
    fb = np.ix_(free, free)
    np.testing.assert_array_equal(H[fb], full[fb])
    assert np.all(H[~free] == 0.0) and np.all(H[:, ~free] == 0.0)
    np.testing.assert_array_equal(tc.get_hessian(cb)["hessian"], H)
