"""Chunked batching in the port's Calculator, float64 on the CPU:
``batch_chunk`` / ``PDB2R_TPU_BATCH_CHUNK`` for image batches,
``PDB2R_TPU_HVP_CHUNK`` for the analytic Hessian's tangents (a chunk one
batched backward, vmap over the double backward of the Hessian closure)
and ``PDB2R_TPU_FD_CHUNK`` for the FD Hessian's displacements (a chunk
one force pass). escn-test stacks a chunk's images along the atom axis
(``escn_energy_images``) in every edge layout, here on the kernels'
plain twins; the PaiNN-class ``small`` runs a chunk's images one after
another.

- chunked against one item at a time: 1e-12 of max|H| or max|F|;
- against the JAX Calculator chunked the same way: the tolerances of
  tests/test_torch_hessian.py (1e-8 of max|H|) and of
  tests/test_torch_calculator.py (1e-8 Ha, 1e-7 Ha/Bohr);
- force calls as one at a time counts them, the chunk sizes each
  setting gives, a shorter tail chunk (5 images at chunk 2: 2, 2, 1);
- every test turns PyTorch's "There is a performance drop" warning (an
  op of the batched backward without a batching rule, looped) into an
  error.

The chunks over a data axis of four gloo ranks are in
tests/test_torch_mesh.py (``test_chunks_over_data_ranks``)."""

import dataclasses

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.mlip.calculator import Calculator as JCalculator
from pdb2reaction_tpu.mlip.escn import ESCN_CONFIGS as JCFG
from pdb2reaction_tpu.mlip.escn import ESCN_FN_FOR
from pdb2reaction_tpu.mlip.escn import premerge_escn_params as j_premerge
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import escn as E
from pdb2reaction_tpu_torch.mlip.calculator import Calculator
from pdb2reaction_tpu_torch.mlip.from_jax import params_from_jax
from pdb2reaction_tpu_torch.mlip.uma import make_uma_calculator
from pdb2reaction_tpu_torch.parallel.mesh import map_tree

from test_torch_hessian import TOL, _painn_pair, _rel

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

KINDS = ["escn-test", "small-dense"]
ENVS = ("PDB2R_TPU_BATCH_CHUNK", "PDB2R_TPU_HVP_CHUNK", "PDB2R_TPU_FD_CHUNK")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the systems are a few atoms, and under the
    parallel test run many threads a worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_chunk_env(monkeypatch):
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)


def escn_pair():
    """(JAX calculator, port calculator, coordinates, the raw weights as a
    numpy tree of the JAX package's layout) of escn-test on 5 atoms in
    float64, atom 1 frozen: the port's seeded weights with every float
    perturbed (non-zero biases), the same tree through both packages
    (JAX's own seeded init compiles for seconds)."""
    rng = np.random.default_rng(4)
    zs = rng.choice([1, 6, 8], size=5).astype(np.int32)
    xyz = rng.normal(scale=1.4, size=(5, 3))
    w = E.init_escn_params(E.ESCN_CONFIGS["escn-test"], seed=4)
    p = map_tree(w, lambda _, t: t.double().numpy()
                 + 0.05 * rng.normal(size=tuple(t.shape)))
    p.update(charge=np.float64(0.0), spin=np.float64(1.0),
             task=np.float64(0.0))
    jcfg = dataclasses.replace(JCFG["escn-test"], dtype=jnp.float64)
    jc = JCalculator(JStructure(zs, xyz), ESCN_FN_FOR(jcfg),
                     params=j_premerge(jtu.tree_map(jnp.asarray, p), jcfg),
                     freeze_atoms=[1])
    tc = make_uma_calculator(Structure(zs, xyz), model="escn-test",
                             freeze_atoms=[1], device="cpu",
                             dtype=torch.float64, params=params_from_jax(p))
    return jc, tc, Structure(zs, xyz).coords_bohr.reshape(-1), p


@pytest.fixture(scope="module")
def pairs():
    """kind -> (JAX calculator, port calculator, coordinates in Bohr),
    atom 1 frozen, built once."""
    return {"escn-test": escn_pair()[:3],
            "small-dense": _painn_pair("dense", [1])}


def fresh(pairs, kind, **kw):
    """(JAX calculator, a new port calculator over the same weights,
    coordinates); ``kw`` go to ``make_uma_calculator``."""
    jc, tc, cb = pairs[kind]
    model = "escn-test" if kind == "escn-test" else "small"
    kw.setdefault("freeze_atoms", [1])
    return jc, make_uma_calculator(tc.structure, model=model, device="cpu",
                                   dtype=torch.float64, params=tc.params,
                                   **kw), cb


def jax_calc(jc, **kw):
    """A JAX calculator over ``jc``'s weights and system."""
    return type(jc)(jc.structure, jc.energy_fn, params=jc.params, **kw)


class Count:
    """Records the size of each chunk ``fn`` is called with."""

    def __init__(self, fn, size):
        self.fn, self.size, self.sizes = fn, size, []
        for k, v in vars(fn).items():
            setattr(self, k, v)

    def __call__(self, *a, **kw):
        self.sizes.append(self.size(*a))
        return self.fn(*a, **kw)


def count_vjp(monkeypatch):
    sizes = []
    vjp = Calculator._vjp

    def counted(c, g, v, batched=False):
        sizes.append(v.shape[0] if batched else 1)
        return vjp(c, g, v, batched)
    monkeypatch.setattr(Calculator, "_vjp", staticmethod(counted))
    return sizes


@pytest.mark.parametrize("kind", KINDS)
def test_hvp_chunks(kind, pairs, monkeypatch):
    jc, tc, cb = fresh(pairs, kind)
    n_free = int(tc.free_dof_mask.sum())
    sizes = count_vjp(monkeypatch)
    monkeypatch.setenv("PDB2R_TPU_HVP_CHUNK", "1")
    H1 = tc.get_hessian(cb)["hessian"]
    assert sizes == [1] * n_free
    for chunk, want in (("3", [3] * (n_free // 3)), ("64", [n_free])):
        # (n_free = 12: no tail)
        sizes.clear()
        monkeypatch.setenv("PDB2R_TPU_HVP_CHUNK", chunk)
        Hc = tc.get_hessian(cb)["hessian"]
        assert sizes == want
        assert _rel(Hc, H1) <= 1e-12
    assert tc.force_calls == 3              # get_hessian's own forces
    # JAX's Hessian streamed in chunks of 3, vmapped 3 at a time
    monkeypatch.setenv("PDB2R_TPU_HVP_CHUNK", "3")
    assert _rel(Hc, jax_calc(jc, batch_chunk=3).get_hessian(cb)[
        "hessian"]) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_fd_chunks(kind, pairs, monkeypatch):
    jc, tc, cb = fresh(pairs, kind, hessian_calc_mode="FiniteDifference")
    n_free = int(tc.free_dof_mask.sum())
    stacked = tc.energy_fn_images is not None
    assert stacked == (kind == "escn-test")
    if stacked:
        tc.energy_fn_images = Count(tc.energy_fn_images,
                                    lambda c, *_: c.shape[0])
    monkeypatch.setenv("PDB2R_TPU_FD_CHUNK", "1")
    H1 = tc.get_hessian(cb)["hessian"]
    assert tc.force_calls == 2 * n_free + 1
    monkeypatch.setenv("PDB2R_TPU_FD_CHUNK", "4")
    H4 = tc.get_hessian(cb)["hessian"]
    assert tc.force_calls == 2 * (2 * n_free + 1)
    assert _rel(H4, H1) <= 1e-12
    if stacked:
        # one stacked pass a chunk of 4 (a chunk of one takes the
        # one-image path)
        assert tc.energy_fn_images.sizes == [4] * (2 * n_free // 4)
    assert _rel(H4, jax_calc(jc, batch_chunk=4,
                             hessian_calc_mode="FiniteDifference")
                .get_hessian(cb)["hessian"]) <= TOL


def images(cb, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return cb[None] + 0.05 * rng.normal(size=(n, cb.size))


@pytest.mark.parametrize("layout", list(E.EDGE_LAYOUTS) + ["small-dense"])
def test_image_chunks(layout, pairs):
    """5 images at batch_chunk 1 / 2 (a tail chunk of one) / 5, through
    ``get_forces_batch`` and ``au_energy_force_batch_fn``; escn-test in
    each edge layout stacks a chunk into one pass."""
    kind = "small-dense" if layout == "small-dense" else "escn-test"
    X = images(pairs[kind][2])
    out = {}
    for chunk in (1, 2, 5):
        kw = {} if kind != "escn-test" else {"edge_kernel": layout}
        jc, calc, cb = fresh(pairs, kind, batch_chunk=chunk, **kw)
        if kind == "escn-test":
            assert calc.cfg.edge_kernel == layout
            calc.energy_fn_images = Count(calc.energy_fn_images,
                                          lambda c, *_: c.shape[0])
        else:
            assert calc.energy_fn_images is None
        r = calc.get_forces_batch(X)
        assert calc.force_calls == 5
        xp = torch.stack([calc.pad_bohr(x) for x in X])
        e, f = calc.au_energy_force_batch_fn()(xp)
        assert calc.force_calls == 10
        np.testing.assert_array_equal(e.numpy(), r["energy"])
        np.testing.assert_array_equal(
            f[:, :calc.n_atoms].reshape(5, -1).numpy(), r["forces"])
        if kind == "escn-test":
            # chunks of one (and the tail one of chunk 2) take the
            # one-image path
            want = {1: [], 2: [2, 2], 5: [5]}[chunk]
            assert calc.energy_fn_images.sizes == want * 2
        out[chunk] = r
    # JAX's lax.map over chunks of 2 (its tail padded to 2)
    jr = jax_calc(jc, batch_chunk=2).get_forces_batch(X)
    assert np.abs(out[2]["energy"] - jr["energy"]).max() < 1e-8
    assert np.abs(out[2]["forces"] - jr["forces"]).max() < 1e-7
    for chunk in (2, 5):
        np.testing.assert_allclose(out[chunk]["energy"], out[1]["energy"],
                                   rtol=1e-12, atol=0)
        assert _rel(out[chunk]["forces"], out[1]["forces"]) <= 1e-12


def test_batch_chunk_variable_and_argument(pairs, monkeypatch):
    """``PDB2R_TPU_BATCH_CHUNK`` sets the chunk where ``batch_chunk`` is
    not given; the argument wins; a chunk below 1 raises."""
    X = images(pairs["escn-test"][2], n=4)

    def sizes(**kw):
        calc = fresh(pairs, "escn-test", **kw)[1]
        calc.energy_fn_images = Count(calc.energy_fn_images,
                                      lambda c, *_: c.shape[0])
        calc.get_forces_batch(X)
        return calc.energy_fn_images.sizes
    assert sizes() == []                  # chunks of one, one image a call
    monkeypatch.setenv("PDB2R_TPU_BATCH_CHUNK", "3")
    assert sizes() == [3]                 # and the tail image alone
    assert sizes(batch_chunk=4) == [4]
    monkeypatch.setenv("PDB2R_TPU_BATCH_CHUNK", "0")
    with pytest.raises(ValueError, match="at least one"):
        sizes()


def test_stacked_passes_split_at_the_limit(pairs):
    """A chunk larger than ``max_images`` goes in several stacked passes
    with the same results; ``stack_limit`` keeps every 32-bit-offset
    buffer of escn-md under 2^31 elements (42 images at P = 320)."""
    X = images(pairs["escn-test"][2])
    ref = fresh(pairs, "escn-test")[1].get_forces_batch(X)
    calc = fresh(pairs, "escn-test", batch_chunk=5)[1]
    fn = Count(calc.energy_fn_images, lambda c, *_: c.shape[0])
    fn.max_images = lambda n_pad: 2
    calc.energy_fn_images = fn
    r = calc.get_forces_batch(X)
    assert fn.sizes == [2, 2, 1]
    assert _rel(r["forces"], ref["forces"]) <= 1e-12
    md = E.ESCN_CONFIGS["escn-md"]
    assert E.stack_limit(md, 320) == 42
    M, U, K = 25, 19, md.max_neighbors
    per = 320 * K * (U * 2 * md.sphere_channels + md.edge_channels)
    assert 42 * per < 2 ** 31 <= 43 * per
    with pytest.raises(ValueError, match="at most 42"):
        E.escn_energy_images(torch.zeros(43, 320, 3),
                             pad_to(Structure([6] * 320, np.zeros((320, 3)))),
                             {}, md)


def test_stacked_images_in_the_gate_and_full_configurations():
    """The plain edge paths stack too: escn-test-gate, and escn-test
    narrowed to the full layout (mmax = lmax) under remat_blocks, against
    one image at a time, forces and the batched Hessian tangents."""
    rng = np.random.default_rng(5)
    st = Structure(rng.choice([1, 6, 8], size=4), rng.normal(scale=1.2,
                                                             size=(4, 3)))
    sysp = pad_to(st, multiple=8)
    X = torch.as_tensor(np.stack([sysp.coords.numpy()] * 3)
                        + 0.05 * rng.normal(size=(3, sysp.n_pad, 3)))
    X = X * sysp.atom_mask[None, :, None].double()
    for cfg in (E.ESCN_CONFIGS["escn-test-gate"],
                dataclasses.replace(E.ESCN_CONFIGS["escn-test"], mmax=2,
                                    remat_blocks=True)):
        cfg = dataclasses.replace(cfg, dtype=torch.float64)
        p = E.tree_to(E.init_escn_params(cfg, seed=2), dtype=torch.float64)
        p.update(charge=torch.tensor(0.0), spin=torch.tensor(1.0),
                 task=torch.tensor(0.0))
        Xr = X.clone().requires_grad_(True)
        e = E.escn_energy_images(Xr, sysp, p, cfg)
        (g,) = torch.autograd.grad(e.sum(), Xr)
        for b in range(3):
            c = X[b].clone().requires_grad_(True)
            eb = E.escn_energy(c, sysp, p, cfg)
            (gb,) = torch.autograd.grad(eb, c)
            assert abs(float((e[b] - eb).detach())) <= 1e-12 * abs(float(eb.detach()))
            assert _rel(g[b], gb) <= 1e-12
        calc = Calculator(st, E.escn_energy_fn(cfg), params=p,
                          device="cpu", energy_fn_images=
                          E.escn_energy_images_fn(cfg))
        H = {}
        for chunk in ("1", "64"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("PDB2R_TPU_HVP_CHUNK", chunk)
                H[chunk] = calc.get_hessian(
                    st.coords_bohr.reshape(-1))["hessian"]
        assert _rel(H["64"], H["1"]) <= 1e-12


def test_one_by_one_under_tensor_parallel_parameters(pairs):
    """A calculator whose parameters are laid over a model axis, or whose
    closure is a sharded (``collective``) one, runs a chunk's tangents
    and images one after another (their collectives have no batching
    rule)."""
    _, tc, cb = fresh(pairs, "escn-test")
    assert not tc._one_by_one()
    tc._tensor_parallel = True
    assert tc._one_by_one()
    tc.energy_fn_images = Count(tc.energy_fn_images, lambda c, *_: 0)
    tc.batch_chunk = 5
    tc.get_forces_batch(images(cb))
    assert tc.energy_fn_images.sizes == []
    _, tc, _ = fresh(pairs, "escn-test")
    from pdb2reaction_tpu_torch.parallel import SpatialGroup
    from pdb2reaction_tpu_torch.parallel.spatial import (
        make_spatial_energy_fn)
    tc.energy_fn_hessian = make_spatial_energy_fn(
        tc.cfg, SpatialGroup(0, 1, torch.device("cpu"), "gloo"))
    assert tc._one_by_one()


def test_params_from_jax_tree_through_the_batched_path():
    """The factory's images closure takes a raw tree of the JAX package's
    layout (MoLE banks unmerged; the routing is one per calculator)."""
    _, tc, cb, p = escn_pair()
    st = tc.structure
    X = images(cb, n=3)
    one = make_uma_calculator(st, model="escn-test", device="cpu",
                              dtype=torch.float64, params=params_from_jax(p))
    three = make_uma_calculator(st, model="escn-test", device="cpu",
                                dtype=torch.float64,
                                params=params_from_jax(p), batch_chunk=3)
    assert params_from_jax(p)["blocks"][0]["ffn"][0]["w"].ndim == 3
    a, b = one.get_forces_batch(X), three.get_forces_batch(X)
    assert _rel(b["forces"], a["forces"]) <= 1e-12
    np.testing.assert_allclose(b["energy"], a["energy"], rtol=1e-12)
