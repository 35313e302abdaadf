"""Port substrate against the JAX package: padding, xyz I/O, neighbour
lists (exactly equal, ties included) and the SO(3) machinery (f64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pdb2reaction_tpu.core import neighbors as jnb
from pdb2reaction_tpu.core.structure import Structure as JStructure
from pdb2reaction_tpu.core.structure import pad_to as jpad_to
from pdb2reaction_tpu.mlip import so3 as jso3
from pdb2reaction_tpu_torch.core import io_xyz, neighbors
from pdb2reaction_tpu_torch.core.structure import Structure, pad_to
from pdb2reaction_tpu_torch.mlip import so3


def _cluster(rng, n):
    zs = rng.choice([1, 6, 7, 8], size=n).astype(np.int32)
    return zs, rng.normal(scale=2.0, size=(n, 3))


def test_pad_to_matches_jax():
    rng = np.random.default_rng(0)
    zs, xyz = _cluster(rng, 13)
    st = Structure(zs, xyz, freeze=[2, 5])
    js = JStructure(zs, xyz, freeze=[2, 5])
    for kw in ({}, {"n_pad": 24}, {"multiple": 4}):
        a, b = pad_to(st, **kw), jpad_to(js, **kw)
        for f in ("numbers", "coords", "atom_mask", "free_mask", "masses"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))


def test_xyz_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    st = Structure.from_symbols(["O", "H", "H", "C"],
                                rng.normal(size=(4, 3)))
    p = tmp_path / "a.xyz"
    io_xyz.write_xyz(p, st, energy=-1.25)
    back = io_xyz.read_xyz(p)
    assert back.symbols == st.symbols
    np.testing.assert_allclose(back.coords, st.coords, atol=1e-14)
    assert float(back.comment) == -1.25
    p.write_text(p.read_text() * 2)                  # two frames
    frames = io_xyz.read_xyz_frames(p)
    assert len(frames) == 2 and frames[1].symbols == st.symbols


def _nbrs_both(coords, mask, cutoff, k):
    P = len(coords)
    idx_j, m_j = jnb.dense_neighbors_rows(jnp.asarray(coords),
                                          jnp.asarray(mask), cutoff, k, 0, P)
    idx_t, m_t = neighbors.dense_neighbors_rows(torch.as_tensor(coords),
                                                torch.as_tensor(mask),
                                                cutoff, k, 0, P)
    return (np.asarray(idx_j), np.asarray(m_j)), (idx_t.numpy(), m_t.numpy())


@pytest.mark.parametrize("seed,n,pad,k", [(0, 20, 24, 8), (1, 37, 40, 16),
                                          (2, 9, 16, 32)])
def test_neighbors_exactly_equal(seed, n, pad, k):
    rng = np.random.default_rng(seed)
    coords = np.zeros((pad, 3))
    coords[:n] = rng.normal(scale=2.5, size=(n, 3))
    coords[n:] = rng.normal(size=(pad - n, 3))    # padding rows anywhere
    mask = np.zeros(pad, np.float32)
    mask[:n] = 1.0
    (ij, mj), (it, mt) = _nbrs_both(coords, mask, 4.0, k)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(mt, mj)


def test_neighbors_tie_at_kth_slot():
    """Six atoms at exactly the same distance from atom 0 with K = 3: the
    K-th slot is a tie, which JAX's top_k breaks by lower index."""
    shell = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
             [0, 0, -1]]
    coords = np.array([[0.0, 0.0, 0.0]] + shell + [[5.0, 5.0, 5.0]] * 1)
    perm = np.array([0, 4, 2, 6, 1, 5, 3, 7])    # shuffle the shell order
    coords = coords[perm]
    mask = np.ones(len(coords), np.float32)
    (ij, mj), (it, mt) = _nbrs_both(coords, mask, 3.0, 3)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(mt, mj)
    assert list(it[0]) == [1, 2, 3]               # lowest indices win


def test_so3_tables_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    assert np.abs(so3.real_sph_harm(5, x)
                  - jso3.real_sph_harm(5, x)).max() < 1e-12
    for a, b in ((so3.s2_grid_tables(4, 20, 23),
                  jso3.s2_grid_tables(4, 20, 23)),
                 (so3.s2_grid_tables_midpoint(4, 10, 5),
                  jso3.s2_grid_tables_midpoint(4, 10, 5))):
        assert max(np.abs(a[i] - b[i]).max() for i in range(2)) < 1e-12


def test_wigner_and_edge_frame_match_jax_f64():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(3, 5, 3))
    R_j = np.asarray(jso3.edge_rot_mat(jnp.asarray(v)))
    R_t = so3.edge_rot_mat(torch.as_tensor(v)).numpy()
    assert np.abs(R_j - R_t).max() < 1e-12
    for lmax in (2, 4):
        bj = jso3.wigner_blocks(jnp.asarray(R_j), lmax)
        bt = so3.wigner_blocks(torch.as_tensor(R_j), lmax)
        for a, b in zip(bj, bt):
            assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-12
        fj = np.asarray(jso3.wigner_full(jnp.asarray(R_j), lmax))
        ft = so3.wigner_full(torch.as_tensor(R_j), lmax).numpy()
        assert np.abs(fj - ft).max() < 1e-12
