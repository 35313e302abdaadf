"""K5's tile plan (``radial_contract.tile_plan``): the spatial order, the
per-tile boxes and the reach relation that K5's forward and coordinate
gradient run on, on the CPU.

Completeness is the property that matters: every pair that the kernels'
own f32 test puts inside the cutoff (d = sqrt(max(d^2, 1e-12)) <= rc, i != j,
both atoms real) must lie in a listed tile pair, or it is dropped
silently. Checked against that predicate, brute force, on random systems,
the 4096-atom smoke cluster in lattice order and shuffled, two blobs far
apart, masked atoms at the origin, P not a multiple of 32, P < 32, P = 1,
and a pair at exactly the cutoff. Also: the listed share on the shuffled
cluster, determinism, and the plan's internal consistency.
"""

import numpy as np
import pytest
import torch

from chip_smoke import cluster
from pdb2reaction_tpu_torch.mlip.radial_contract import TILE, tile_plan


def _reach(plan):
    T = plan.n_tiles
    reach = torch.zeros(T, T, dtype=torch.bool)
    rp = plan.row_ptr.long()
    for I in range(T):
        reach[I, plan.cols[rp[I]:rp[I + 1]].long()] = True
    return reach


def _pairs_inside(x, mask, rc, chunk=512):
    """(i, j) of every ordered pair the kernels' f32 predicate keeps."""
    x = x.to(torch.float32)
    real = mask > 0
    out = []
    for a in range(0, x.shape[0], chunk):
        d = torch.sqrt(torch.clamp(
            ((x[a:a + chunk, None, :] - x[None, :, :]) ** 2).sum(-1),
            min=1e-12))
        w = (d <= rc) & real[a:a + chunk, None] & real[None, :]
        i, j = w.nonzero().T
        keep = i + a != j
        out.append(torch.stack([i[keep] + a, j[keep]], 1))
    return torch.cat(out)


def _check_complete(x, mask, rc):
    x = torch.as_tensor(x, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32)
    plan = tile_plan(x, mask, rc)
    P = x.shape[0]
    pos = torch.empty(P, dtype=torch.long)
    pos[plan.perm.long()] = torch.arange(P)
    ij = _pairs_inside(x, mask, rc)
    reach = _reach(plan)
    missed = int((~reach[pos[ij[:, 0]] // TILE, pos[ij[:, 1]] // TILE]).sum())
    assert missed == 0, f"{missed} pairs inside the cutoff in unlisted tiles"
    _check_consistent(plan, x, mask, reach)
    return plan, ij


def _check_consistent(plan, x, mask, reach):
    P, T = x.shape[0], plan.n_tiles
    assert T == -(-P // TILE)
    perm = plan.perm.long()
    assert torch.equal(torch.sort(perm).values, torch.arange(P))
    real = (mask > 0)[perm]
    # masked atoms go last
    n_real = int(real.sum())
    assert bool(real[:n_real].all()) and not bool(real[n_real:].any())
    assert torch.equal(plan.xm[:, :3], x[perm])
    assert torch.equal(plan.xm[:, 3], real.float())
    # boxes over the real atoms of each tile only
    for I in range(T):
        sl = slice(I * TILE, min((I + 1) * TILE, P))
        pts = x[perm[sl]][real[sl]]
        if len(pts):
            assert torch.equal(plan.lo[I], pts.min(0).values)
            assert torch.equal(plan.hi[I], pts.max(0).values)
        else:
            assert bool(torch.isinf(plan.lo[I]).all()) \
                and not bool(reach[I].any())
    assert torch.equal(reach, reach.T)
    # pairs: every listed I <= J once, with the slots of both sides
    nnz = int(plan.row_ptr[-1])
    assert torch.equal(plan.row_ptr[1:] - plan.row_ptr[:-1],
                       reach.sum(1).int())
    pr = plan.pairs.long()
    assert pr.shape[0] == int(torch.triu(reach).sum())
    assert bool((pr[:, 0] <= pr[:, 1]).all())
    assert bool(reach[pr[:, 0], pr[:, 1]].all())
    assert torch.equal(plan.cols[pr[:, 2]].long(), pr[:, 1])
    assert torch.equal(plan.cols[pr[:, 3]].long(), pr[:, 0])
    slots = torch.cat([pr[:, 2], pr[pr[:, 0] != pr[:, 1], 3]])
    assert torch.equal(torch.sort(slots).values, torch.arange(nnz))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complete_random(seed):
    rng = np.random.default_rng(seed)
    P = int(rng.integers(100, 400))
    x = rng.uniform(0.0, 18.0, (P, 3))
    mask = (rng.uniform(size=P) > 0.1).astype(np.float32)
    _check_complete(x, mask, 5.0)


@pytest.mark.parametrize("shuffled", [False, True])
def test_complete_smoke_cluster(shuffled):
    _, x = cluster(4096, seed=0)
    if shuffled:
        x = x[np.random.default_rng(3).permutation(len(x))]
    plan, ij = _check_complete(x, np.ones(len(x)), 6.0)
    assert ij.shape[0] == 509728          # chip_smoke.k5_pairs
    s = plan.stats()
    assert s["tiles"] == 128
    # at most a quarter of all tile pairs is listed, in any input order
    assert s["share"] <= 0.25, s


def test_complete_two_blobs_leave_empty_tiles():
    rng = np.random.default_rng(4)
    a = rng.normal(scale=2.0, size=(150, 3))
    b = rng.normal(scale=2.0, size=(150, 3)) + [60.0, 0.0, 0.0]
    x = np.concatenate([a, b])[rng.permutation(300)]
    plan, _ = _check_complete(x, np.ones(300), 6.0)
    reach = _reach(plan)
    assert not bool(reach.all())           # the blobs' tiles never meet


def test_complete_masked_atoms_at_origin():
    rng = np.random.default_rng(5)
    P = 200
    x = rng.uniform(-10.0, 10.0, (P, 3))
    mask = np.ones(P, np.float32)
    mask[rng.choice(P, 70, replace=False)] = 0.0
    x[mask == 0] = 0.0
    plan, _ = _check_complete(x, mask, 4.0)
    # the 130 real atoms fill the first tiles; the last tile holds only
    # masked atoms and reaches nothing
    reach = _reach(plan)
    assert not bool(reach[-1].any()) and not bool(reach[:, -1].any())


@pytest.mark.parametrize("P", [45, 20, 1])
def test_complete_ragged_and_small(P):
    rng = np.random.default_rng(P)
    x = rng.uniform(0.0, 8.0, (P, 3))
    plan, _ = _check_complete(x, np.ones(P, np.float32), 4.0)
    assert plan.perm.shape == (P,)


def test_complete_pair_at_exactly_the_cutoff():
    """Two atoms exactly 6 A apart in f32, in different tiles: the
    kernels keep the pair (d <= rc), so their tiles must be listed."""
    x = np.zeros((64, 3), np.float32)
    x[:31, 0] = -50.0 - np.arange(31)
    x[31] = [0.0, 0.0, 0.0]
    x[32] = [6.0, 0.0, 0.0]
    x[33:, 0] = 56.0 + np.arange(31)
    plan, ij = _check_complete(x, np.ones(64, np.float32), 6.0)
    pos = torch.empty(64, dtype=torch.long)
    pos[plan.perm.long()] = torch.arange(64)
    assert pos[31] // TILE != pos[32] // TILE
    assert any(int(i) == 31 and int(j) == 32 for i, j in ij)
    assert bool(_reach(plan)[pos[31] // TILE, pos[32] // TILE])


def test_plan_is_deterministic():
    _, x = cluster(1000, seed=2)
    x = torch.tensor(x[np.random.default_rng(6).permutation(1000)],
                     dtype=torch.float32)
    mask = torch.ones(1000)
    a, b = tile_plan(x, mask, 6.0), tile_plan(x.clone(), mask.clone(), 6.0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
