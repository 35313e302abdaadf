"""Port ``bio/bonds.py`` against the JAX package's ``compare_structures``
and ``summarize_changes`` (JAX in float64 on the CPU):

- Morse H3 (the path-search test system) in both directions and with no
  change;
- ``chip_smoke.cluster`` at 64 atoms with one hydrogen moved to 1.05
  Angstrom from its nearest heavy atom (``chip_smoke.moved_h``, phase
  13's rule), and the same cluster with every atom jittered;
- non-default bond factors.

Formed and broken sets are equal, both distance matrices agree to
1e-12 Bohr and the summary text is equal."""

import numpy as np
import pytest
import torch

from chip_smoke import cluster, moved_h
from pdb2reaction_tpu.bio import bonds as j_bonds
from pdb2reaction_tpu_torch.bio import bonds
from pdb2reaction_tpu_torch.constants import ANG2BOHR

H3A = np.array([[0, 0, 0], [0.686, 0, 0], [2.4, 0, 0]]) * ANG2BOHR
H3B = np.array([[0, 0, 0], [1.714, 0, 0], [2.4, 0, 0]]) * ANG2BOHR


def _check(zs, c1, c2, **kw):
    r = bonds.compare_structures(zs, c1, c2, **kw)
    j = j_bonds.compare_structures(zs, c1, c2, **kw)
    assert r.formed_covalent == j.formed_covalent
    assert r.broken_covalent == j.broken_covalent
    assert np.abs(r.distances_1 - j.distances_1).max() <= 1e-12
    assert np.abs(r.distances_2 - j.distances_2).max() <= 1e-12
    assert r.any_change == j.any_change
    for one_based in (True, False):
        assert bonds.summarize_changes(zs, r, one_based) == \
            j_bonds.summarize_changes(zs, j, one_based)
    return r


def test_h3_bond_changes_match_jax():
    zs = [1, 1, 1]
    r = _check(zs, H3A, H3B)
    assert r.formed_covalent == {(1, 2)} and r.broken_covalent == {(0, 1)}
    r = _check(zs, H3B, H3A)
    assert r.formed_covalent == {(0, 1)} and r.broken_covalent == {(1, 2)}
    r = _check(zs, H3A, H3A.reshape(-1))            # [3N] input
    assert not r.any_change
    assert bonds.summarize_changes(zs, r) == \
        "No covalent bond changes detected."


def test_cluster_with_one_h_moved_matches_jax():
    zs, xyz = cluster(64, seed=3)
    moved, _, _ = moved_h(zs, xyz)
    r = _check(zs, xyz * ANG2BOHR, moved * ANG2BOHR)
    assert r.formed_covalent                       # the moved H bonds
    rng = np.random.default_rng(5)
    jit = xyz + rng.normal(scale=0.12, size=xyz.shape)
    r = _check(zs, xyz * ANG2BOHR, jit * ANG2BOHR)
    assert r.formed_covalent and r.broken_covalent
    # tensors are taken as they are
    r2 = bonds.compare_structures(zs, torch.as_tensor(xyz * ANG2BOHR),
                                  torch.as_tensor(jit * ANG2BOHR))
    assert r2.formed_covalent == r.formed_covalent


@pytest.mark.parametrize("kw", [
    {"bond_factor": 1.3}, {"margin_fraction": 0.0, "delta_fraction": 0.2},
    {"bond_factor": 1.1, "margin_fraction": 0.1, "delta_fraction": 0.01}])
def test_bond_options_match_jax(kw):
    zs, xyz = cluster(48, seed=7)
    rng = np.random.default_rng(11)
    jit = xyz + rng.normal(scale=0.1, size=xyz.shape)
    _check(zs, xyz * ANG2BOHR, jit * ANG2BOHR, **kw)


def test_mismatched_shapes_raise():
    with pytest.raises(ValueError):
        bonds.compare_structures([1, 1, 1], H3A, H3A[:2])
