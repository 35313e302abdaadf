"""Spatial partitioning: atom-axis sharding of one big structure.

Port of ``pdb2reaction_tpu/parallel/spatial.py`` on ``torch.distributed``:
each rank owns a contiguous block of P/n atom rows (its embeddings, its
message rows, its node features); the coordinates are replicated; every
layer all-gathers the feature streams once; the energy is a sum over
ranks (``distributed.py``). The closure has the unsharded closures'
signature ``fn(coords, system, params)``, so ``Calculator`` is unchanged:
every rank runs the same force call and gets the same forces.

- PaiNN-class ``mp_mode="pallas"``: each rank contracts its rows against
  all columns through K6 (``radial_contract_rect``), O(P/n) memory;
- the other PaiNN-class modes: the sharded [P, K] gather layout;
- eSCN (``ESCNConfig``): ``escn_energy`` on this rank's rows, the
  normalised node features all-gathered once a layer; "pallas-mega"
  takes the "pallas-full" layout (K3 on the gathered source rows), as
  in the JAX package.

``make_spatial_hessian_energy_fn`` is the Hessian closure under the
shard: the same sharded bodies on their plain, twice differentiable
routes (eSCN on "xla", the plain reduced edge path and K2's plain
version; the pallas mode on K6's plain version), whose collectives keep
their second-order terms. The JAX factory keeps an unsharded XLA
Hessian closure beside its sharded force call; the port shards it too,
so a Hessian needs no more memory a rank than a force call's plain
route.
"""

from __future__ import annotations

import dataclasses

from ..mlip.escn import escn_energy
from ..mlip.model import ModelConfig, energy_fn_gather, energy_fn_pallas
from .distributed import SpatialGroup


def make_spatial_energy_fn(cfg, group: SpatialGroup, plain: bool = False):
    """``fn(coords_ang, system, params) -> eV`` with the atom axis sharded
    over ``group``. ``cfg`` picks the backbone: a ``ModelConfig``
    (PaiNN-class) or an ``ESCNConfig``. The padded atom count must be
    divisible by the group size (``make_uma_calculator(spatial=n)`` pads
    to lcm(8, n)). ``plain`` runs the pallas mode on K6's plain
    version. The closure is marked ``collective``: its collectives have
    no batching rule, so a Calculator runs its chunks item by item."""
    kw = {}
    if not isinstance(cfg, ModelConfig):
        body = escn_energy
    elif cfg.mp_mode == "pallas":
        body, kw = energy_fn_pallas, {"plain": plain}
    else:
        body = energy_fn_gather

    def fn(coords, system, params):
        return body(coords, system, params, cfg, shard=group, **kw)

    fn.collective = True
    return fn


def make_spatial_hessian_energy_fn(cfg, group: SpatialGroup):
    """The Hessian closure under the shard: eSCN on the "xla" layout, the
    pallas mode on K6's plain version, the gather layout as it is."""
    if not isinstance(cfg, ModelConfig):
        return make_spatial_energy_fn(
            dataclasses.replace(cfg, edge_kernel="xla"), group)
    return make_spatial_energy_fn(cfg, group, plain=True)
