"""The ("data", "model") mesh over the ranks of the joined world.

Port of ``pdb2reaction_tpu/parallel/mesh.py``. The JAX package keeps one
``Mesh`` of devices and lets XLA place the collectives; the port runs
one process per rank, so the mesh is a split of the world into process
groups:

- axis "model": atom-axis sharding of one structure (``spatial``); the
  collectives of ``distributed.SpatialGroup`` run on this rank's model
  group;
- axis "data": images, FD displacements and Hessian tangents over ranks
  (``--workers``); each rank evaluates one contiguous block of a padded
  batch and the blocks are all-gathered in rank order (``shard_batch``,
  ``replicate``), so every rank holds the same bits.

Rank r has model index ``r % model`` and data index ``r // model``: the
model axis stays inside a host, the data axis runs across hosts, the
DCN-outer order of the JAX package's ``make_hybrid_mesh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import distributed as _d
from .distributed import SpatialGroup


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh: ``shape`` {"data": D, "model": M},
    and its group on each axis (``data``, ``model``; their ``rank`` is
    this rank's index on the axis)."""

    shape: Dict[str, int]
    data: SpatialGroup
    model: SpatialGroup

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def data_index(self) -> int:
        return self.data.rank

    @property
    def model_index(self) -> int:
        return self.model.rank


def _groups(w, ranks_of):
    """A process group for each rank list of ``ranks_of`` (every rank
    takes part in making every group), and this rank's."""
    mine = None
    for ranks in ranks_of:
        if len(ranks) == w.size:
            pg = None                     # the default group
        elif len(ranks) == 1:
            pg = None                     # no collective runs on it
        else:
            pg = dist.new_group(ranks, timeout=w.timeout)
        if w.rank in ranks:
            mine = (ranks.index(w.rank), len(ranks), pg)
    return mine


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of ``data`` x ``model`` ranks over the joined world
    (``data`` None: world size // model), which must be exactly the
    world; it becomes the current mesh (``distributed.current_mesh``)."""
    w = _d.world()
    if w is None:
        raise RuntimeError("make_mesh needs a joined process group: "
                           "initialize_distributed(...) or init_spatial(...)"
                           " first, or launch under torchrun")
    model = int(model)
    data = w.size // model if data is None else int(data)
    if data * model != w.size:
        raise ValueError(f"mesh {data} x {model} is not the world of "
                         f"{w.size} ranks")
    mi, ms, mpg = _groups(w, [[d * model + m for m in range(model)]
                              for d in range(data)])
    di, ds, dpg = _groups(w, [[d * model + m for d in range(data)]
                              for m in range(model)])
    mesh = Mesh({"data": data, "model": model},
                SpatialGroup(di, ds, w.device, w.backend, dpg),
                SpatialGroup(mi, ms, w.device, w.backend, mpg))
    _d._MESH = mesh
    return mesh


# the JAX package's name for the mesh over every process of a multi-host
# job: ranks are numbered host by host (as torchrun numbers them), so
# ``make_mesh``'s layout already puts the data axis across hosts
make_hybrid_mesh = make_mesh


def data_size(mesh: Optional[Mesh]) -> int:
    """The data axis a calculator splits its batches over: 1 without a
    mesh and under atom-axis sharding (a sharded calculator runs its
    batches image by image through the sharded call, as the JAX
    calculator keeps its plain kernels when model > 1)."""
    if mesh is None or mesh.shape["model"] > 1:
        return 1
    return mesh.shape["data"]


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous block of ``x`` [B, ...] padded to a multiple
    of the data axis by repeating its last row; ``x`` itself without a
    data axis."""
    n = data_size(mesh)
    if n == 1:
        return x
    B = x.shape[0]
    Bp = -(-B // n) * n
    if Bp > B:
        x = torch.cat([x, x[-1:].expand(Bp - B, *x.shape[1:])], 0)
    k = Bp // n
    lo = mesh.data_index * k
    return x[lo:lo + k]


def replicate(block: torch.Tensor, mesh: Optional[Mesh],
              n: Optional[int] = None) -> torch.Tensor:
    """Every data rank's ``block`` concatenated in rank order (the same
    bits on every rank), on the block's device, cut to its first ``n``
    rows: the gather of ``shard_batch``'s blocks."""
    if data_size(mesh) == 1:
        return block if n is None else block[:n]
    full = torch.cat(_d._gather(block, mesh.data), 0).to(block.device)
    return full if n is None else full[:n]


def shard_params_model(params, mesh: Mesh):
    """The tensor-parallel parameter layout over the "model" axis is not
    ported: it comes with the training layouts, ROADMAP.md queue 1 item
    13."""
    raise NotImplementedError(
        "shard_params_model (tensor-parallel parameters over the 'model' "
        "axis) is not ported yet: ROADMAP.md queue 1 item 13, with the "
        "training layouts")
