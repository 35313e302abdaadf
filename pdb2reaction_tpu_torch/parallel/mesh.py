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

- axis "expert" (training only): the MoLE expert banks of an eSCN
  model laid over ranks (``mlip/train.py``), the JAX package's
  ``Mesh(devices.reshape(D, E), ("data", "expert"))``.

Rank r has model index ``r % model``, expert index ``(r // model) %
expert`` and data index ``r // (model * expert)``: the model axis stays
inside a host, the data axis runs across hosts, the DCN-outer order of
the JAX package's ``make_hybrid_mesh``.

Parameters are laid over an axis by a tree of specs, the JAX package's
``PartitionSpec``s as tuples (``(None, "model")`` shards a matrix's
columns over "model", ``("expert", None, None)`` a bank's experts over
"expert", ``()`` replicates): ``lay_out`` puts this rank's block of each
laid-out leaf in a ``distributed.Shard``, ``unshard`` gathers the whole
tree back. ``shard_params_model`` is the tensor-parallel layout of an
inference tree.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import distributed as _d
from .distributed import Shard, SpatialGroup


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh: ``shape`` {"data": D, "model": M}
    (and "expert": E on a mesh made with one), and its group on each
    axis (``data``, ``model``, ``expert``; their ``rank`` is this rank's
    index on the axis)."""

    shape: Dict[str, int]
    data: SpatialGroup
    model: SpatialGroup
    expert: Optional[SpatialGroup] = None

    def group(self, axis: str) -> SpatialGroup:
        g = getattr(self, axis, None) if axis in self.shape else None
        if g is None:
            raise ValueError(f"the mesh {self.shape} has no {axis!r} axis")
        return g

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


def make_mesh(data: Optional[int] = None, model: int = 1,
              expert: Optional[int] = None) -> Mesh:
    """The mesh of ``data`` x ``expert`` x ``model`` ranks over the joined
    world (``data`` None: what the others leave), which must be exactly
    the world; it becomes the current mesh
    (``distributed.current_mesh``). ``expert`` None makes no "expert"
    axis."""
    w = _d.world()
    if w is None:
        raise RuntimeError("make_mesh needs a joined process group: "
                           "initialize_distributed(...) or init_spatial(...)"
                           " first, or launch under torchrun")
    model = int(model)
    ex = 1 if expert is None else int(expert)
    data = w.size // (model * ex) if data is None else int(data)
    if data * ex * model != w.size:
        raise ValueError(f"mesh {data} x {ex} x {model} is not the world of "
                         f"{w.size} ranks")

    sizes = {"data": data, "expert": ex, "model": model}

    def group(axis):
        """This rank's group on ``axis``: one group per setting of the
        other two indices, every group made on every rank in one order."""
        others = [a for a in sizes if a != axis]
        groups = []
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            idx = dict(zip(others, fixed))
            groups.append([(idx.get("data", k) * ex + idx.get("expert", k))
                           * model + idx.get("model", k)
                           for k in range(sizes[axis])])
        mi, ms, pg = _groups(w, groups)
        return SpatialGroup(mi, ms, w.device, w.backend, pg)

    shape = {"data": data, "model": model}
    if expert is not None:
        shape["expert"] = ex
    mesh = Mesh(shape, group("data"), group("model"),
                group("expert") if expert is not None else None)
    _d._MESH = mesh
    return mesh


# the JAX package's name for the mesh over every process of a multi-host
# job: ranks are numbered host by host (as torchrun numbers them), so
# ``make_mesh``'s layout already puts the data axis across hosts
make_hybrid_mesh = make_mesh


def data_size(mesh: Optional[Mesh]) -> int:
    """The data axis a calculator splits its batches over: 1 without a
    mesh and beside a model axis (an atom-axis sharded or tensor-parallel
    calculator runs its batches image by image through the call every
    rank of its model group takes part in, as the JAX calculator keeps
    its plain kernels when model > 1)."""
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


def map_tree(tree, fn, path=()):
    """``fn(path, leaf)`` on every leaf of a nested dict / list tree, the
    tree's shape and key order kept. Leaves are visited dicts by sorted
    key (``jax.tree_util``'s leaf order), lists in order: the one walker
    of the parameter trees (layouts, the optimizer's leaves, a carried
    optimizer state)."""
    if isinstance(tree, dict):
        out = {k: map_tree(tree[k], fn, path + (k,)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def at_path(tree, path):
    """The subtree of ``tree`` at ``path`` (as ``map_tree`` names it);
    None where ``tree`` has no such path."""
    for k in path:
        if isinstance(tree, dict) and k in tree:
            tree = tree[k]
        elif isinstance(tree, (list, tuple)) and isinstance(k, int) \
                and k < len(tree):
            tree = tree[k]
        else:
            return None
    return tree


def _sharded_dim(spec):
    """(dimension, axis) a spec lays out, or None when it replicates."""
    axes = [(i, a) for i, a in enumerate(spec or ()) if a is not None]
    if len(axes) > 1:
        raise ValueError(f"spec {spec}: one sharded dimension at most")
    return axes[0] if axes else None


def lay_out(params, specs, mesh: Mesh):
    """``params`` laid over ``mesh`` by ``specs`` (a tree of the same
    shape whose leaves are spec tuples): each sharded leaf becomes a
    ``Shard`` of this rank's block, the others stay as they are."""
    def place(x, spec):
        sd = _sharded_dim(spec)
        if sd is None or not isinstance(x, torch.Tensor):
            return x
        dim, ax = sd
        g = mesh.group(ax)
        if g.size == 1:
            return x
        if x.shape[dim] % g.size:
            raise ValueError(f"dimension {dim} of a {tuple(x.shape)} leaf "
                             f"does not divide the {ax!r} axis ({g.size})")
        n = x.shape[dim] // g.size
        local = x.narrow(dim, g.rank * n, n).clone()
        return Shard(local, dim - x.ndim if ax == "model" else dim, ax, g)

    return map_tree(params, lambda path, x: place(x, at_path(specs, path)))


def unshard(tree):
    """The whole tree: every ``Shard`` gathered from its ranks (a
    collective on its group: every rank of it must call), detached;
    anything else as it is."""
    def whole(_, x):
        return x.full().detach() if isinstance(x, Shard) else x
    return map_tree(tree, whole)


def shard_params_model(params, mesh: Mesh):
    """Tensor-parallel parameter layout: the trailing (feature) dimension
    of every weight of two or more dimensions laid over the mesh's
    "model" axis where it divides evenly; the rest replicated, as the
    JAX package's ``shard_params_model``. Each site that multiplies by a
    laid-out weight multiplies by this rank's columns and all-gathers
    the result's columns; a site that needs the whole weight gathers it.
    Layout only: results equal the replicated run's (up to the order of
    float sums). ``params`` itself when the model axis is 1. Atom-axis
    sharding (``spatial > 1``) uses the model axis for rows instead, so
    ``Calculator.shard_params_model`` refuses this layout there."""
    m = mesh.shape["model"]
    if m <= 1:
        return params

    def spec(_, x):
        if (isinstance(x, torch.Tensor) and x.ndim >= 2
                and x.shape[-1] % m == 0):
            return (None,) * (x.ndim - 1) + ("model",)
        return ()
    return lay_out(params, map_tree(params, spec), mesh)
