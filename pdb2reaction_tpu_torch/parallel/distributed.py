"""The process groups of the port and the collectives of atom-axis
sharding.

Counterpart of ``pdb2reaction_tpu/parallel/distributed.py`` and of what
``shard_map`` over the mesh's "model" axis does implicitly in the JAX
package (``pdb2reaction_tpu/parallel/spatial.py``,
``pdb2reaction_tpu/mlip/model.py``). The port runs one process per rank:
the world joins once (``initialize_distributed``, ``init_spatial`` or the
CLI under ``torchrun``), and ``parallel/mesh.py`` splits it into model
groups (atom-axis sharding) and data groups (batches over ranks).

Under sharding every rank owns a contiguous block of atom rows, the
coordinates are replicated, node features are all-gathered once per
stream and layer, and the energy is a sum over ranks. The collectives
are autograd functions whose backwards are themselves autograd
functions, so forces come out of ``torch.autograd.grad`` on every rank
and a ``create_graph`` backward (the Hessian, HVPs) keeps the
collectives' second-order terms:

- ``replicate_in(x)``: the identity; its backward is the sum over ranks
  (each rank's gradient covers only its own rows' terms), whose backward
  is the identity again;
- ``all_gather_rows(t)``: the tiled all-gather of every rank's rows; its
  backward is the reduce-scatter (each rank gets the sum of every rank's
  cotangent for its rows, built from an all-gather: gloo has none), whose
  backward is the all-gather;
- ``sum_out(e)``: the sum over ranks; its backward is ``replicate_in``.

A parameter laid over an axis (``Shard``: tensor-parallel columns over
"model", expert banks over "expert") feeds compute that is the same on
every rank of the axis, so its collectives pair differently:

- ``gather(t)`` of a ``Shard``: every rank's block of ``t`` along the
  shard's dimension, concatenated; its backward is this rank's block of
  the cotangent (every rank already holds the whole cotangent: a
  reduce-scatter would multiply it by the group size), whose backward
  is the gather again;
- ``rank_sum(ts)``: the data axis's gradient sum, outside autograd.

Every sum over ranks gathers all parts and adds them in rank order, so
every rank gets the same bits and two calls repeat. With gloo, CUDA
tensors are staged through host memory explicitly.

Backend rule: NCCL when every rank of the host has a card of its own,
gloo when ranks share a card or run on the CPU. Rank r computes on
``cuda:(local_rank % device_count)``.

Whatever reads a previous run's files is decided on rank 0 and
broadcast (``agree``); which rank writes which files is the workflows'
rule (``workflows/common.py`` ``rank_dir``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class SpatialGroup:
    """This rank's place in one axis of the mesh: its index on the axis,
    the axis size, its device, the backend of the collectives and the
    process group (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any = None

    def replicate_in(self, x: torch.Tensor) -> torch.Tensor:
        return _ReplicateIn.apply(x, self)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return _AllGatherRows.apply(t, self)

    def sum_out(self, e: torch.Tensor) -> torch.Tensor:
        return _SumOut.apply(e, self)

    def gather_blocks(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherBlocks.apply(t, self, dim)

    def rank_sum(self, ts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor of ``ts`` summed over the ranks in rank order (the
        same bits on every rank), in one gather; no autograd."""
        if self.size == 1:
            return list(ts)
        flat = torch.cat([t.detach().reshape(-1).to(self.device)
                          for t in ts])
        total = _rank_sum(_gather(flat, self)).to(self.device)
        out, i = [], 0
        for t in ts:
            out.append(total[i:i + t.numel()].view_as(t).to(t))
            i += t.numel()
        return out


@dataclass(frozen=True, eq=False)
class Shard:
    """This rank's block ``local`` of a parameter laid over one mesh axis
    (``axis`` "model" or "expert", ``group`` its ``SpatialGroup``),
    split evenly along dimension ``dim`` of the whole parameter. A leaf
    of a parameter tree: ``parallel.shard_params_model`` and the train
    steps' layouts make them, the model code takes them at the sites
    that read a weight, ``parallel.unshard`` gathers them back."""

    local: torch.Tensor
    dim: int
    axis: str
    group: SpatialGroup

    @property
    def ndim(self) -> int:
        return self.local.ndim

    @property
    def shape(self):
        s = list(self.local.shape)
        s[self.dim] *= self.group.size
        return torch.Size(s)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of ``t`` along the shard's dimension
        (counted from the end for a column shard, so ``x @ local`` and
        ``local[rows]`` gather as the weight itself), concatenated."""
        dim = self.dim if self.dim < 0 else self.dim - self.ndim + t.ndim
        return self.group.gather_blocks(t, dim)

    def full(self) -> torch.Tensor:
        return self.gather(self.local)

    def with_local(self, local: torch.Tensor) -> "Shard":
        return Shard(local, self.dim, self.axis, self.group)


@dataclass(frozen=True)
class _World:
    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device
    backend: str
    timeout: timedelta


_WORLD: Optional[_World] = None
_MESH = None                 # the mesh of parallel/mesh.py, once built


def _join(world_size: Optional[int], rank: Optional[int], device,
          init_method: Optional[str], timeout_s: float) -> _World:
    """Join the world once (idempotent). Unset arguments come from the
    variables ``torchrun`` sets (RANK, WORLD_SIZE; ``init_method``
    "env://" reads MASTER_ADDR and MASTER_PORT). The rank's place on its
    host is LOCAL_RANK and LOCAL_WORLD_SIZE, else ``rank`` and
    ``world_size`` (one host)."""
    global _WORLD
    from ..mlip.calculator import resolve_device
    if _WORLD is not None and dist.is_initialized():
        return _WORLD
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        if n_cards >= local_size:
            backend = "nccl"
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _WORLD = _World(rank, world_size, local_rank, local_size, dev, backend,
                    timeout)
    return _WORLD


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", timeout_s: float = 600.0) -> None:
    """Join the multi-process job (idempotent), the JAX package's
    ``initialize_distributed``: ``coordinator_address`` "host:port" with
    ``num_processes`` and ``process_id`` for explicit launches, else the
    ``torchrun`` variables. The collectives time out after ``timeout_s``,
    so a rank that diverges fails the run instead of hanging it."""
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else None)
    _join(num_processes, process_id, device, init, timeout_s)


def init_spatial(world_size: Optional[int] = None,
                 rank: Optional[int] = None, *, device="cuda",
                 init_method: Optional[str] = None,
                 timeout_s: float = 600.0) -> SpatialGroup:
    """Join the world and shard the atom axis over all of it: a mesh of
    one data rank and ``world_size`` model ranks (``parallel.make_mesh``);
    returns this rank's ``SpatialGroup``. ``device`` "cuda" puts the rank
    on ``cuda:(local_rank % device_count)`` and raises without a card;
    "cpu" runs the plain paths over gloo."""
    from .mesh import make_mesh
    w = _join(world_size, rank, device, init_method, timeout_s)
    return make_mesh(data=1, model=w.size).model


def world() -> Optional[_World]:
    """The joined world, or None."""
    return _WORLD if dist.is_initialized() else None


def current_mesh():
    """The mesh ``make_mesh`` built last, or None."""
    return _MESH if dist.is_initialized() else None


def current_group() -> Optional[SpatialGroup]:
    """The model group of the current mesh (atom-axis sharding), or
    None."""
    mesh = current_mesh()
    return None if mesh is None else mesh.model


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    global _WORLD, _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = _MESH = None


def is_main_rank() -> bool:
    """True outside a process group and on rank 0 inside one: the rank that
    writes outputs and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agree(obj):
    """``obj`` as rank 0 has it, on every rank of the world (a broadcast
    on the default group); ``obj`` itself outside a process group. Every
    decision read from a previous run's files goes through here, so that
    the ranks take the same branches."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_global(x) -> np.ndarray:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    the first axis in rank order, on every rank: the JAX package's
    ``gather_global``. ``x`` itself outside a process group."""
    t = torch.as_tensor(np.asarray(x))
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t.numpy()
    w = _WORLD
    if w is not None and w.backend == "nccl":
        t = t.to(w.device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat([p.reshape(-1, *t.shape[1:]) for p in parts],
                     0).cpu().numpy()


# -- the collectives -----------------------------------------------------------
def _gather(t: torch.Tensor, group: SpatialGroup) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank) in rank order, on the
    host under gloo and on the card under NCCL."""
    t = t.detach()
    if group.size == 1:
        return [t]
    if group.backend == "gloo":
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    return parts


def _rank_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The parts added in rank order (the same bits on every rank)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


class _ReplicateIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _SumOut.apply(g, ctx.group), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, group):
        ctx.group = group
        return _rank_sum(_gather(e, group)).to(e.device)

    @staticmethod
    def backward(ctx, g):
        return _ReplicateIn.apply(g, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return torch.cat(_gather(t, group), 0).to(t.device)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterRows.apply(g, ctx.group), None


class _GatherBlocks(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated in rank order, for
    compute that is the same on every rank of the group."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_gather(t, group), dim).to(t.device)

    @staticmethod
    def backward(ctx, g):
        return _OwnBlock.apply(g, ctx.group, ctx.dim), None, None


class _OwnBlock(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every rank holds."""

    @staticmethod
    def forward(ctx, g, group, dim):
        ctx.group, ctx.dim = group, dim
        n = g.shape[dim] // group.size
        return g.narrow(dim, group.rank * n, n).clone()

    @staticmethod
    def backward(ctx, h):
        return _GatherBlocks.apply(h, ctx.group, ctx.dim), None, None


class _ReduceScatterRows(torch.autograd.Function):
    """Rows [N, ...] on every rank -> this rank's block [N/n, ...] of the
    sum over ranks, added in rank order."""

    @staticmethod
    def forward(ctx, g, group):
        ctx.group = group
        n = g.shape[0] // group.size
        lo = group.rank * n
        own = [p[lo:lo + n] for p in _gather(g, group)]
        return _rank_sum(own).to(g.device)

    @staticmethod
    def backward(ctx, h):
        return _AllGatherRows.apply(h, ctx.group), None
