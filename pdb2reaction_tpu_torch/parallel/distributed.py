"""The process group of atom-axis sharding and its three collectives.

Counterpart of what ``shard_map`` over the mesh's "model" axis does
implicitly in the JAX package (``pdb2reaction_tpu/parallel/spatial.py``,
``pdb2reaction_tpu/mlip/model.py``): every rank owns a contiguous block of
atom rows, the coordinates are replicated, node features are all-gathered
once per stream and layer, and the energy is a sum over ranks. Here the
three collectives are autograd functions, so forces come out of
``torch.autograd.grad`` on every rank:

- ``replicate_in(x)``: the identity; its backward sums the cotangent over
  ranks (each rank's gradient covers only its own rows' terms);
- ``all_gather_rows(t)``: the tiled all-gather of every rank's rows; its
  backward gives each rank the sum of every rank's cotangent for its rows
  (a reduce-scatter, built from an all-gather: gloo has none);
- ``sum_out(e)``: the sum over ranks; its backward is the identity.

Every sum over ranks gathers all parts and adds them in rank order, so
every rank gets the same bits and two calls repeat. With gloo, CUDA
tensors are staged through host memory explicitly.

Backend rule (``init_spatial``): NCCL when every rank of the host has a
card of its own, gloo when ranks share a card or run on the CPU. Rank r
computes on ``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from ..mlip.calculator import resolve_device


@dataclass(frozen=True)
class SpatialGroup:
    """This rank's place in the atom-axis sharding: its rank, the number
    of ranks, its device and the backend of the collectives."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def replicate_in(self, x: torch.Tensor) -> torch.Tensor:
        return _ReplicateIn.apply(x, self)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return _AllGatherRows.apply(t, self)

    def sum_out(self, e: torch.Tensor) -> torch.Tensor:
        return _SumOut.apply(e, self)


_GROUP: Optional[SpatialGroup] = None


def init_spatial(world_size: Optional[int] = None,
                 rank: Optional[int] = None, *, device="cuda",
                 init_method: Optional[str] = None,
                 timeout_s: float = 600.0) -> SpatialGroup:
    """Join the process group of atom-axis sharding and return this rank's
    ``SpatialGroup``. Unset arguments come from the variables ``torchrun``
    sets (RANK, WORLD_SIZE; ``init_method`` "env://" reads MASTER_ADDR and
    MASTER_PORT). The rank's place on its host is LOCAL_RANK and
    LOCAL_WORLD_SIZE, else ``rank`` and ``world_size`` (one host).
    ``device`` "cuda" puts the rank on ``cuda:(local_rank % device_count)``
    and raises without a card; "cpu" runs the plain paths over gloo."""
    global _GROUP
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        if n_cards >= local_world_size:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    _GROUP = SpatialGroup(rank, world_size, dev, backend)
    return _GROUP


def current_group() -> Optional[SpatialGroup]:
    """The group ``init_spatial`` joined, or None."""
    return _GROUP if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    global _GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


def is_main_rank() -> bool:
    """True outside a process group and on rank 0 inside one: the rank that
    writes outputs and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _gather(t: torch.Tensor, group: SpatialGroup) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank) in rank order, on the
    host under gloo and on the card under NCCL."""
    t = t.detach()
    if group.backend == "gloo":
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t)
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
        return _rank_sum(_gather(g, ctx.group)).to(g.device), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return torch.cat(_gather(t, group), 0).to(t.device)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.group.rank * ctx.n
        own = [p[lo:lo + ctx.n] for p in _gather(g, ctx.group)]
        return _rank_sum(own).to(g.device), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, group):
        return _rank_sum(_gather(e, group)).to(e.device)

    @staticmethod
    def backward(ctx, g):
        return g, None
