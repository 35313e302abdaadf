"""Atom-axis sharding on ``torch.distributed`` (the port of
``pdb2reaction_tpu/parallel``'s spatial path)."""

from .distributed import (SpatialGroup, current_group, init_spatial,
                          is_main_rank, shutdown)

__all__ = ["SpatialGroup", "current_group", "init_spatial", "is_main_rank",
           "shutdown"]
