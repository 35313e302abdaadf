"""Ranks of the port on ``torch.distributed``: the ("data", "model")
mesh, atom-axis sharding and batches over ranks (the port of
``pdb2reaction_tpu/parallel``)."""

from .distributed import (SpatialGroup, agree, current_group, current_mesh,
                          gather_global, init_spatial,
                          initialize_distributed, is_main_rank, shutdown)
from .mesh import (Mesh, make_hybrid_mesh, make_mesh, replicate,
                   shard_batch, shard_params_model)

__all__ = ["Mesh", "SpatialGroup", "agree", "current_group",
           "current_mesh", "gather_global", "init_spatial",
           "initialize_distributed", "is_main_rank", "make_hybrid_mesh",
           "make_mesh", "replicate", "shard_batch",
           "shard_params_model", "shutdown"]
