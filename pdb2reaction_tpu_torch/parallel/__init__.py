"""Ranks of the port on ``torch.distributed``: the ("data", "model",
"expert") mesh, atom-axis sharding, batches over ranks and parameters
laid over an axis (the port of ``pdb2reaction_tpu/parallel``)."""

from .distributed import (Shard, SpatialGroup, agree, current_group,
                          current_mesh, gather_global, init_spatial,
                          initialize_distributed, is_main_rank, shutdown)
from .mesh import (Mesh, lay_out, make_hybrid_mesh, make_mesh, replicate,
                   shard_batch, shard_params_model, unshard)

__all__ = ["Mesh", "Shard", "SpatialGroup", "agree", "current_group",
           "current_mesh", "gather_global", "init_spatial",
           "initialize_distributed", "is_main_rank", "lay_out",
           "make_hybrid_mesh", "make_mesh", "replicate", "shard_batch",
           "shard_params_model", "shutdown", "unshard"]
