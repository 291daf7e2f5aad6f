from .distributed import (
    all_reduce_sum,
    batch_normaliser,
    global_rows,
    init_distributed,
    is_main,
    rank,
    rank_local,
    shutdown_distributed,
    world_size,
)
from .mesh import LossRoot, make_mesh, shard_batch, shard_model, spatial_sharding, unsharded
from .train_step import Optimizer, ParamEMA, make_optimizer, make_train_step

__all__ = ["LossRoot", "Optimizer", "ParamEMA", "all_reduce_sum", "batch_normaliser", "global_rows",
           "init_distributed", "is_main", "make_mesh", "make_optimizer", "make_train_step", "rank",
           "rank_local",
           "shard_batch", "shard_model", "shutdown_distributed", "spatial_sharding", "unsharded",
           "world_size"]
