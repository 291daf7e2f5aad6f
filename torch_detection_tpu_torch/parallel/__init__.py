from .distributed import (
    all_reduce_sum,
    batch_normaliser,
    global_rows,
    init_distributed,
    is_main,
    rank,
    shutdown_distributed,
    world_size,
)
from .mesh import LossRoot, make_mesh, shard_batch, shard_model, spatial_sharding, unsharded
from .train_step import Optimizer, make_optimizer, make_train_step

__all__ = ["LossRoot", "Optimizer", "all_reduce_sum", "batch_normaliser", "global_rows",
           "init_distributed", "is_main", "make_mesh", "make_optimizer", "make_train_step", "rank",
           "shard_batch", "shard_model", "shutdown_distributed", "spatial_sharding", "unsharded",
           "world_size"]
