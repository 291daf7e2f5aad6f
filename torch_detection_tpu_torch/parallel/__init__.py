from .distributed import (
    all_reduce_sum,
    batch_normaliser,
    batch_part,
    data_rank,
    data_size,
    global_rows,
    init_distributed,
    is_main,
    model_size,
    rank,
    shutdown_distributed,
    world_size,
)
from .mesh import LossRoot, make_mesh, shard_batch, shard_model, spatial_sharding, unsharded
from .train_step import Optimizer, ParamEMA, make_optimizer, make_train_step

__all__ = ["LossRoot", "Optimizer", "ParamEMA", "all_reduce_sum", "batch_normaliser", "batch_part",
           "data_rank", "data_size", "global_rows", "init_distributed", "is_main", "make_mesh",
           "make_optimizer", "make_train_step", "model_size", "rank", "shard_batch", "shard_model",
           "shutdown_distributed", "spatial_sharding", "unsharded", "world_size"]
