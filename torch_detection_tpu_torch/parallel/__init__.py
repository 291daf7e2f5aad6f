from .train_step import Optimizer, make_optimizer, make_train_step

__all__ = ["Optimizer", "make_optimizer", "make_train_step"]
