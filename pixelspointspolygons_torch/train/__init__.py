from .state import TrainState, cosine_with_warmup, linear_warmup_decay, make_optimizer, make_scheduler

__all__ = ["TrainState", "cosine_with_warmup", "linear_warmup_decay", "make_optimizer", "make_scheduler"]
