"""Training substrate: optimizer, loss, train-step factory (the
reference's names; the sharding axes of the state wait for the parallel
layer)."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.train.step import TrainState, make_train_step

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "cosine_schedule",
    "TrainState", "make_train_step",
]
