"""Training: optimizer, gradient accumulation, checkpoints, fault loop."""
from .checkpoint import AsyncSaver, cleanup, latest_step, restore, save
from .fault import LoopConfig, SimulatedPreemption, TrainLoop
from .grad import loss_and_grads, make_train_step, quantize_grads_int8
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        global_norm, opt_state_from_jax, schedule_lr)

__all__ = [
    "AsyncSaver", "cleanup", "latest_step", "restore", "save",
    "LoopConfig", "SimulatedPreemption", "TrainLoop",
    "loss_and_grads", "make_train_step", "quantize_grads_int8",
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "global_norm", "opt_state_from_jax", "schedule_lr",
]
