"""Training substrate (port of ``repro.train``): optimizers, train step,
checkpointing."""

from repro_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.trainer import TrainState, init_state, make_train_step

__all__ = [
    "OptConfig",
    "TrainState",
    "init_state",
    "latest_step",
    "make_train_step",
    "opt_init",
    "opt_update",
    "restore_checkpoint",
    "save_checkpoint",
]
