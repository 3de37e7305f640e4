"""Training substrate (PyTorch port of `repro.training`): optimizer, train
loop, checkpointing (sharded states too), the int8 gradient compression
(`compression.py`) and the data-parallel step (`dp_step.py`)."""

from repro_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    schedule_fn,
)
from repro_torch.training.train_loop import (
    TrainState,
    init_train_state,
    make_train_step,
)

__all__ = [
    "OptimizerConfig", "adamw_init", "adamw_update", "schedule_fn",
    "TrainState", "init_train_state", "make_train_step",
    "save_checkpoint", "restore_checkpoint", "latest_step",
]
