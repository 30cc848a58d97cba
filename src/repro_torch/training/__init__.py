"""Training substrate: AdamW, train loop, checkpointing."""

from .checkpoint import Checkpointer
from .optimizer import (AdamWConfig, AdamWState, adamw_update, global_norm,
                        init_adamw, lr_schedule)
from .train_loop import (TrainConfig, loss_fn, make_train_step, shift_labels,
                         train)

__all__ = [
    "AdamWConfig", "AdamWState", "Checkpointer", "TrainConfig",
    "adamw_update", "global_norm", "init_adamw", "loss_fn", "lr_schedule",
    "make_train_step", "shift_labels", "train",
]
