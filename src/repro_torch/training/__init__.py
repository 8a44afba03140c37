"""Training (port of ``repro/training``): AdamW, synthetic LM data,
checkpoints in the reference's format, the train step and loop. Training
takes the reference's plain route: no hand-written kernel (as the
reference's training reaches no Pallas kernel)."""

from .optim import AdamWConfig, adamw_init, adamw_update
from .data import SyntheticLMData
from .checkpoint import checkpoint_step, restore_checkpoint, save_checkpoint
from .loop import TrainState, make_train_step, train_loop

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "SyntheticLMData",
           "checkpoint_step", "restore_checkpoint", "save_checkpoint",
           "TrainState", "make_train_step", "train_loop"]
