"""Port of repro/train/__init__.py: the microbatched train step and the
fault-tolerant Trainer."""
from .trainer import (Trainer, TrainerConfig, TrainState, init_train_state,
                      make_train_step)

__all__ = ["TrainState", "Trainer", "TrainerConfig", "init_train_state",
           "make_train_step"]
