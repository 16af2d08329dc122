"""Port of repro/train/__init__.py: the microbatched train step and the
fault-tolerant Trainer (on one device or, for the dense and MoE families,
on a mesh)."""
from .trainer import (Trainer, TrainerConfig, TrainState, init_train_state,
                      make_train_step, place_train_state)

__all__ = ["TrainState", "Trainer", "TrainerConfig", "init_train_state",
           "make_train_step", "place_train_state"]
