"""Port of repro/checkpoint/__init__.py: atomic / async save, restore, the
reader of the JAX package's layout and the weight bridge."""
from .checkpoint import (latest_step, list_steps, load_checkpoint,
                         params_from_numpy, prune, restore, save, save_async)

__all__ = ["latest_step", "list_steps", "load_checkpoint",
           "params_from_numpy", "prune", "restore", "save", "save_async"]
