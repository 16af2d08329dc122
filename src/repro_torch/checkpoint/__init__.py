"""Port of repro/checkpoint/__init__.py (reader side + weight bridge)."""
from .checkpoint import load_checkpoint, params_from_numpy

__all__ = ["load_checkpoint", "params_from_numpy"]
