"""Port of repro/optim/__init__.py: AdamW with global-norm clipping and the
warmup-cosine schedule."""
from .adamw import AdamW, AdamWState, global_norm, warmup_cosine

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine"]
