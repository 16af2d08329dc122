"""Port of repro/kernels/__init__.py: hand-written Hopper kernels for the
hot spots of the serving path, each with a plain PyTorch version beside it.

  staged_scatter      the unload path's drain: staging ring -> pool rows
                      (``csrc/staged_scatter.cu``)
  flash_decode_paged  fused paged decode: page-table walk + staging-ring
                      overlay + SDPA in one kernel
                      (``csrc/flash_decode_paged.cu``)

``cms_update``/``cms_query``, ``flash_attention`` and ``flash_decode`` of
the JAX package are not ported yet.
"""
from .ops import (
    flash_decode_paged,
    flash_decode_paged_ref,
    launch_counts,
    reset_launch_counts,
    staged_scatter,
    staged_scatter_layers,
    staged_scatter_ref,
)

__all__ = [
    "flash_decode_paged", "flash_decode_paged_ref", "launch_counts",
    "reset_launch_counts", "staged_scatter", "staged_scatter_layers",
    "staged_scatter_ref",
]
