"""Port of repro/kernels/__init__.py: hand-written Hopper kernels for the
hot spots of the serving path, each with a plain PyTorch version beside it.

  staged_scatter      the unload path's drain: staging ring -> pool rows
                      (``csrc/staged_scatter.cu``)
  flash_decode_paged  fused paged decode: page-table walk + staging-ring
                      overlay + SDPA in one kernel
                      (``csrc/flash_decode_paged.cu``)
  flash_attention     causal / sliding-window prefill attention, GQA by
                      index (``csrc/flash_attention.cu``)
  flash_decode        one-query decode over a dense per-slot cache, the
                      lanes layout's read (``csrc/flash_decode.cu``)
  cms_update          count-min-sketch update, the CMS monitor's counters
  cms_query           count-min-sketch estimate (both ``csrc/cms.cu``)
"""
from .ops import (
    cms_query,
    cms_query_ref,
    cms_update,
    cms_update_ref,
    flash_attention,
    flash_attention_ref,
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_ref,
    flash_decode_ref,
    launch_counts,
    reset_launch_counts,
    staged_scatter,
    staged_scatter_layers,
    staged_scatter_ref,
)

__all__ = [
    "cms_query", "cms_query_ref", "cms_update", "cms_update_ref",
    "flash_attention", "flash_attention_ref", "flash_decode",
    "flash_decode_ref", "flash_decode_paged", "flash_decode_paged_ref",
    "launch_counts",
    "reset_launch_counts", "staged_scatter", "staged_scatter_layers",
    "staged_scatter_ref",
]
