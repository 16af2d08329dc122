"""Port of repro/kernels/__init__.py: hand-written Hopper kernels for the
hot spots of the serving path, each with a plain PyTorch version beside it.

  staged_scatter      the unload path's drain: staging ring -> pool rows
                      (``csrc/staged_scatter.cu``)
  flash_decode_paged  fused paged decode: page-table walk + staging-ring
                      overlay + SDPA in one kernel
                      (``csrc/flash_decode_paged.cu``)
  flash_decode_paged_sharded
                      the same under a mesh: one K2 launch per head shard
  flash_attention     causal / sliding-window prefill attention, GQA by
                      index (``csrc/flash_attention.cu``)
  flash_decode        one-query decode over a dense per-slot cache, the
                      lanes layout's read (``csrc/flash_decode.cu``)
  cms_update          count-min-sketch update, the CMS monitor's counters
  cms_query           count-min-sketch estimate
  cms_update_query    the CMS monitor's whole step in one launch: update,
                      total, decay, then estimate (all three
                      ``csrc/cms.cu``)
  lru_scan            the simulator's two-cache set-associative LRU scan
                      (MTT + dTLB), one warp a set (``csrc/lru_scan.cu``;
                      ports a ``lax.scan``, not a Pallas kernel)

CPU tests of the plain versions against the JAX package: ``PYTHONPATH=src
python -m pytest -q tests/test_torch_cms.py`` (the sketch kernels) and
``tests/test_torch_*.py``; on the card ``python3 chip_smoke.py`` checks and
times every kernel.
"""
from .ops import (
    cms_query,
    cms_query_ref,
    cms_update,
    cms_update_query,
    cms_update_query_ref,
    cms_update_ref,
    flash_attention,
    flash_attention_ref,
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_ref,
    flash_decode_paged_sharded,
    flash_decode_paged_sharded_ref,
    flash_decode_ref,
    launch_counts,
    lru_scan,
    lru_scan_ref,
    reset_launch_counts,
    staged_scatter,
    staged_scatter_layers,
    staged_scatter_ref,
)

__all__ = [
    "cms_query", "cms_query_ref", "cms_update", "cms_update_query",
    "cms_update_query_ref", "cms_update_ref",
    "flash_attention", "flash_attention_ref", "flash_decode",
    "flash_decode_ref", "flash_decode_paged", "flash_decode_paged_ref",
    "flash_decode_paged_sharded", "flash_decode_paged_sharded_ref",
    "launch_counts", "lru_scan", "lru_scan_ref",
    "reset_launch_counts", "staged_scatter", "staged_scatter_layers",
    "staged_scatter_ref",
]
