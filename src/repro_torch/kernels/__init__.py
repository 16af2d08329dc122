"""Port of repro/kernels/__init__.py: hand-written Hopper kernels for the
hot spots of the serving path, each with a plain PyTorch version beside it.

  staged_scatter      the unload path's drain: staging ring -> pool rows,
                      a table of planes over one routing list in one
                      launch (``staged_scatter_planes``;
                      ``csrc/staged_scatter.cu``)
  flash_decode_paged  fused paged decode: page-table walk + staging-ring
                      overlay + SDPA in one kernel
                      (``csrc/flash_decode_paged.cu``)
  flash_decode_paged_sharded
                      the same under a mesh: one K2 launch per device over
                      the head shards there
  flash_attention     causal / sliding-window prefill attention, GQA by
                      index (``csrc/flash_attention.cu``); under autograd
                      ``FlashAttentionFunction``, whose backward is
                      ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``)
  staged_drain        the functional drain for training's staged MoE
                      dispatch (one K1 launch into a fresh zero buffer),
                      its adjoint ``staged_gather`` a row gather over the
                      same routing (``csrc/staged_scatter.cu``)
  flash_decode        one-query decode over a dense per-slot cache, the
                      lanes layout's read (``csrc/flash_decode.cu``)
  cms_update          count-min-sketch update, the CMS monitor's counters
  cms_query           count-min-sketch estimate
  cms_update_query    the CMS monitor's whole step in one launch: update,
                      total, decay, then estimate (all three
                      ``csrc/cms.cu``)
  lru_scan            the simulator's two-cache set-associative LRU scan
                      (MTT + dTLB): a stable counting sort of the writes by
                      (cache, set), then one thread a set, its ways in
                      registers (``csrc/lru_scan.cu``; ports a ``lax.scan``,
                      not a Pallas kernel; bound by the longest set's chain
                      of dependent steps; five launches a call, each
                      counted in ``kernel_launch_counts``)

CPU tests of the plain versions against the JAX package: ``PYTHONPATH=src
python -m pytest -q tests/test_torch_cms.py`` (the sketch kernels) and
``tests/test_torch_*.py``; on the card ``python3 chip_smoke.py`` checks and
times every kernel.
"""
from .ops import (
    FlashAttentionFunction,
    cms_query,
    cms_query_ref,
    cms_update,
    cms_update_query,
    cms_update_query_ref,
    cms_update_ref,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_lse,
    flash_attention_lse_ref,
    flash_attention_ref,
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_ref,
    flash_decode_paged_sharded,
    flash_decode_paged_sharded_ref,
    flash_decode_ref,
    kernel_launch_counts,
    launch_counts,
    lru_buckets_ref,
    lru_scan,
    lru_scan_ref,
    reset_launch_counts,
    staged_drain,
    staged_gather,
    staged_gather_ref,
    staged_scatter,
    staged_scatter_layers,
    staged_scatter_planes,
    staged_scatter_planes_ref,
    staged_scatter_ref,
)

__all__ = [
    "FlashAttentionFunction", "cms_query", "cms_query_ref", "cms_update",
    "cms_update_query", "cms_update_query_ref", "cms_update_ref",
    "flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
    "flash_attention_lse", "flash_attention_lse_ref", "flash_attention_ref",
    "flash_decode",
    "flash_decode_ref", "flash_decode_paged", "flash_decode_paged_ref",
    "flash_decode_paged_sharded", "flash_decode_paged_sharded_ref",
    "kernel_launch_counts", "launch_counts", "lru_buckets_ref", "lru_scan",
    "lru_scan_ref",
    "reset_launch_counts", "staged_drain", "staged_gather",
    "staged_gather_ref", "staged_scatter", "staged_scatter_layers",
    "staged_scatter_planes", "staged_scatter_planes_ref", "staged_scatter_ref",
]
