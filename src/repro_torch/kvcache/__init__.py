"""Port of repro/kvcache/__init__.py: the paged block pool backing the
continuous-batching serve scheduler, with its staging-ring overlay, the
prefix cache's hashes and the host tier's block moves; under a mesh its
data planes split on the head axis. The dense-lane
overlay (``kvcache/staged.py``) is not ported yet."""
from .paged import (BlockPool, StepPlan, copy_block, drain_ring, gather_view,
                    load_blocks, logical_to_physical, make_paged_kv,
                    maybe_drain, pool_rows, prefix_page_hashes,
                    scatter_prefill, scatter_token, step_plan, unload_blocks,
                    view_len, view_mask, view_rows, whole)

__all__ = [
    "BlockPool", "StepPlan", "copy_block", "drain_ring", "gather_view",
    "load_blocks", "logical_to_physical", "make_paged_kv", "maybe_drain",
    "pool_rows", "prefix_page_hashes", "scatter_prefill", "scatter_token",
    "step_plan", "unload_blocks", "view_len", "view_mask", "view_rows",
    "whole",
]
