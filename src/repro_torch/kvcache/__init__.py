"""Port of repro/kvcache/__init__.py: the KV-cache substrate. The dense
(lanes) cache's staging-ring overlay (``staged``: the unload path for decode
writes on the lanes layout) and the paged block pool backing the
continuous-batching serve scheduler, with its staging-ring overlay, the
prefix cache's hashes and the host tier's block moves; under a mesh the
pool's data planes split on the head axis. As in the JAX package, the
unqualified ``drain_ring`` / ``maybe_drain`` are the lanes overlay's and the
pool's are ``drain_ring_paged`` / ``maybe_drain_paged``."""
from .paged import (BlockPool, StepPlan, copy_block, gather_view,
                    load_blocks, logical_to_physical, make_paged_kv,
                    pool_rows, prefix_page_hashes, scatter_prefill,
                    scatter_token, step_plan, unload_blocks, view_len,
                    view_mask, view_rows, whole)
from .paged import drain_ring as drain_ring_paged
from .paged import maybe_drain as maybe_drain_paged
from .staged import (add_ring, drain_ring, maybe_drain, overlay_kv,
                     overlay_masks, overlay_step, ring_commit, ring_conflicts,
                     ring_full, ring_state, ring_validity, stage_tile,
                     strip_ring)

__all__ = [
    "BlockPool", "StepPlan", "copy_block", "drain_ring_paged", "gather_view",
    "load_blocks", "logical_to_physical", "make_paged_kv",
    "maybe_drain_paged", "pool_rows", "prefix_page_hashes",
    "scatter_prefill", "scatter_token", "step_plan", "unload_blocks",
    "view_len", "view_mask", "view_rows", "whole",
    "add_ring", "drain_ring", "maybe_drain", "overlay_kv", "overlay_masks",
    "overlay_step", "ring_commit", "ring_conflicts", "ring_full",
    "ring_state", "ring_validity", "stage_tile", "strip_ring",
]
