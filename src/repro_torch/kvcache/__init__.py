"""Port of repro/kvcache/__init__.py: the paged block pool backing the
continuous-batching serve scheduler, with its staging-ring overlay. The
dense-lane overlay (``kvcache/staged.py``) is not ported yet."""
from .paged import (BlockPool, StepPlan, drain_ring, gather_view,
                    logical_to_physical, make_paged_kv, maybe_drain,
                    pool_rows, scatter_token, step_plan, view_len, view_mask,
                    view_rows)

__all__ = [
    "BlockPool", "StepPlan", "drain_ring", "gather_view",
    "logical_to_physical", "make_paged_kv", "maybe_drain", "pool_rows",
    "scatter_token", "step_plan", "view_len", "view_mask", "view_rows",
]
