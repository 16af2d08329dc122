"""Port of repro/kernels/ops.py: the public wrappers around the kernels.

Dispatch rule: a CPU tensor runs the kernel's plain PyTorch version, a CUDA
tensor launches the hand-written kernel or raises. There is no ``impl``
switch and no fallback on the GPU. Each wrapper counts its launches
(``wrapper.launches``); ``launch_counts`` sums them by kernel.
"""
from __future__ import annotations

from typing import Dict

from .cms import (cms_query, cms_query_ref, cms_update, cms_update_query,
                  cms_update_query_ref, cms_update_ref)
from .flash_attention import flash_attention, flash_attention_ref
from .flash_decode import (flash_decode, flash_decode_paged,
                           flash_decode_paged_ref, flash_decode_paged_sharded,
                           flash_decode_paged_sharded_ref, flash_decode_ref)
from .lru_scan import lru_scan, lru_scan_ref
from .staged_scatter import (staged_scatter, staged_scatter_layers,
                             staged_scatter_ref)

_WRAPPERS = {
    "staged_scatter": (staged_scatter, staged_scatter_layers),
    "flash_decode_paged": (flash_decode_paged,),
    "flash_attention": (flash_attention,),
    "flash_decode": (flash_decode,),
    "cms_update": (cms_update,),
    "cms_query": (cms_query,),
    "cms_update_query": (cms_update_query,),
    "lru_scan": (lru_scan,),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {k: sum(w.launches for w in ws) for k, ws in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for ws in _WRAPPERS.values():
        for w in ws:
            w.launches = 0


__all__ = [
    "cms_query", "cms_query_ref", "cms_update", "cms_update_query",
    "cms_update_query_ref", "cms_update_ref", "flash_attention", "flash_attention_ref", "flash_decode",
    "flash_decode_ref", "flash_decode_paged", "flash_decode_paged_ref",
    "flash_decode_paged_sharded", "flash_decode_paged_sharded_ref",
    "lru_scan", "lru_scan_ref", "staged_scatter",
    "staged_scatter_layers", "staged_scatter_ref", "launch_counts",
    "reset_launch_counts",
]
