"""Port of repro/kernels/ops.py: the public wrappers around the kernels.

Dispatch rule: a CPU tensor runs the kernel's plain PyTorch version, a CUDA
tensor launches the hand-written kernel or raises, and a ``meta`` tensor
(the dry-run cells of ``launch.cells``) shapes and counts but never
computes a value: the wrapper makes every output and scratch tensor it
makes on the card, skips the launch, and adds the kernel's operations and
bytes (``cost``) to the active ``cost.KernelCounter``. There is no ``impl``
switch and no fallback on the GPU. Each wrapper counts its real launches
(``wrapper.launches``); ``launch_counts`` sums them by kernel. K3, its
backward, K1's drains and gather and K4 take ``meta`` tensors; the paged
reads (K2, K2s), the sketch's kernels and the LRU scan do not.
"""
from __future__ import annotations

from typing import Dict

from .cms import (cms_query, cms_query_ref, cms_update, cms_update_query,
                  cms_update_query_ref, cms_update_ref)
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_bwd, flash_attention_bwd_ref,
                              flash_attention_lse, flash_attention_lse_ref,
                              flash_attention_ref)
from .flash_decode import (flash_decode, flash_decode_paged,
                           flash_decode_paged_ref, flash_decode_paged_sharded,
                           flash_decode_paged_sharded_ref, flash_decode_ref)
from .lru_scan import lru_buckets_ref, lru_scan, lru_scan_ref
from .staged_scatter import (staged_drain, staged_gather, staged_gather_ref,
                             staged_scatter, staged_scatter_layers,
                             staged_scatter_planes, staged_scatter_planes_ref,
                             staged_scatter_ref)

_WRAPPERS = {
    "staged_scatter": (staged_scatter, staged_scatter_layers,
                       staged_scatter_planes),
    "flash_decode_paged": (flash_decode_paged,),
    "flash_decode_paged_sharded": (flash_decode_paged_sharded,),
    "flash_attention": (flash_attention,),
    # training: K3's backward, K1 as the functional drain, and its adjoint
    "flash_attention_bwd": (flash_attention_bwd,),
    "staged_drain": (staged_drain,),
    "staged_gather": (staged_gather,),
    "flash_decode": (flash_decode,),
    "cms_update": (cms_update,),
    "cms_query": (cms_query,),
    "cms_update_query": (cms_update_query,),
    "lru_scan": (lru_scan,),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {k: sum(w.launches for w in ws) for k, ws in _WRAPPERS.items()}


def kernel_launch_counts() -> Dict[str, int]:
    """Launches since the last reset of each kernel of a wrapper that
    launches several in one call (``lru_scan``'s five), by kernel name."""
    return dict(lru_scan.kernel_launches)


def reset_launch_counts() -> None:
    for ws in _WRAPPERS.values():
        for w in ws:
            w.launches = 0
    for k in lru_scan.kernel_launches:
        lru_scan.kernel_launches[k] = 0


__all__ = [
    "FlashAttentionFunction", "cms_query", "cms_query_ref", "cms_update",
    "cms_update_query", "cms_update_query_ref", "cms_update_ref",
    "flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
    "flash_attention_lse", "flash_attention_lse_ref", "flash_attention_ref",
    "flash_decode",
    "flash_decode_ref", "flash_decode_paged", "flash_decode_paged_ref",
    "flash_decode_paged_sharded", "flash_decode_paged_sharded_ref",
    "lru_buckets_ref", "lru_scan", "lru_scan_ref",
    "staged_drain", "staged_gather", "staged_gather_ref",
    "staged_scatter", "staged_scatter_layers", "staged_scatter_planes",
    "staged_scatter_planes_ref", "staged_scatter_ref", "kernel_launch_counts", "launch_counts",
    "reset_launch_counts",
]
