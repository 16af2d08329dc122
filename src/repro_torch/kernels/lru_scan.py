"""The simulator's sequential cache scan: two set-associative LRU caches
(the RNIC's MTT and the CPU's dTLB) probed and filled by a write stream.

Source note
-----------
Replaces no Pallas kernel: the JAX package runs this recurrence as a
``lax.scan``, one write a step (``repro/core/simulator.py``,
``RDMASimulator.run`` over ``cache_access``). Write ``i`` probes the MTT
when ``unload[i]`` is False and the dTLB when it is True: in set ``s =
region % n_sets`` a hit refreshes its way's stamp, a miss fills the first
way with the smallest stamp; the other cache is not touched and its clock
does not move. The result is one hit flag per write.

A write's outcome depends only on the earlier writes that enabled the same
set of the same cache, so ``csrc/lru_scan.cu`` runs every (cache, set) as
its own chain, one warp a set, the ways on lanes (probe: a ballot; LRU
choice: a warp min-reduce, the lowest way winning ties), with a clock per
set: the stamps' order within a set, and so every hit, fill and victim, is
the JAX scan's. Each warp walks the whole stream in time order and keeps
the writes of its set with a ballot (no sort, so no scratch and no second
launch; the price is that every warp reads the stream from L2).

Bound: the larger of the bytes (each region and flag read once, each hit
flag written once) over the memory rate, and the longest set's chain times
one dependent step (``longest_chain`` gives its length): at 1 region every
write of a cache falls into one set.

On a CPU tensor ``lru_scan`` runs the plain version, the same recurrence
over per-set Python lists; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from . import build


def _check(regions: torch.Tensor, unload: torch.Tensor, mtt, tlb) -> None:
    if regions.dim() != 1 or unload.shape != regions.shape:
        raise ValueError(f"regions and unload must be [n] each, got "
                         f"{tuple(regions.shape)} / {tuple(unload.shape)}")
    if regions.dtype.is_floating_point or regions.dtype == torch.bool:
        raise TypeError(f"regions must be integers, got {regions.dtype}")
    if unload.device != regions.device:
        raise ValueError("regions and unload must share a device")
    for n_sets, n_ways in (mtt, tlb):
        if n_sets < 1 or not 1 <= n_ways <= 32:
            raise ValueError(f"a cache of {n_sets} sets x {n_ways} ways: "
                             f"need >= 1 set and 1-32 ways")


def lru_scan_ref(regions: torch.Tensor, unload: torch.Tensor,
                 mtt=(512, 8), tlb=(256, 8)) -> torch.Tensor:
    """Plain version: bool[n] hit flags, each write probing the MTT
    (``unload`` False) or the dTLB (True); ``mtt`` / ``tlb`` are
    ``(n_sets, n_ways)``."""
    _check(regions, unload, mtt, tlb)
    caches = []
    for n_sets, n_ways in (mtt, tlb):
        caches.append((n_sets, [[-1] * n_ways for _ in range(n_sets)],
                       [[0] * n_ways for _ in range(n_sets)], [0] * n_sets))
    hit = []
    for r, u in zip(regions.tolist(), unload.tolist()):
        n_sets, tags, stamps, clocks = caches[bool(u)]
        s = r % n_sets
        line, st = tags[s], stamps[s]
        if r in line:
            way = line.index(r)
            hit.append(True)
        else:
            way = st.index(min(st))
            hit.append(False)
        clocks[s] += 1
        line[way] = r
        st[way] = clocks[s]
    return torch.tensor(hit, dtype=torch.bool, device=regions.device)


def longest_chain(regions: torch.Tensor, unload: torch.Tensor,
                  mtt=(512, 8), tlb=(256, 8)) -> int:
    """The most writes any one (cache, set) takes: the kernel's serial
    depth."""
    mtt_sets, tlb_sets = mtt[0], tlb[0]
    r = regions.long()
    u = unload.bool()
    key = torch.where(u, mtt_sets + r % tlb_sets, r % mtt_sets)
    return int(torch.bincount(key, minlength=mtt_sets + tlb_sets).max())


def lru_scan(regions: torch.Tensor, unload: torch.Tensor,
             mtt=(512, 8), tlb=(256, 8)) -> torch.Tensor:
    """bool[n] hit flags of the two-cache LRU scan (see the module note).
    ``regions`` int[n] (non-negative, below 2^31), ``unload`` bool[n]."""
    _check(regions, unload, mtt, tlb)
    if regions.device.type == "cpu":
        return lru_scan_ref(regions, unload, mtt, tlb)
    n = regions.shape[0]
    hit = torch.empty((n,), dtype=torch.uint8, device=regions.device)
    if n == 0:
        return hit.bool()
    reg = regions.to(torch.int64).contiguous()
    unl = (unload if unload.dtype == torch.bool
           else unload != 0).contiguous().view(torch.uint8)
    with build.on_device(regions.device):
        err = build.load_library().lru_scan_launch(
            reg.data_ptr(), unl.data_ptr(), n, mtt[0], mtt[1], tlb[0],
            tlb[1], hit.data_ptr(),
            torch.cuda.current_stream(regions.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    lru_scan.launches += 1
    return hit.view(torch.bool)


lru_scan.launches = 0
