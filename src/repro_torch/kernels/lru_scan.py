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
its own chain and gives the JAX scan's hit flags exactly. On the card one
call is five launches. Three bucket the writes by (cache, set) key
(``bucket_keys``) with a stable counting sort written by hand: a per-tile
histogram, an exclusive scan in (key, tile) order, and a scatter of the
regions into key-major buckets in time order (``lru_buckets_ref`` is
their plain version; ``lru_scan_buckets`` returns what a call's bucketing
wrote beside its flags). The fourth runs one
chain a thread over its bucket, the set's ways in registers as a recency
list 8, 16 or 32 deep (JAX's stamps order a set's ways by recency, so
its least recent way is the victim; by LRU's inclusion one list serves
every way count up to its depth), the step branch-free, so a warp lasts
as long as its longest chain; it ORs its hits into a bit map of bucket
positions. The fifth moves each bit to its write's index. Scratch (tile
counts, offsets, sorted regions, bucket positions, bits: about 8 bytes a
write) comes from ``torch.empty`` here. A call counts one in
``lru_scan.launches`` and, as each of its kernels is launched, one in that
kernel's entry of ``lru_scan.kernel_launches`` (``LRU_KERNELS``).

Bound: the larger of the bytes (each region and flag read once, each hit
flag written once) over the memory rate, and the longest set's chain times
one dependent step (``longest_chain`` gives its length): at 1 region every
write of a cache falls into one set. The bucketing's traffic is the
kernel's cost, not part of the bound.

On a CPU tensor ``lru_scan`` runs the plain version, the same recurrence
over per-set Python lists; on a CUDA tensor it launches the kernels or
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


def bucket_keys(regions: torch.Tensor, unload: torch.Tensor,
                mtt=(512, 8), tlb=(256, 8)) -> torch.Tensor:
    """int64[n]: each write's (cache, set) key, the MTT's sets first
    (``region % mtt_sets``), then the TLB's (``mtt_sets + region %
    tlb_sets``)."""
    r = regions.long()
    return torch.where(unload.bool(), mtt[0] + r % tlb[0], r % mtt[0])


def longest_chain(regions: torch.Tensor, unload: torch.Tensor,
                  mtt=(512, 8), tlb=(256, 8)) -> int:
    """The most writes any one (cache, set) takes: the kernel's serial
    depth."""
    key = bucket_keys(regions, unload, mtt, tlb)
    return int(torch.bincount(key, minlength=mtt[0] + tlb[0]).max())


def lru_buckets_ref(regions: torch.Tensor, unload: torch.Tensor,
                    mtt=(512, 8), tlb=(256, 8)):
    """Plain version of the bucketing: ``(order, offsets)``, int64[n] the
    writes' indices sorted by ``bucket_keys``, time order kept within a key,
    and int64[keys + 1] where each key's bucket starts in ``order`` (the
    last is n)."""
    _check(regions, unload, mtt, tlb)
    key = bucket_keys(regions, unload, mtt, tlb)
    order = torch.sort(key, stable=True).indices
    sizes = torch.bincount(key, minlength=mtt[0] + tlb[0])
    offsets = torch.cat([sizes.new_zeros(1), sizes.cumsum(0)])
    return order, offsets


# lru_scan's five kernels, in launch order: the bucketing's three, the
# chains, the flags
LRU_KERNELS = ("lru_bucket_count", "lru_bucket_offsets", "lru_bucket_scatter",
               "lru_chain", "lru_flags")


def _scan(regions, unload, mtt, tlb):
    """One ``lru_scan_launch`` (the five kernels) on a non-empty CUDA
    stream: the hit flags and the scratch, all int32 from ``torch.empty``:
    ``counts`` (each tile's count a key), ``totals`` (a key's count, and
    the offsets pass's ticket), ``offsets`` (the buckets' starts),
    ``sorted`` (the regions in bucket order), ``inv`` (each write's bucket
    position) and ``bits`` (the chain's hit bits, one a bucket position).
    About 8 bytes a write. Each kernel the call launched adds one to its
    count in ``lru_scan.kernel_launches``; the call adds one to
    ``lru_scan.launches``."""
    lib = build.load_library()
    keys = mtt[0] + tlb[0]
    if keys > lib.lru_scan_max_keys():
        raise ValueError(f"lru_scan: {mtt[0]} + {tlb[0]} cache sets, the "
                         f"kernel takes at most {lib.lru_scan_max_keys()}")
    n = regions.shape[0]
    if n >= 1 << 27:
        raise ValueError(f"lru_scan: {n} writes, the kernel takes fewer "
                         f"than 2^27")
    tile = lib.lru_scan_tile()
    tiles = -(-n // tile)

    def i32(size):
        return torch.empty((size,), dtype=torch.int32, device=regions.device)

    reg = regions.to(torch.int64).contiguous()
    unl = (unload if unload.dtype == torch.bool
           else unload != 0).contiguous().view(torch.uint8)
    t = dict(counts=i32(tiles * keys), totals=i32(keys + 1),
             offsets=i32(keys + 1), sorted=i32(n), inv=i32(n),
             bits=i32(tiles * tile // 32))
    hit = torch.empty((n,), dtype=torch.uint8, device=regions.device)
    launched = torch.zeros((len(LRU_KERNELS),), dtype=torch.int32)
    with build.on_device(regions.device):
        err = lib.lru_scan_launch(
            reg.data_ptr(), unl.data_ptr(), n, mtt[0], mtt[1], tlb[0], tlb[1],
            *(t[k].data_ptr() for k in ("counts", "totals", "offsets",
                                        "sorted", "inv", "bits")),
            hit.data_ptr(), launched.data_ptr(),
            torch.cuda.current_stream(regions.device).cuda_stream)
    for name, c in zip(LRU_KERNELS, launched.tolist()):
        lru_scan.kernel_launches[name] += c
    if err != 0:
        raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    lru_scan.launches += 1
    return hit.view(torch.bool), t


def lru_scan(regions: torch.Tensor, unload: torch.Tensor,
             mtt=(512, 8), tlb=(256, 8)) -> torch.Tensor:
    """bool[n] hit flags of the two-cache LRU scan (see the module note).
    ``regions`` int[n] (non-negative, below 2^31), ``unload`` bool[n]. On
    the card one call is five launches and counts one."""
    _check(regions, unload, mtt, tlb)
    if regions.device.type == "cpu":
        return lru_scan_ref(regions, unload, mtt, tlb)
    if regions.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=regions.device)
    return _scan(regions, unload, mtt, tlb)[0]


def lru_scan_buckets(regions: torch.Tensor, unload: torch.Tensor,
                     mtt=(512, 8), tlb=(256, 8)):
    """``lru_scan``'s flags and the bucketing that the same call ran:
    ``(hit, inv, offsets)``, ``inv`` int64[n] each write's position in
    ``lru_buckets_ref``'s order (``order[inv[i]] == i``) and ``offsets``
    int64[keys + 1] its offsets. On a CPU tensor the plain versions."""
    _check(regions, unload, mtt, tlb)
    if regions.device.type == "cpu":
        order, offsets = lru_buckets_ref(regions, unload, mtt, tlb)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0])
        return lru_scan_ref(regions, unload, mtt, tlb), inv, offsets
    if regions.shape[0] == 0:
        return (torch.zeros((0,), dtype=torch.bool, device=regions.device),
                torch.zeros((0,), dtype=torch.int64, device=regions.device),
                torch.zeros((mtt[0] + tlb[0] + 1,), dtype=torch.int64,
                            device=regions.device))
    hit, t = _scan(regions, unload, mtt, tlb)
    return hit, t["inv"].long(), t["offsets"].long()


lru_scan.launches = 0
lru_scan.kernel_launches = dict.fromkeys(LRU_KERNELS, 0)
