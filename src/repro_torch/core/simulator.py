"""Port of repro/core/simulator.py: the calibrated RDMA-write latency
simulator that reproduces the paper's Fig. 3.

No RNIC is modelled in hardware: the paper's section 4 evaluation is
reproduced with a model whose constants (``core.types.LatencyModel``) are
the paper's own microseconds (~2.6 us all-hit RTT, ~5.1 us at 2^20 regions,
~3.4 us unload, ~3.5 us unload at 2^20). They are model constants, not
times of any device.

* MTT cache: a set-associative LRU over region translations at the target
  RNIC. Offloaded writes probe and fill it; hit -> ``t_offload_hit``, miss
  -> ``t_offload_miss``. Unloaded writes bypass it.
* CPU dTLB: the unload path's final memcpy probes a second, larger
  set-associative LRU; a miss adds ``t_cpu_tlb_walk``.
* Copy cost: payloads beyond the 16 B inlined size add size / copy_gbps.

The scan over the write stream is the kernel ``kernels.lru_scan`` on a CUDA
tensor (a stable counting sort of the writes by cache set, then one thread
a set with its ways in registers; bound by the longest set's chain of
dependent steps) and its plain Python version on a CPU tensor; the
latency arithmetic is elementwise torch, as the JAX package's ``jnp.where``s
are. ``CacheState`` / ``make_cache`` / ``cache_access`` are the JAX
package's one-write-at-a-time step, kept as the reference. The workload
generator reproduces section 4: 16 B inlined writes, destination 4 KB
region drawn Zipf(0.5) from R regions. The adaptive lines of Fig. 3 route
every write through the real ``core.policy`` / ``core.monitor`` code.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import lru_scan
from .types import (CPUTLBConfig, LatencyModel, MTTConfig, make_write_batch,
                    resolve_device)


# ---------------------------------------------------------------------------
# Workload (paper section 4)
# ---------------------------------------------------------------------------


def _cumsum_blocked(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """float32 inclusive prefix sum in the association order of XLA's CPU
    cumsum (its reduce-window rewrite): sequential sums within blocks of
    ``base``, the blocks' totals scanned the same way, recursively, and each
    block offset by the total before it. Every add is a float32 add."""
    n = x.shape[0]
    m = -(-n // base)
    blocks = torch.zeros(m * base, dtype=x.dtype)
    blocks[:n] = x
    blocks = blocks.view(m, base)
    inner = torch.empty_like(blocks)
    acc = blocks[:, 0].clone()
    inner[:, 0] = acc
    for j in range(1, base):
        acc = acc + blocks[:, j]
        inner[:, j] = acc
    if m > 1:
        inner[1:] += _cumsum_blocked(inner[:, -1].contiguous(), base)[:-1, None]
    return inner.reshape(-1)[:n]


@functools.lru_cache(maxsize=4)
def _zipf_cdf(n_regions: int, skew: float) -> torch.Tensor:
    """float32[n_regions] Zipf(skew) CDF, computed on the CPU. A float
    cumsum on CUDA adds in an order that changes from run to run, so the
    same seed drew other regions in each run; made here, the card and the
    CPU draw the same regions from the same uniforms. The CDF is the JAX
    package's bit for bit at the paper's skew 0.5 (each of the 11 region
    counts of its sweep): the powers are taken in float64 and rounded, and
    the sum runs in XLA's order (``_cumsum_blocked``). A torch float32
    cumsum (it accumulates in float64) put 7420 of 200 000 draws at 2^20
    regions one region off JAX's. At other skews XLA's float32 power, which
    is not rounded correctly, can still move a few CDF entries by an ulp."""
    ranks = torch.arange(1, n_regions + 1, dtype=torch.float64)
    cdf = _cumsum_blocked((ranks ** -skew).to(torch.float32))
    return cdf / cdf[-1]


def zipf_regions(n_writes: int, n_regions: int, skew: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64[n_writes] destination regions ~ Zipf(skew) over [0, n_regions),
    by the inverse CDF of uniforms ``u`` (drawn from ``generator`` on
    ``device``, the card unless the caller asks for the CPU, when not
    given; else on ``u``'s device)."""
    if u is None:
        u = torch.rand((n_writes,), generator=generator,
                       device=resolve_device(device))
    return torch.searchsorted(_zipf_cdf(n_regions, float(skew)).to(u.device),
                              u)


# ---------------------------------------------------------------------------
# Set-associative LRU cache (MTT / CPU dTLB): the one-write reference step
# ---------------------------------------------------------------------------


class CacheState(NamedTuple):
    tags: torch.Tensor   # int64[n_sets, n_ways], -1 = empty
    stamp: torch.Tensor  # int64[n_sets, n_ways], last-use time (LRU)
    clock: torch.Tensor  # int64 scalar


def make_cache(n_sets: int, n_ways: int, device="cuda") -> CacheState:
    dev = resolve_device(device)
    return CacheState(
        tags=torch.full((n_sets, n_ways), -1, dtype=torch.int64, device=dev),
        stamp=torch.zeros((n_sets, n_ways), dtype=torch.int64, device=dev),
        clock=torch.zeros((), dtype=torch.int64, device=dev))


def cache_access(state: CacheState, region, enabled
                 ) -> Tuple[CacheState, torch.Tensor]:
    """One probe + fill, as the JAX package's step: ``enabled`` False
    leaves the cache (and its clock) untouched. Returns (new state, hit
    flag). The first hitting way and the first least-recent way win."""
    n_sets, n_ways = state.tags.shape
    region = torch.as_tensor(region, device=state.tags.device)
    enabled = torch.as_tensor(enabled, device=state.tags.device)
    s = region % n_sets
    line_tags, line_stamp = state.tags[s], state.stamp[s]
    hits = line_tags == region
    hit = hits.any()
    clock = state.clock + 1
    way = torch.where(hit, torch.argmax(hits.to(torch.int8)),
                      torch.argmin(line_stamp))
    tags, stamp = state.tags.clone(), state.stamp.clone()
    tags[s, way] = torch.where(enabled, region, line_tags[way])
    stamp[s, way] = torch.where(enabled, clock, line_stamp[way])
    return (CacheState(tags, stamp, torch.where(enabled, clock, state.clock)),
            hit & enabled)


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------


class SimResult(NamedTuple):
    latency_us: torch.Tensor   # float32[n] per-write latency (model us)
    mtt_hits: torch.Tensor     # int64: offloaded writes that hit the MTT
    n_offloaded: torch.Tensor  # int64
    n_unloaded: torch.Tensor   # int64


@dataclasses.dataclass(frozen=True)
class RDMASimulator:
    mtt: MTTConfig = MTTConfig()
    cpu_tlb: CPUTLBConfig = CPUTLBConfig()
    lat: LatencyModel = LatencyModel()

    def run(self, regions: torch.Tensor, unload_mask: torch.Tensor,
            sizes: Optional[torch.Tensor] = None) -> SimResult:
        """``regions`` int[n] destination regions in time order,
        ``unload_mask`` bool[n] the decision per write. Runs where the
        tensors lie: one ``lru_scan`` launch on the card, its plain version
        on the CPU."""
        n = regions.shape[0]
        unload = unload_mask.bool()
        if sizes is None:
            sizes = torch.full((n,), 16, dtype=torch.int64,
                               device=regions.device)
        hit = lru_scan(regions, unload,
                       mtt=(self.mtt.n_sets, self.mtt.n_ways),
                       tlb=(self.cpu_tlb.n_sets, self.cpu_tlb.n_ways))
        lat = self.lat
        mtt_hit = hit & ~unload
        t_off = torch.where(mtt_hit, lat.t_offload_hit, lat.t_offload_miss)
        t_un = (lat.t_unload_base
                + torch.where(hit, 0.0, lat.t_cpu_tlb_walk)
                + lat.unload_copy_us(sizes))
        n_un = unload.sum()
        return SimResult(latency_us=torch.where(unload, t_un, t_off),
                         mtt_hits=mtt_hit.sum(), n_offloaded=n - n_un,
                         n_unloaded=n_un)


# ---------------------------------------------------------------------------
# Fig. 3 sweep points
# ---------------------------------------------------------------------------


def decide_batch(policy, monitor, regions: torch.Tensor) -> torch.Tensor:
    """Run the REAL decision module over the whole write stream. For the
    stateless paper policies (hint tables) decisions are per write; for
    frequency policies the monitor takes the whole stream first (batched:
    the steady-state approximation of per-write updates, as in the JAX
    package), then the policy decides. Over a ``CMSMonitor`` that is one K5
    ``cms_update`` and one K6 ``cms_query`` launch."""
    batch = make_write_batch(regions)
    state = None
    if monitor is not None:
        state = monitor.update(monitor.init(regions.device), regions)
    return policy.decide(state, batch)


def sweep_point(key: torch.Tensor, n_regions: int, n_writes: int,
                warmup: int, policy, monitor=None, skew: float = 0.5,
                sim: Optional[RDMASimulator] = None, device="cuda",
                ) -> Tuple[float, SimResult]:
    """Average steady-state RTT (model us) for one Fig. 3 x-axis point.
    ``key`` is key data of ``models.prng`` (``prng.key(seed)``): the
    uniforms are ``prng.uniform(key, n_writes)``, the bits
    ``jax.random.uniform(jax.random.key(seed), (n_writes,))`` draws, so one
    seed gives the JAX package's writes. Runs on ``device``, the card
    unless the caller asks for the CPU."""
    from ..models import prng  # the models package imports core

    dev = resolve_device(device)
    sim = sim or RDMASimulator()
    u = prng.uniform(key.to(dev), n_writes)
    regions = zipf_regions(n_writes, n_regions, skew, u=u)
    unload = decide_batch(policy, monitor, regions)
    res = sim.run(regions, unload)
    return float(res.latency_us[warmup:].mean()), res
