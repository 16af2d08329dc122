"""Port of repro/core/simulator.py: the paper's section 4 workload generator
only. The calibrated latency simulator (``RDMASimulator``, ``LatencyModel``)
is not ported yet.

The workload: 16 B writes to 4 KB regions whose ids are drawn Zipf(skew)
from ``n_regions`` (the paper's headline is at 2^20 regions, skew 0.5).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .types import resolve_device


@functools.lru_cache(maxsize=4)
def _zipf_cdf(n_regions: int, skew: float) -> torch.Tensor:
    """float32[n_regions] Zipf(skew) CDF, summed on the CPU in index order.
    A float cumsum on CUDA adds in an order that changes from run to run, so
    the same seed drew other regions in each run; summed here, the card and
    the CPU draw the same regions from the same uniforms."""
    ranks = torch.arange(1, n_regions + 1, dtype=torch.float32)
    cdf = torch.cumsum(ranks ** -skew, 0)
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
