"""Port of repro/core/monitor.py (the serving path's share).

Heavy-hitter monitor for the decision module: ``ExactMonitor``, the paper's
array of counters, one per region. ``CMSMonitor`` and
``calibrate_threshold`` wait for the count-min-sketch kernels and are not
ported yet. Pure functional: ``update`` returns a new state (the counter
array is small, so the copy is cheap).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class MonitorState(NamedTuple):
    counts: torch.Tensor  # int64[n_regions]
    total: torch.Tensor   # int64 scalar, total writes observed


@dataclasses.dataclass(frozen=True)
class ExactMonitor:
    """One counter per region (paper's baseline monitor)."""

    n_regions: int
    decay_every: int = 0  # 0 = never decay; else halve counters periodically

    def init(self, device="cpu") -> MonitorState:
        return MonitorState(
            counts=torch.zeros((self.n_regions,), dtype=torch.int64,
                               device=device),
            total=torch.zeros((), dtype=torch.int64, device=device),
        )

    def update(self, state: MonitorState, region_ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> MonitorState:
        """``mask`` (bool[n], optional) drops masked ids from the counters.
        Repeated ids add up (``index_add``, a scatter-ADD)."""
        ids = region_ids.long()
        if mask is None:
            delta = torch.ones_like(ids)
            n = ids.shape[0]
        else:
            delta = mask.to(torch.int64)
            n = delta.sum()
        counts = state.counts.index_add(0, ids, delta)
        total = state.total + n
        if self.decay_every:
            do_decay = (total % self.decay_every) < (
                state.total % self.decay_every)
            counts = torch.where(do_decay, counts // 2, counts)
        return MonitorState(counts, total)

    def query(self, state: MonitorState,
              region_ids: torch.Tensor) -> torch.Tensor:
        return state.counts[region_ids.long()]
