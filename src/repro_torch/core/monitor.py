"""Port of repro/core/monitor.py: the heavy-hitter monitor of the decision
module (paper section 3.2).

* ``ExactMonitor``: the paper's array of counters, one per region. Pure
  functional: ``update`` returns a new state (int64 counters).
* ``CMSMonitor``: a count-min sketch for unbounded or huge region universes,
  ``int32[depth, 2^log2_width]`` with multiply-shift hashing. Its update and
  query are the hot path the kernels K5 ``cms_update`` and K6 ``cms_query``
  exist for (``kernels/csrc/cms.cu``; on a CPU tensor their plain versions).
  ``update`` adds the batch to ``state.counts`` IN PLACE and returns the new
  state, which holds the same tensor.

Counters optionally age by halving every ``decay_every`` writes, so the
monitor tracks current heavy hitters. State is made on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..kernels import cms_query, cms_update
from ..kernels.cms import CMS_MULTIPLIERS
from .types import resolve_device


class MonitorState(NamedTuple):
    counts: torch.Tensor  # exact: int64[n_regions]; cms: int32[depth, width]
    total: torch.Tensor   # int64 scalar, total writes observed


def _total(state: MonitorState, region_ids: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    return state.total + (region_ids.shape[0] if mask is None
                          else mask.to(torch.int64).sum())


def _decays(total: torch.Tensor, before: torch.Tensor,
            every: int) -> torch.Tensor:
    """True (a device scalar) where this batch crossed a multiple of
    ``every`` writes, as JAX tests it."""
    return (total % every) < (before % every)


@dataclasses.dataclass(frozen=True)
class ExactMonitor:
    """One counter per region (the paper's baseline monitor)."""

    n_regions: int
    decay_every: int = 0  # 0 = never decay; else halve counters periodically

    def init(self, device="cuda") -> MonitorState:
        dev = resolve_device(device)
        return MonitorState(
            counts=torch.zeros((self.n_regions,), dtype=torch.int64,
                               device=dev),
            total=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def update(self, state: MonitorState, region_ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> MonitorState:
        """``mask`` (bool[n], optional) drops masked ids from the counters.
        Repeated ids add up (``index_add``, a scatter-ADD)."""
        ids = region_ids.long()
        delta = (torch.ones_like(ids) if mask is None
                 else mask.to(torch.int64))
        counts = state.counts.index_add(0, ids, delta)
        total = _total(state, region_ids, mask)
        if self.decay_every:
            do_decay = _decays(total, state.total, self.decay_every)
            counts = torch.where(do_decay, counts // 2, counts)
        return MonitorState(counts, total)

    def query(self, state: MonitorState,
              region_ids: torch.Tensor) -> torch.Tensor:
        return state.counts[region_ids.long()]


@dataclasses.dataclass(frozen=True)
class CMSMonitor:
    """Count-min sketch monitor (``depth`` x ``2^log2_width``)."""

    depth: int = 4
    log2_width: int = 12
    decay_every: int = 0

    def __post_init__(self):
        if not 1 <= self.depth <= len(CMS_MULTIPLIERS):
            raise ValueError(f"depth must be in [1, {len(CMS_MULTIPLIERS)}]")

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    def init(self, device="cuda") -> MonitorState:
        dev = resolve_device(device)
        return MonitorState(
            counts=torch.zeros((self.depth, self.width), dtype=torch.int32,
                               device=dev),
            total=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def update(self, state: MonitorState, region_ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> MonitorState:
        """K5 on ``state.counts``, IN PLACE; masked ids add nothing to the
        counters or the total. The decay halves the counters in place
        (divides by 1 or 2), with no read on the host."""
        counts = cms_update(state.counts, region_ids, mask)
        total = _total(state, region_ids, mask)
        if self.decay_every:
            do_decay = _decays(total, state.total, self.decay_every)
            counts.div_(1 + do_decay.to(torch.int32), rounding_mode="floor")
        return MonitorState(counts, total)

    def query(self, state: MonitorState,
              region_ids: torch.Tensor) -> torch.Tensor:
        """K6: ``int32[n]`` count-min estimate of each region."""
        return cms_query(state.counts, region_ids)


def calibrate_threshold(counts: torch.Tensor,
                        offload_top_k: int) -> torch.Tensor:
    """A count threshold that keeps about the top-k regions offloaded (the
    paper: thresholds are found off the critical path from the frequency
    distribution). Call it off the hot loop and feed the scalar back into
    ``FrequencyPolicy``. As in JAX, k is capped at ``counts.shape[0]``
    (for a ``[depth, width]`` sketch, the depth) and the top k are taken
    over all the counters."""
    k = min(int(offload_top_k), counts.shape[0])
    if k <= 0:
        return torch.tensor(torch.iinfo(torch.int32).max, dtype=torch.int32,
                            device=counts.device)
    return torch.topk(counts.reshape(-1), k).values[-1].to(torch.int32)
