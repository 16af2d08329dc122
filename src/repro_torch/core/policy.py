"""Port of repro/core/policy.py: unload policies (paper section 3.2).

A policy maps a batch of write requests + monitor state to a per-request
routing decision, OFFLOAD (keep on the direct path) or UNLOAD (reroute via
the staging ring). ``AlwaysOffload`` / ``AlwaysUnload`` are the paper's
fixed paths; ``HintPolicy`` offloads what the application marked hot (a
per-request hint, or a hot-region table); ``FrequencyPolicy`` unloads small
writes to regions colder than a threshold; ``HysteresisPolicy`` (beyond the
paper) adds a per-region decision memory between two thresholds. Every
policy is registered by name for ``core.paths.build_decision``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from .monitor import CMSMonitor, ExactMonitor, MonitorState
from .ring import put_
from .types import WriteBatch, resolve_device

Monitor = Union[ExactMonitor, CMSMonitor]

OFFLOADS = frozenset({"offload"})
UNLOADS = frozenset({"unload"})
BOTH_PATHS = OFFLOADS | UNLOADS


class _DecideRoute:
    """RoutingPolicy adapter for decide-style policies: the routing state is
    the (optional) monitor counters; ``route`` = the monitor's ``observe``
    (update, then query the same ids) + decide on those estimates."""

    owns_state = False

    def init_state(self, device="cuda"):
        device = resolve_device(device)
        mon = getattr(self, "monitor", None)
        if self.needs_monitor and mon is not None:
            return mon.init(device)
        return None

    def route(self, state, batch: WriteBatch,
              mask: Optional[torch.Tensor] = None):
        mon = getattr(self, "monitor", None)
        if self.needs_monitor and mon is not None:
            state, est = mon.observe(state, batch.region, mask=mask)
            unload = self.decide(state, batch, est=est)
        else:
            unload = self.decide(state, batch)
        if mask is not None:
            unload = unload & mask
        return unload, state


@dataclasses.dataclass(frozen=True)
class AlwaysOffload(_DecideRoute):
    needs_monitor: bool = False
    emits = OFFLOADS

    def decide(self, state: Optional[MonitorState],
               batch: WriteBatch) -> torch.Tensor:
        return torch.zeros((batch.n,), dtype=torch.bool,
                           device=batch.region.device)


@dataclasses.dataclass(frozen=True)
class AlwaysUnload(_DecideRoute):
    needs_monitor: bool = False
    emits = UNLOADS

    def decide(self, state: Optional[MonitorState],
               batch: WriteBatch) -> torch.Tensor:
        return torch.ones((batch.n,), dtype=torch.bool,
                          device=batch.region.device)


@dataclasses.dataclass(frozen=True)
class HintPolicy(_DecideRoute):
    """Offload requests the application marked hot; unload the rest. Either
    the per-request ``hint`` field (the paper's "marks the requests ... in
    the RDMA post"), or membership in a ``hot_regions`` table (the paper's
    evaluation: hot = the top-4096 regions). Writes larger than
    ``max_unload_size`` stay offloaded."""

    hot_regions: Optional[torch.Tensor] = None  # bool[n_regions]
    max_unload_size: int = 4096
    needs_monitor: bool = False
    emits = BOTH_PATHS

    def decide(self, state: Optional[MonitorState],
               batch: WriteBatch) -> torch.Tensor:
        if self.hot_regions is not None:
            hot = self.hot_regions[batch.region]
        else:
            hot = batch.hint.to(torch.bool)
        return ~hot & (batch.size <= self.max_unload_size)


@dataclasses.dataclass(frozen=True)
class FrequencyPolicy(_DecideRoute):
    """Unload small writes to regions colder than a frequency threshold.
    ``threshold`` is an absolute count; ``rel`` alternatively expresses it
    relative to the uniform expectation (count < rel * total / n_regions)."""

    monitor: Monitor = dataclasses.field(
        default_factory=lambda: ExactMonitor(1 << 20))
    threshold: Optional[int] = None
    rel: Optional[float] = None
    n_regions: Optional[int] = None
    max_unload_size: int = 4096
    needs_monitor: bool = True
    emits = BOTH_PATHS

    def decide(self, state: MonitorState, batch: WriteBatch,
               est: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``est``: the monitor's estimate of each request's region, where
        the caller already has it from ``observe``; else it is queried."""
        if est is None:
            est = self.monitor.query(state, batch.region)
        if self.threshold is not None:
            thr = int(self.threshold)
        elif self.rel is not None:
            n_regions = self.n_regions or getattr(self.monitor, "n_regions",
                                                  None)
            if n_regions is None:
                raise ValueError("rel threshold needs n_regions")
            thr = (self.rel * state.total.to(torch.float32)
                   / n_regions).to(torch.int64)
        else:
            raise ValueError("FrequencyPolicy needs threshold or rel")
        small = batch.size <= self.max_unload_size
        return (est < thr) & small


class HysteresisState(NamedTuple):
    """State of :class:`HysteresisPolicy`: the monitor counters plus each
    region's LAST routing decision (the hysteresis memory)."""

    mon: MonitorState
    last_unload: torch.Tensor  # bool[n_regions], True = region was unloaded


@dataclasses.dataclass(frozen=True)
class HysteresisPolicy:
    """Beyond the paper: frequency routing with decision hysteresis. Unload
    below ``lo``, offload at or above ``hi``; in between each region keeps
    its last decision. The memory starts on the offload side. It needs a
    bounded region universe, ``n_regions`` (explicit, or an
    ``ExactMonitor``'s); larger region ids (a ``CMSMonitor``'s universe) are
    bucketed ``region % n_regions``, deterministic aliasing as the sketch
    aliases counts."""

    monitor: Monitor = dataclasses.field(
        default_factory=lambda: ExactMonitor(1 << 20))
    lo: int = 2
    hi: int = 8
    n_regions: Optional[int] = None
    max_unload_size: int = 4096
    needs_monitor: bool = True
    emits = BOTH_PATHS
    owns_state = True

    def _n_regions(self) -> int:
        n = self.n_regions or getattr(self.monitor, "n_regions", None)
        if n is None:
            raise ValueError(
                "HysteresisPolicy needs n_regions (or an ExactMonitor) for "
                "the last-decision table")
        return int(n)

    def init_state(self, device="cuda") -> HysteresisState:
        dev = resolve_device(device)
        return HysteresisState(
            mon=self.monitor.init(dev),
            last_unload=torch.zeros((self._n_regions(),), dtype=torch.bool,
                                    device=dev))

    def _band(self, est: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        return torch.where(est < self.lo, True,
                           torch.where(est >= self.hi, False, prev))

    def route(self, state: HysteresisState, batch: WriteBatch,
              mask: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, HysteresisState]:
        """Update the counters, apply the lo/hi bands with the carried
        decision, and record the new decisions IN PLACE on
        ``state.last_unload``. The memory stores the band decision before
        the size gate. Duplicates of a region in one batch share (est, prev)
        and so write one value: the result does not depend on the scatter's
        order. Masked requests update neither the counters nor the memory
        (``ring.put_`` drops them) and never unload."""
        mon, est = self.monitor.observe(state.mon, batch.region, mask=mask)
        bucket = batch.region % state.last_unload.shape[0]
        prev = state.last_unload[bucket]
        band = self._band(est, prev)
        if mask is None:
            state.last_unload[bucket] = band
        else:
            put_(state.last_unload, bucket, band, mask)
        unload = band & (batch.size <= self.max_unload_size)
        if mask is not None:
            unload = unload & mask
        return unload, HysteresisState(mon, state.last_unload)

    def heat(self, state: HysteresisState, regions) -> HysteresisState:
        """Off-critical-path counter heating (bulk admission prefills): the
        regions warm the monitor without recording a routing decision."""
        regions = torch.as_tensor(regions, device=state.last_unload.device)
        return HysteresisState(
            self.monitor.update(state.mon, regions.to(torch.int64)),
            state.last_unload)

    def decide(self, state, batch: WriteBatch) -> torch.Tensor:
        """Read-only decision (no counter update, no memory write) from a
        :class:`HysteresisState`, or from a bare ``MonitorState`` (then the
        mid-band falls back to the safe default, offload)."""
        if isinstance(state, HysteresisState):
            bucket = batch.region % state.last_unload.shape[0]
            mon_state, prev = state.mon, state.last_unload[bucket]
        else:
            mon_state = state
            prev = torch.zeros((batch.n,), dtype=torch.bool,
                               device=batch.region.device)
        est = self.monitor.query(mon_state, batch.region)
        return self._band(est, prev) & (batch.size <= self.max_unload_size)


# ---------------------------------------------------------------------------
# Registry: RoutingPolicy factories by name
# ---------------------------------------------------------------------------

_POLICIES: Dict[str, Callable] = {}


def register_policy(name: str, factory: Callable, *,
                    overwrite: bool = False) -> None:
    """Register a policy factory ``factory(monitor, n_regions,
    hot_threshold, **extra)`` under ``name``."""
    if name in _POLICIES and not overwrite:
        raise ValueError(
            f"policy {name!r} already registered "
            f"(pass overwrite=True to replace it)")
    _POLICIES[name] = factory


def get_policy_factory(name: str) -> Callable:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: "
            f"{sorted(_POLICIES)}") from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def _mk_always_offload(monitor=None, n_regions=None, hot_threshold=None):
    return AlwaysOffload()


def _mk_always_unload(monitor=None, n_regions=None, hot_threshold=None):
    return AlwaysUnload()


def _mk_hint(monitor=None, n_regions=None, hot_threshold=None,
             hot_regions=None, max_unload_size=4096):
    return HintPolicy(hot_regions=hot_regions,
                      max_unload_size=max_unload_size)


def _mk_frequency(monitor=None, n_regions=None, hot_threshold=4,
                  max_unload_size=4096):
    monitor = monitor or ExactMonitor(n_regions=n_regions or (1 << 20))
    return FrequencyPolicy(monitor=monitor, threshold=hot_threshold,
                           max_unload_size=max_unload_size)


def _mk_hysteresis(monitor=None, n_regions=None, hot_threshold=4,
                   lo=None, hi=None, max_unload_size=4096):
    monitor = monitor or ExactMonitor(n_regions=n_regions or (1 << 20))
    hi = hi if hi is not None else max(2, int(hot_threshold))
    lo = lo if lo is not None else max(1, hi // 2)
    return HysteresisPolicy(monitor=monitor, lo=lo, hi=hi,
                            n_regions=n_regions,
                            max_unload_size=max_unload_size)


register_policy("always-offload", _mk_always_offload)
register_policy("always-unload", _mk_always_unload)
register_policy("hint", _mk_hint)
register_policy("frequency", _mk_frequency)
register_policy("hysteresis", _mk_hysteresis)


def top_k_hot_table(counts: torch.Tensor, k: int) -> torch.Tensor:
    """bool[n_regions] table marking the top-k regions by count: the paper's
    evaluation policy ("offloads only the top-4096 heavy-hitter memory
    regions") built from observed or oracle frequencies. Ties go to the
    lower index, as ``jax.lax.top_k`` breaks them (``torch.topk`` makes no
    such promise): the first k of a stable descending sort."""
    n = counts.shape[0]
    k = min(int(k), n)
    hot = torch.zeros((n,), dtype=torch.bool, device=counts.device)
    if k > 0:
        order = torch.sort(counts, descending=True, stable=True).indices
        hot[order[:k]] = True
    return hot
