"""Port of repro/core/policy.py (the serving path's share).

Unload policies: a policy maps a batch of write requests + monitor state to
a per-request routing decision, OFFLOAD (keep on the direct path) or UNLOAD
(reroute via the staging ring). Ported: ``AlwaysOffload``, ``AlwaysUnload``
and ``FrequencyPolicy``, the default policies of the three registered write
paths, and the registry. ``HintPolicy`` and ``HysteresisPolicy`` are not
ported yet; asking the registry for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .monitor import ExactMonitor, MonitorState
from .types import WriteBatch

OFFLOADS = frozenset({"offload"})
UNLOADS = frozenset({"unload"})
BOTH_PATHS = OFFLOADS | UNLOADS


class _DecideRoute:
    """RoutingPolicy adapter for decide-style policies: the routing state is
    the (optional) monitor counters; ``route`` = update + decide."""

    owns_state = False

    def init_state(self, device="cpu"):
        mon = getattr(self, "monitor", None)
        if self.needs_monitor and mon is not None:
            return mon.init(device)
        return None

    def route(self, state, batch: WriteBatch,
              mask: Optional[torch.Tensor] = None):
        mon = getattr(self, "monitor", None)
        if self.needs_monitor and mon is not None:
            state = mon.update(state, batch.region, mask=mask)
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
class FrequencyPolicy(_DecideRoute):
    """Unload small writes to regions colder than a frequency threshold.
    ``threshold`` is an absolute count; ``rel`` alternatively expresses it
    relative to the uniform expectation (count < rel * total / n_regions)."""

    monitor: ExactMonitor = dataclasses.field(
        default_factory=lambda: ExactMonitor(1 << 20))
    threshold: Optional[int] = None
    rel: Optional[float] = None
    n_regions: Optional[int] = None
    max_unload_size: int = 4096
    needs_monitor: bool = True
    emits = BOTH_PATHS

    def decide(self, state: MonitorState, batch: WriteBatch) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# Registry: RoutingPolicy factories by name
# ---------------------------------------------------------------------------

_POLICIES: Dict[str, Callable] = {}
_NOT_PORTED = ("hint", "hysteresis")


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
    if name in _POLICIES:
        return _POLICIES[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"not ported yet: policy {name!r}")
    raise ValueError(
        f"unknown policy {name!r}; registered policies: {sorted(_POLICIES)}")


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


def _mk_always_offload(monitor=None, n_regions=None, hot_threshold=None):
    return AlwaysOffload()


def _mk_always_unload(monitor=None, n_regions=None, hot_threshold=None):
    return AlwaysUnload()


def _mk_frequency(monitor=None, n_regions=None, hot_threshold=4,
                  max_unload_size=4096):
    monitor = monitor or ExactMonitor(n_regions=n_regions or (1 << 20))
    return FrequencyPolicy(monitor=monitor, threshold=hot_threshold,
                           max_unload_size=max_unload_size)


register_policy("always-offload", _mk_always_offload)
register_policy("always-unload", _mk_always_unload)
register_policy("frequency", _mk_frequency)
