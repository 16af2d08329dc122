"""Port of repro/core/decision.py (the serving path's share).

Decision module (paper section 3.2): intercept write requests, consult the
monitor + policy, and emit per-request offload/unload routing decisions. The
hot path is one counter update + one compare per request, vectorized over
the batch. ``expert_hot_mask`` applies the paper's policy to MoE expert ids.
``replicate_for_readback`` (mesh) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from .monitor import calibrate_threshold
from .policy import top_k_hot_table
from .types import PHASE_BULK, DecisionStats, WriteBatch, resolve_device


@dataclasses.dataclass(frozen=True)
class DecisionModule:
    """Routes write batches between the offload and unload paths.
    ``policy.decide`` consumes the (already-updated) monitor state: the
    paper's order, increment the page's counter, then compare. Where the
    policy queries the module's own monitor (``policy.monitor ==
    monitor``) the two are one ``monitor.observe`` and the policy decides
    on its estimates."""

    policy: object  # any RoutingPolicy (repro_torch.core.policy registry)
    monitor: Optional[object] = None  # ExactMonitor | CMSMonitor

    @classmethod
    def from_names(cls, policy: Optional[str] = None, path: str = "direct",
                   *, n_regions: int, hot_threshold: int = 4,
                   **policy_kw) -> "DecisionModule":
        """Registry-driven construction from ``(policy, path)`` names, with
        capability negotiation (``core.paths.build_decision``); the resolved
        write path is discarded."""
        from .paths import build_decision  # local: paths imports decision

        _, module = build_decision(path, policy, n_regions=n_regions,
                                   hot_threshold=hot_threshold, **policy_kw)
        return module

    def _policy_owns_state(self) -> bool:
        return getattr(self.policy, "owns_state",
                       not hasattr(self.policy, "decide"))

    def init_state(self, device="cuda"):
        """The routing state, on the card unless ``device="cpu"``."""
        device = resolve_device(device)
        if self._policy_owns_state():
            if self.monitor is not None:
                raise ValueError(
                    "stateful policies own their monitor: pass monitor=None "
                    "and configure the monitor on the policy itself")
            return self.policy.init_state(device)
        if self.monitor is not None:
            return self.monitor.init(device)
        if hasattr(self.policy, "init_state"):
            return self.policy.init_state(device)
        return None

    def __call__(
        self, state, batch: WriteBatch, active: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, object, DecisionStats]:
        """-> (unload_mask bool[n], new routing state, stats).

        ``active`` (bool[n], optional) marks live requests in a fixed-shape
        batch (the serve scheduler's slot array): inactive entries never
        update the monitor, never unload, and are excluded from the stats.
        PHASE_BULK entries are pinned to the offload path AFTER the policy
        runs; they still heat the monitor."""
        if self._policy_owns_state():
            unload, state = self.policy.route(state, batch, mask=active)
        elif self.monitor is not None:
            if getattr(self.policy, "monitor", None) == self.monitor:
                state, est = self.monitor.observe(state, batch.region,
                                                  mask=active)
                unload = self.policy.decide(state, batch, est=est)
            else:
                state = self.monitor.update(state, batch.region, mask=active)
                unload = self.policy.decide(state, batch)
            if active is not None:
                unload = unload & active
        elif hasattr(self.policy, "route"):
            unload, state = self.policy.route(state, batch, mask=active)
        else:
            unload = self.policy.decide(state, batch)
            if active is not None:
                unload = unload & active
        if batch.phase is not None:
            unload = unload & (batch.phase != PHASE_BULK)
        return unload, state, DecisionStats.from_mask(unload, active,
                                                      batch.phase)

    def heat(self, state, regions):
        """Off-critical-path monitor heating for bulk writes that bypass
        per-write routing (admission-time prefills): the frequency counters
        must still see every write that lands in a region."""
        if self.monitor is not None and not self._policy_owns_state():
            regions = torch.as_tensor(
                regions, device=state.counts.device).to(torch.int64)
            return self.monitor.update(state, regions)
        heat = getattr(self.policy, "heat", None)
        if heat is not None:
            return heat(state, regions)
        warnings.warn(
            f"{type(self.policy).__name__} owns its routing state but "
            f"implements no heat(state, regions): bulk prefill writes "
            f"will not warm its counters", stacklevel=2)
        return state


def page_threshold(counts: torch.Tensor, offload_top_k: int) -> torch.Tensor:
    """Count threshold putting about the top-k pages on the offload path."""
    return calibrate_threshold(counts, offload_top_k)


def expert_hot_mask(expert_load: torch.Tensor,
                    offload_top_k: int) -> torch.Tensor:
    """bool[E] hot-expert table from accumulated expert-load counters: the
    paper's hint/frequency policy applied to MoE expert ids. Hot
    (heavy-hitter) experts stay on the direct dispatch path, cold ones are
    staged (``models.moe.moe_ffn_layer(mode="adaptive")``). Called off the
    critical path, between steps."""
    return top_k_hot_table(expert_load, offload_top_k)
