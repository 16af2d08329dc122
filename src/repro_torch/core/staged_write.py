"""Port of repro/core/staged_write.py: ``RemoteWriteEngine``, the paper's
bidirectional offload as one API (section 3).

``engine.write(state, mem, batch, payload, stag)`` is path-agnostic for
callers ("unload through the offload interface"): the decision module routes
each request, the OFFLOAD path scatters straight to (region, offset), the
UNLOAD path appends to the staging ring and a later drain validates each
entry against the uMTT and copies it to its destination. Callers never see
which path a write took. Memory is ``[n_regions, region_width]``; a write is
(region, offset, size <= width, stag, payload[width]).

PyTorch idiom: ``mem`` and the ring's buffers are updated IN PLACE and
returned, with a new ``EngineState`` around the same tensors. Where the JAX
engine branches on the drain with ``lax.cond``, this one launches the drain
on every batch with its eligibility ANDed with the device-side condition
(``unload.drain(gate=...)``): the same result, and nothing is read back to
the host. State is made on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from . import ring as R
from . import umtt as U
from . import unload as UL
from .decision import DecisionModule
from .monitor import MonitorState
from .types import WriteBatch, resolve_device


class EngineState(NamedTuple):
    ring: UL.StagingRing
    table: U.UMTT
    monitor: Optional[MonitorState]  # the decision module's routing state
    n_offloaded: torch.Tensor  # int64 running totals (telemetry)
    n_unloaded: torch.Tensor
    n_rejected: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RemoteWriteEngine:
    decision: DecisionModule
    ring_capacity: int = 1024
    width: int = 16  # payload elements per write
    dtype: torch.dtype = torch.float32

    # -- lifecycle ---------------------------------------------------------
    def init_state(self, table: U.UMTT, device="cuda") -> EngineState:
        dev = resolve_device(device)

        def zero():
            return torch.zeros((), dtype=torch.int64, device=dev)

        return EngineState(
            ring=UL.make_ring(self.ring_capacity, self.width, self.dtype,
                              device=dev),
            table=table, monitor=self.decision.init_state(dev),
            n_offloaded=zero(), n_unloaded=zero(), n_rejected=zero())

    # -- offload path --------------------------------------------------------
    @staticmethod
    def write_direct(mem: torch.Tensor, batch: WriteBatch,
                     payload: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Direct scatter to (region, offset), IN PLACE; ``mask`` selects the
        participating rows. The unload path drains through the same
        ``ring.scatter_elems``, so the two paths land alike by construction."""
        ok = (torch.ones((batch.n,), dtype=torch.bool, device=mem.device)
              if mask is None else mask)
        return R.scatter_elems(mem, payload, batch.region, batch.offset,
                               batch.size, ok)

    # -- ordering parity (beyond the paper; DESIGN.md) -----------------------
    @staticmethod
    def _last_wins(batch: WriteBatch) -> torch.Tensor:
        """bool[n]: False where a LATER write in the same batch hits the same
        (region, offset): the last write to a destination wins on either
        path. An ``[n, n]`` compare, as in the JAX package."""
        same = ((batch.region[:, None] == batch.region[None, :])
                & (batch.offset[:, None] == batch.offset[None, :]))
        idx = torch.arange(batch.n, device=batch.region.device)
        return ~(same & (idx[None, :] > idx[:, None])).any(dim=1)

    @staticmethod
    def _conflicts_ring(ring: UL.StagingRing,
                        batch: WriteBatch) -> torch.Tensor:
        """True if an incoming write targets a destination with a pending
        staged entry: a drain is forced first, so program order per
        destination holds across batches."""
        return UL.conflicts(ring, batch.region, batch.offset)

    # -- combined write --------------------------------------------------------
    def write(self, state: EngineState, mem: torch.Tensor, batch: WriteBatch,
              payload: torch.Tensor, stag: torch.Tensor
              ) -> Tuple[EngineState, torch.Tensor]:
        """Route a batch of writes. Returns (state, mem).

        Ordering parity: (a) within a batch the last write to a (region,
        offset) wins whatever its path; (b) across batches a drain is forced
        when an incoming write targets a pending staged entry, and before
        the ring could overflow (``need_drain`` counts all ``batch.n``
        incoming writes). The telemetry counts ``unload_mask`` before the
        last-wins suppression, as the JAX engine does."""
        unload_mask, mon, _ = self.decision(state.monitor, batch)
        keep = self._last_wins(batch)
        must_drain = (UL.need_drain(state.ring, batch.n)
                      | self._conflicts_ring(state.ring, batch))
        ring, mem, rejected = UL.drain(state.ring, mem, state.table,
                                       gate=must_drain)
        # 1) offload subset: direct scatter now
        self.write_direct(mem, batch, payload, ~unload_mask & keep)
        # 2) unload subset: sequential append into the staging ring
        ring, _ = UL.append(ring, payload, batch.region, batch.offset,
                            batch.size, stag, unload_mask & keep)
        n_u = unload_mask.to(torch.int64).sum()
        return EngineState(
            ring=ring, table=state.table, monitor=mon,
            n_offloaded=state.n_offloaded + batch.n - n_u,
            n_unloaded=state.n_unloaded + n_u,
            n_rejected=state.n_rejected + rejected,
        ), mem

    def flush(self, state: EngineState, mem: torch.Tensor
              ) -> Tuple[EngineState, torch.Tensor]:
        """Drain all staged entries (end of step / completion poll)."""
        ring, mem, rejected = UL.drain(state.ring, mem, state.table)
        return state._replace(ring=ring,
                              n_rejected=state.n_rejected + rejected), mem
