"""Port of repro/core/unload.py: the unload module (paper section 3.1), the
FLAT staging ring and its drain, built on ``core.ring``.

The unload path replaces a write to an arbitrary destination region with

  1. an append into the next slots of a small, reused staging ring
     (initiator side: slot allocation and the metadata of each entry), and
  2. a target-side drain that validates each staged entry against the uMTT
     (address, stag, permission: security parity) and copies its payload to
     its true destination (functional parity).

Entries carry (region, offset, size, stag) beside the payload. Cursor and
wrap accounting, conflict detection, drain eligibility and the scatter come
from ``core.ring``; this module binds them to the flat (region, offset)
address space. Buffers are updated IN PLACE and returned.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import ring as R
from . import umtt as U
from .types import resolve_device


class StagingRing(NamedTuple):
    """Target-side staging buffer (one per queue pair in the paper): payload
    and destination metadata per entry (ring axis leading), occupancy and
    the append cursor in ``state``."""

    payload: torch.Tensor  # [cap, width] staged payloads
    region: torch.Tensor   # int64[cap] destination region id
    offset: torch.Tensor   # int64[cap] element offset within the region
    size: torch.Tensor     # int64[cap] valid payload elements
    stag: torch.Tensor     # int64[cap] steering tag for the uMTT check
    state: R.RingState

    @property
    def live(self) -> torch.Tensor:
        return self.state.live

    @property
    def head(self) -> torch.Tensor:
        return self.state.head


def make_ring(capacity: int, width: int, dtype=torch.float32,
              device="cuda") -> StagingRing:
    dev = resolve_device(device)

    def meta():
        return torch.zeros((capacity,), dtype=torch.int64, device=dev)

    return StagingRing(
        payload=torch.zeros((capacity, width), dtype=dtype, device=dev),
        region=meta(), offset=meta(), size=meta(), stag=meta(),
        state=R.make(capacity, device=dev))


def append(ring: StagingRing, payload: torch.Tensor, region: torch.Tensor,
           offset: torch.Tensor, size: torch.Tensor, stag: torch.Tensor,
           mask: torch.Tensor) -> Tuple[StagingRing, torch.Tensor]:
    """Sequential append of the masked entries at the ring head, IN PLACE.
    Returns (ring, slots[n] with sentinel = capacity). Callers drain before
    overflow (:func:`need_drain`)."""
    state, slot = R.append(ring.state, mask)
    R.record((ring.payload, ring.region, ring.offset, ring.size, ring.stag),
             slot, (payload, region, offset, size, stag))
    return ring._replace(state=state), slot


def need_drain(ring: StagingRing, incoming: int) -> torch.Tensor:
    """True (a device scalar) if appending ``incoming`` more entries could
    overwrite live data."""
    return R.need_drain(ring.state, incoming)


def conflicts(ring: StagingRing, region: torch.Tensor,
              offset: torch.Tensor) -> torch.Tensor:
    """True (a device scalar) if any incoming (region, offset) has a pending
    staged entry: the caller drains first (ordering parity)."""
    return R.conflicts(ring.state, (ring.region, ring.offset),
                       (region, offset))


def drain(ring: StagingRing, mem: torch.Tensor, table: U.UMTT,
          gate: Optional[torch.Tensor] = None
          ) -> Tuple[StagingRing, torch.Tensor, torch.Tensor]:
    """Target-CPU drain: validate each live entry against the uMTT, copy the
    payloads that pass to their destinations IN PLACE on ``mem``, and empty
    the ring (wrap mode: the cursor stays). Returns (ring, mem, n_rejected).

    ``gate`` (a device bool scalar) makes the drain conditional without a
    read on the host, where the JAX engine branches with ``lax.cond``: every
    eligible entry is ANDed with it, and so are the rejects and the reset."""
    ok, n_rejected = R.drain_mask(ring.state, table, ring.region, ring.stag)
    if gate is not None:
        ok = ok & gate
        n_rejected = n_rejected * gate
    R.scatter_elems(mem, ring.payload, ring.region, ring.offset, ring.size,
                    ok)
    return ring._replace(state=R.reset(ring.state, gate=gate)), mem, n_rejected
