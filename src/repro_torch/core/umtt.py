"""Port of repro/core/umtt.py: uRDMA's software memory-registration map
(paper section 3.1).

The address, size, stag and permission of each memory-region registration
are kept in a fixed-capacity structure of arrays, so the security check of a
batch of unloaded writes is one vectorized lookup: a write passes if some
live registration covers its region, carries its stag and grants the
permission. Registration and deregistration are host-side (setup-time)
operations and return a new table, as in the JAX package; ``validate`` runs
on the table's device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .types import resolve_device

PERM_READ = 1
PERM_WRITE = 2


class UMTT(NamedTuple):
    """Registration table. Rows with ``valid`` False are free slots."""

    base: torch.Tensor   # int64[cap], first region id of the registration
    limit: torch.Tensor  # int64[cap], one past the last region id
    stag: torch.Tensor   # int64[cap], steering tag handed to initiators
    perm: torch.Tensor   # int64[cap], PERM_* bitmask
    valid: torch.Tensor  # bool[cap]


def make_umtt(capacity: int = 4096, device="cuda") -> UMTT:
    dev = resolve_device(device)

    def z():
        return torch.zeros((capacity,), dtype=torch.int64, device=dev)

    return UMTT(z(), z(), z(), z(),
                torch.zeros((capacity,), dtype=torch.bool, device=dev))


def register(table: UMTT, base: int, n_regions: int, stag: int,
             perm: int = PERM_WRITE) -> UMTT:
    """Register ``[base, base + n_regions)`` under ``stag`` in the first free
    slot. Host-side (setup). On a full table nothing new is written (the
    first slot keeps its registration), as in the JAX package."""
    free = int(torch.argmin(table.valid.to(torch.uint8)))  # first free slot
    if bool(table.valid[free]):
        return table
    new = UMTT(*(t.clone() for t in table))
    new.base[free], new.limit[free] = base, base + n_regions
    new.stag[free], new.perm[free] = stag, perm
    new.valid[free] = True
    return new


def deregister(table: UMTT, stag: int) -> UMTT:
    """Remove all registrations carrying ``stag`` (paper: removed at
    deregistration)."""
    return table._replace(valid=table.valid & (table.stag != stag))


def validate(table: UMTT, region: torch.Tensor, stag: torch.Tensor,
             need_perm: int = PERM_WRITE) -> torch.Tensor:
    """bool[n]: the batched security check of unloaded writes. True where
    some live registration covers ``region``, carries ``stag`` and grants
    ``need_perm`` (the paper's replacement for the RNIC's MTT check)."""
    r = region[:, None]
    ok = (table.valid[None, :]
          & (r >= table.base[None, :])
          & (r < table.limit[None, :])
          & (stag[:, None] == table.stag[None, :])
          & ((table.perm[None, :] & need_perm) == need_perm))
    return ok.any(dim=1)


def occupancy(table: UMTT) -> Tuple[torch.Tensor, int]:
    return table.valid.sum(), table.valid.shape[0]
