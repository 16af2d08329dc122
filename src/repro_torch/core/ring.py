"""Port of repro/core/ring.py (the serving path's share).

The staging-ring bookkeeping every unload path shares: ``RingState`` (a
``live`` occupancy mask plus the ``head`` append cursor), dense-mode
accounting, ``push_column`` at a device-side cursor, shadowing, lane
merging, conflict detection and the drain copy ``scatter_rows``, the single
dispatch point of the ``staged_scatter`` kernel. Wrap-mode accounting
(``assign_slots``/``append``/``record``), ``drain_mask`` with the uMTT and
``scatter_elems`` serve the flat ``RemoteWriteEngine`` and are not ported
yet.

PyTorch idiom: buffers are updated IN PLACE where the JAX package returned a
new array (saves a copy of the buffer every step); each function says so and
returns the buffer it mutated.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import staged_scatter, staged_scatter_layers


class RingState(NamedTuple):
    """live: bool[..., cap], slot holds an undrained entry (ring axis last).
    head: int scalar tensor, next append position."""

    live: torch.Tensor
    head: torch.Tensor


def capacity(state: RingState) -> int:
    return state.live.shape[-1]


def dense_state(meta: torch.Tensor, fill: torch.Tensor) -> RingState:
    """Dense-mode bookkeeping view from a metadata plane: ``meta`` [lanes,
    cap] per-entry destination keys (-1 = lane not staged at that column),
    ``fill`` the scalar append cursor. Occupancy rule: columns [0, fill)
    where a destination was recorded."""
    cap = meta.shape[1]
    filled = torch.arange(cap, device=meta.device)[None, :] < fill
    return RingState(live=filled & (meta >= 0), head=fill)


def free_ahead(state: RingState) -> torch.Tensor:
    """Dense mode: columns ahead of the cursor (ring resets on drain)."""
    return capacity(state) - state.head


def full(state: RingState) -> torch.Tensor:
    """Dense mode: appending one more entry would overwrite live data."""
    return free_ahead(state) < 1


def push_column(buf: torch.Tensor, head: torch.Tensor, column: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Write one entry ``column`` at ring position ``head`` of ``buf``, IN
    PLACE (returns ``buf``). ``head`` is a device scalar: the write is an
    ``index_copy_`` along the ring axis, so the host never reads the
    cursor. ``column`` is ``buf`` without that axis."""
    axis = axis % buf.dim()
    return buf.index_copy_(axis, head.reshape(1).long(),
                           column.unsqueeze(axis).to(buf.dtype))


def shadow_mask(
    live: torch.Tensor,        # bool [lanes, cap]
    rows: torch.Tensor,        # int [lanes, cap] per-entry destination rows
    width: int,                # destination row universe per lane
    extra_rows: Optional[torch.Tensor] = None,  # int [lanes], sentinel=width
) -> torch.Tensor:
    """bool [lanes, width]: destination rows whose AUTHORITATIVE value is a
    live staged entry; these are excluded from the destination-side validity
    mask. ``extra_rows`` adds one per-lane row (the entry being staged this
    step); the sentinel ``width`` means none."""
    lanes = live.shape[0]
    src = torch.where(live, rows.long(), width)
    out = torch.zeros((lanes, width + 1), dtype=torch.bool, device=live.device)
    out.scatter_(1, src, True)
    if extra_rows is not None:
        out.scatter_(1, extra_rows.long()[:, None], True)
    return out[:, :width]


def merge_lanes(state: RingState,
                rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a multi-lane ring into ONE entry list for a pooled drain
    (lane-major, matching ``payload.reshape(lanes * cap, ...)``)."""
    return rows.reshape(-1), state.live.reshape(-1)


def conflicts(
    state: RingState,
    stored_keys: Sequence[torch.Tensor],
    incoming_keys: Sequence[torch.Tensor],
) -> torch.Tensor:
    """True (a device scalar) if any incoming write targets a destination
    with a pending staged entry: the caller must drain first so cross-batch
    program order per destination is preserved. A conflict needs ALL key
    components equal on a live entry."""
    hit = state.live[..., None, :]  # [..., 1, cap]
    for stored, incoming in zip(stored_keys, incoming_keys):
        hit = hit & (incoming[..., :, None] == stored[..., None, :])
    return hit.any()


def scatter_rows(
    dest: torch.Tensor,     # [R, W]
    staging: torch.Tensor,  # [N, W]
    rows: torch.Tensor,     # int[N]
    ok: torch.Tensor,       # bool[N]
) -> torch.Tensor:
    """Full-row drain: staged row i -> dest[rows[i]] where ok[i], IN PLACE.
    The single dispatch point of the ``staged_scatter`` kernel (a CUDA
    tensor launches it, a CPU tensor takes its plain version).
    PRECONDITION: valid rows are unique within one drain."""
    return staged_scatter(dest, staging, rows, ok)


def scatter_rows_layers(dest, staging, rows, ok) -> torch.Tensor:
    """:func:`scatter_rows` for every layer of one plane in one launch:
    ``dest[L, R, W]``, ``staging[L, N, W]``, shared ``rows``/``ok`` [N]."""
    return staged_scatter_layers(dest, staging, rows, ok)
