"""Port of repro/core/ring.py.

The staging-ring machinery every unload path shares: ``RingState`` (a
``live`` occupancy mask plus the ``head`` append cursor) and its two
accounting modes (wrap, for the flat ``RemoteWriteEngine``: slots are reused
after a drain and occupancy is counted from ``live``; dense, for the KV
overlay: entries fill 0..head and the ring rewinds on drain), slot
assignment and recording, ``push_column`` at a device-side cursor,
shadowing, lane merging, conflict detection, uMTT-validated drain
eligibility (``drain_mask``) and the drain copies: ``scatter_rows`` and
``scatter_rows_layers`` (one plane, and a table of planes in one launch),
the dispatch points of the ``staged_scatter`` kernel, and
``scatter_elems``, the partial-row scatter that the flat ring's drain and
the offload path's direct write share.

PyTorch idiom: buffers are updated IN PLACE where the JAX package returned a
new array (saves a copy of the buffer every step); each function says so and
returns the buffer it mutated.

Drop sentinels: JAX scatters with ``mode="drop"`` and an out-of-range index
for a lane that must not land; torch's ``index_put_`` has no drop mode.
Boolean indexing would read a count back to the host, clamping a dropped
lane onto a live index can collide with a real write, and the flat engine's
memory belongs to the caller, so it cannot grow a sink row. :func:`put_`
therefore redirects every dropped lane onto the first kept lane, with that
lane's value: it repeats a write that lands anyway, and duplicates that
carry one value give one result in any order. With no kept lane at all, each
dropped lane writes ``buf[0]`` back to itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import staged_scatter, staged_scatter_planes
from . import umtt as U
from .types import resolve_device


class RingState(NamedTuple):
    """live: bool[..., cap], slot holds an undrained entry (ring axis last).
    head: int scalar tensor, next append position."""

    live: torch.Tensor
    head: torch.Tensor


def make(capacity: int, device="cuda") -> RingState:
    """An empty wrap-mode ring (the flat engine's)."""
    dev = resolve_device(device)
    return RingState(
        live=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        head=torch.zeros((), dtype=torch.int64, device=dev))


def capacity(state: RingState) -> int:
    return state.live.shape[-1]


def put_(buf: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
         keep: torch.Tensor) -> torch.Tensor:
    """``buf[idx[i]] = values[i]`` where ``keep[i]``, along ``buf``'s first
    axis, IN PLACE (returns ``buf``), with no read on the host: JAX's
    ``.at[idx].set(values, mode="drop")`` with an out-of-range ``idx`` on
    the dropped lanes. Kept indices must be in range; dropped ones may be
    anything. A dropped lane repeats the first kept lane's write (see the
    module's note)."""
    n = idx.shape[0]
    if n == 0:
        return buf
    values = values.to(buf.dtype)
    # the first kept lane (lane 0 if none), taken with index_select: a 0-dim
    # tensor used as an index would be read on the host
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)
    some = keep.index_select(0, first)
    trail = (1,) * (values.dim() - 1)
    sub_idx = torch.where(some, idx.index_select(0, first), 0)
    sub_val = torch.where(some.reshape((1,) + trail),
                          values.index_select(0, first), buf[:1])
    lane = keep.reshape((n,) + trail)
    buf.index_put_((torch.where(keep, idx, sub_idx),),
                   torch.where(lane, values, sub_val))
    return buf


def dense_state(meta: torch.Tensor, fill: torch.Tensor) -> RingState:
    """Dense-mode bookkeeping view from a metadata plane: ``meta`` [lanes,
    cap] per-entry destination keys (-1 = lane not staged at that column),
    ``fill`` the scalar append cursor. Occupancy rule: columns [0, fill)
    where a destination was recorded."""
    cap = meta.shape[1]
    filled = torch.arange(cap, device=meta.device)[None, :] < fill
    return RingState(live=filled & (meta >= 0), head=fill)


def free_slots(state: RingState) -> torch.Tensor:
    """Wrap mode: slots holding no live entry (reusable after a drain)."""
    return capacity(state) - state.live.sum()


def need_drain(state: RingState, incoming) -> torch.Tensor:
    """Wrap mode: True (a device scalar) if appending ``incoming`` more
    entries could overwrite live data."""
    return free_slots(state) < incoming


def free_ahead(state: RingState) -> torch.Tensor:
    """Dense mode: columns ahead of the cursor (ring resets on drain)."""
    return capacity(state) - state.head


def full(state: RingState) -> torch.Tensor:
    """Dense mode: appending one more entry would overwrite live data."""
    return free_ahead(state) < 1


def assign_slots(state: RingState, mask: torch.Tensor) -> torch.Tensor:
    """Slots of a masked batched append, wrap mode: slot = (head + rank
    among the staged) % capacity. Staging writes are contiguous. Lanes not
    staged get the out-of-range sentinel ``capacity`` (never -1)."""
    cap = capacity(state)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    return torch.where(mask, (state.head + rank) % cap, cap)


def append(state: RingState, mask: torch.Tensor
           ) -> Tuple[RingState, torch.Tensor]:
    """Wrap mode: assign slots to the masked entries, mark them live IN
    PLACE and advance the cursor. Returns (state, slots[n] with sentinel =
    capacity)."""
    slots = assign_slots(state, mask)
    put_(state.live, slots, torch.ones_like(mask), mask)
    head = (state.head + mask.to(torch.int64).sum()) % capacity(state)
    return RingState(state.live, head), slots


def record(arrays, slots: torch.Tensor, values) -> tuple:
    """Scatter per-entry metadata / payload ``values`` (a tuple of [n, ...])
    into the ring-axis-LEADING ``arrays`` ([cap, ...]) at ``slots``, IN
    PLACE; the sentinel ``capacity`` drops."""
    keep = slots < arrays[0].shape[0]
    for buf, v in zip(arrays, values):
        put_(buf, slots, v, keep)
    return tuple(arrays)


def reset(state: RingState, gate: Optional[torch.Tensor] = None
          ) -> RingState:
    """Wrap mode: empty the ring after a drain, IN PLACE on ``live``; the
    cursor stays (slots are reused in place). ``gate`` (a device bool
    scalar) empties it only where True, with no read on the host."""
    if gate is None:
        state.live.zero_()
    else:
        state.live.masked_fill_(gate, False)
    return state


def push_column(buf: torch.Tensor, head: torch.Tensor, column: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Write one entry ``column`` at ring position ``head`` of ``buf``, IN
    PLACE (returns ``buf``). ``head`` is a device scalar: the write is an
    ``index_copy_`` along the ring axis, so the host never reads the
    cursor. ``column`` is ``buf`` without that axis. A head past the last
    position writes the last one, as the JAX package's
    ``lax.dynamic_update_slice`` clamps its start (a chunk step that stages
    nothing, the speculative verify, advances the cursor without a drain)."""
    axis = axis % buf.dim()
    at = head.reshape(1).long().clamp(max=buf.shape[axis] - 1)
    return buf.index_copy_(axis, at, column.unsqueeze(axis).to(buf.dtype))


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


def drain_mask(
    state: RingState,
    table: U.UMTT,
    region: torch.Tensor,
    stag: torch.Tensor,
    *,
    need_perm: int = U.PERM_WRITE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-entry drain eligibility: live AND passing the uMTT's security
    check. Returns (ok mask, n_rejected). The ONE place staged entries meet
    the uMTT. (The paged KV overlay's destinations are engine-computed and
    its drain takes every live entry.)"""
    ok = U.validate(table, region, stag, need_perm=need_perm) & state.live
    return ok, (state.live & ~ok).sum()


def scatter_rows(
    dest: torch.Tensor,     # [R, W]
    staging: torch.Tensor,  # [N, W]
    rows: torch.Tensor,     # int[N]
    ok: torch.Tensor,       # bool[N]
) -> torch.Tensor:
    """Full-row drain: staged row i -> dest[rows[i]] where ok[i], IN PLACE.
    A dispatch point of the ``staged_scatter`` kernel (a CUDA tensor
    launches it, a CPU tensor takes its plain version).
    PRECONDITION: valid rows are unique within one drain."""
    return staged_scatter(dest, staging, rows, ok)


def scatter_rows_layers(planes, rows, ok) -> None:
    """:func:`scatter_rows` for every layer of a list of ``(dest [L, R, W],
    staging [L, N, W])`` planes on one device, in one launch, IN PLACE: the
    K and V planes of a pool and every shard of them there share the row
    list ``rows`` / ``ok`` [N]."""
    staged_scatter_planes(planes, rows, ok)


def scatter_elems(
    mem: torch.Tensor,      # [n_regions, region_width]
    payload: torch.Tensor,  # [N, width]
    region: torch.Tensor,   # int[N]
    offset: torch.Tensor,   # int[N]
    size: torch.Tensor,     # int[N]
    ok: torch.Tensor,       # bool[N]
) -> torch.Tensor:
    """Partial-row scatter, IN PLACE on ``mem`` (returned):
    ``payload[i, :size[i]] -> mem[region[i], offset[i]:offset[i]+size[i]]``
    where ``ok[i]``. Used by BOTH the flat ring's drain and the offload
    path's direct write, so the two paths land through one primitive.
    Elements whose flat index falls outside ``mem`` are dropped, as JAX's
    sentinel ``mem.size`` drops them."""
    width = payload.shape[1]
    lane = torch.arange(width, device=mem.device)[None, :]
    flat = (region.to(torch.int64)[:, None] * mem.shape[1]
            + offset[:, None] + lane)
    elem = (ok[:, None] & (lane < size[:, None])
            & (flat >= 0) & (flat < mem.numel()))
    put_(mem.view(-1), flat.reshape(-1), payload.reshape(-1),
         elem.reshape(-1))
    return mem
