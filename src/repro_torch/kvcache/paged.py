"""Port of repro/kvcache/paged.py (the blocking serving path's share).

Paged KV cache: a global pool of fixed-size blocks backing every decode-time
KV write of the continuous-batching serve scheduler.

* ``pages_k`` / ``pages_v``  [L, n_blocks + 1, page_size, H, Dh]: the
  physical pool, shared by every serving slot. The LAST block is a SINK:
  the JAX package drops a write whose row is the out-of-range sentinel
  ``pool_rows`` (``.at[].set(mode="drop")``); ``index_copy_`` has no drop
  mode, so the sentinel row exists and nothing ever reads it. Block ids
  handed out by :class:`BlockPool` never reach it.
* ``page_table``             int [n_slots, max_pages]: physical block
  backing each slot's logical page (-1 = unallocated).
* A slot's logical row ``r`` lives at physical pool row
  ``page_table[slot, r // page_size] * page_size + r % page_size``.

The WRITE side is where the paper lands. DIRECT (offload): scatter the tile
straight to its physical row. STAGED (unload): append to the per-slot ring
overlay (``ring_k`` / ``ring_v`` / ``ring_pos`` / ``ring_fill``); attention
reads pool-view U ring; drains bulk-copy the ring into the pool through
``core.ring.scatter_rows_layers`` (the ``staged_scatter`` kernel on the
GPU). Ring entries record LOGICAL rows, resolved through the page table at
drain time. The decision module's region for a write is its physical BLOCK.

PyTorch idiom: the pool, the ring planes and the ring metadata are updated
IN PLACE (a functional update would copy the whole pool every step); the
functions return the cache they mutated. No function here reads a device
value on the host, so a decode segment runs without a synchronisation.

Content hashes / refcount sharing / copy-on-write of ``BlockPool``, the host
tier (``unload_blocks``/``load_blocks``/``copy_block``), the chunk variants
(``logical_to_physical_many``, ``scatter_chunk``, ``overlay_chunk_parts``)
and the speculative snapshots are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import ring as R

PagedKV = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------


class BlockPool:
    """Free-list allocator over the physical block pool (host side).

    LIFO reuse: blocks are popped from the END of the free list (the most
    recently freed are handed out first), tracked per slot in ALLOCATION
    order; ``free_slot`` releases in reverse allocation order, so the stack
    is restored exactly. The order matters beyond locality: the decision
    module's region is the block id, so the write-path telemetry equals the
    JAX engine's only if both pools hand out the same blocks.
    ``owner[b]`` is the slot holding block ``b`` (-1 = free). Every mutation
    ends in a conservation audit."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.owner = np.full((n_blocks,), -1, np.int32)
        self.refcount = np.zeros((n_blocks,), np.int32)
        self._held: Dict[int, List[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def held(self, slot: int) -> Tuple[int, ...]:
        """``slot``'s blocks in allocation (= page) order."""
        return tuple(self._held.get(slot, ()))

    def audit(self) -> None:
        """Conservation check: every block is free or live, and refcounts
        sum to the held references."""
        live = int(np.count_nonzero(self.refcount > 0))
        if len(self._free) + live != self.n_blocks:
            raise RuntimeError(
                f"BlockPool conservation violated: {len(self._free)} free + "
                f"{live} live != {self.n_blocks}")
        refs = sum(len(v) for v in self._held.values())
        if refs != int(self.refcount.sum()):
            raise RuntimeError(
                f"BlockPool refcount drift: {refs} held references vs "
                f"refcount sum {int(self.refcount.sum())}")

    def alloc(self, slot: int, n: int) -> Optional[np.ndarray]:
        """Pop ``n`` fresh blocks for ``slot``; None (no partial alloc) if
        the free list can't cover the request."""
        if n == 0:
            return np.zeros((0,), np.int32)
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        blocks = np.asarray(taken, np.int32)
        self.owner[blocks] = slot
        self.refcount[blocks] = 1
        self._held.setdefault(slot, []).extend(taken)
        self.audit()
        return blocks

    def free_slot(self, slot: int) -> np.ndarray:
        """Drop all of ``slot``'s blocks, in REVERSE allocation order.
        Returns the blocks released."""
        blocks = list(self._held.get(slot, ()))
        for b in reversed(blocks):
            if self.refcount[b] <= 0:
                raise ValueError(f"block {b} is already free (double free)")
            self.refcount[b] -= 1
            self.owner[b] = -1
            self._free.append(b)
        self._held.pop(slot, None)
        self.audit()
        return np.asarray(blocks[::-1], np.int32)


# ---------------------------------------------------------------------------
# Device cache construction / addressing
# ---------------------------------------------------------------------------


def make_paged_kv(n_layers: int, n_blocks: int, page_size: int, n_slots: int,
                  max_pages: int, h: int, dh: int, dtype=torch.float32,
                  ring_size: int = 0, device="cpu") -> PagedKV:
    """Paged cache dict; ``ring_size > 0`` attaches the staging overlay. The
    pool planes hold ``n_blocks + 1`` blocks: the last one is the drop
    sink (see the module docstring)."""
    shape = (n_layers, n_blocks + 1, page_size, h, dh)
    cache = {
        "pages_k": torch.zeros(shape, dtype=dtype, device=device),
        "pages_v": torch.zeros(shape, dtype=dtype, device=device),
        "page_table": torch.full((n_slots, max_pages), -1, dtype=torch.int64,
                                 device=device),
    }
    if ring_size:
        cache["ring_k"] = torch.zeros((n_layers, n_slots, ring_size, h, dh),
                                      dtype=dtype, device=device)
        cache["ring_v"] = torch.zeros_like(cache["ring_k"])
        # staged entries record LOGICAL rows (-1 = empty); the page table
        # resolves them to physical pool rows at drain time
        cache["ring_pos"] = torch.full((n_slots, ring_size), -1,
                                       dtype=torch.int64, device=device)
        cache["ring_fill"] = torch.zeros((), dtype=torch.int64, device=device)
    return cache


def has_ring(cache: PagedKV) -> bool:
    return "ring_pos" in cache


def n_blocks(cache: PagedKV) -> int:
    """Allocatable blocks (the pool planes carry one sink block more)."""
    return cache["pages_k"].shape[1] - 1


def pool_rows(cache: PagedKV) -> int:
    """Total physical rows = the write sentinel (first row of the sink)."""
    return n_blocks(cache) * cache["pages_k"].shape[2]


def view_len(cache: PagedKV) -> int:
    """Logical rows per slot (max_pages * page_size)."""
    return cache["page_table"].shape[1] * cache["pages_k"].shape[2]


def logical_to_physical(cache: PagedKV, rows: torch.Tensor) -> torch.Tensor:
    """Per-slot logical row -> physical pool row. ``rows`` int [n_slots].
    Rows on unallocated pages (or negative sentinels) map to exactly
    ``pool_rows``, the sink, so a retired or empty slot can never write."""
    ps = cache["pages_k"].shape[2]
    rows = rows.long()
    safe = rows.clamp(0, view_len(cache) - 1)
    block = cache["page_table"].gather(1, (safe // ps)[:, None])[:, 0]
    phys = block * ps + safe % ps
    ok = (rows >= 0) & (rows < view_len(cache)) & (block >= 0)
    return torch.where(ok, phys, pool_rows(cache))


def view_rows(cache: PagedKV) -> torch.Tensor:
    """int [n_slots, V]: physical pool row backing every logical row
    (clamped to block 0 where unallocated; mask with the view mask)."""
    ps = cache["pages_k"].shape[2]
    table = cache["page_table"]
    base = table.clamp(min=0) * ps  # [n_slots, max_pages]
    rows = base[:, :, None] + torch.arange(ps, device=table.device)[None, None]
    return rows.reshape(table.shape[0], -1)


class StepPlan(NamedTuple):
    """Page-table-derived read-path products, hoisted ONCE per segment (the
    page table only changes host-side between segments)."""

    view_ids: torch.Tensor   # int64 [n_slots, V] physical row per logical row
    blocks: torch.Tensor     # int32 [n_slots, P] clamped physical block ids
    allocated: torch.Tensor  # bool [n_slots, V] page-allocated per logical row


def kernel_blocks(cache: PagedKV) -> torch.Tensor:
    """int32 [n_slots, max_pages]: the fused kernel's page table, physical
    block ids clamped to 0 where unallocated. Clamped entries walk block 0
    and read the SAME garbage ``gather_view`` gathers; the view mask hides
    it in both implementations."""
    return cache["page_table"].clamp(min=0).to(torch.int32)


def step_plan(cache: PagedKV) -> StepPlan:
    ps = cache["pages_k"].shape[2]
    return StepPlan(
        view_ids=view_rows(cache),
        blocks=kernel_blocks(cache),
        allocated=(cache["page_table"] >= 0).repeat_interleave(ps, dim=1),
    )


def view_mask_from(allocated: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """bool [n_slots, V]: logical rows holding live KV once row ``pos`` is
    written this step (rows 0..pos on allocated pages)."""
    logical = torch.arange(allocated.shape[1], device=allocated.device)[None]
    return (logical <= pos[:, None]) & allocated


def view_mask(cache: PagedKV, pos: torch.Tensor) -> torch.Tensor:
    return view_mask_from(step_plan(cache).allocated, pos)


def gather_view(pages_l: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One layer's per-slot contiguous KV view. pages_l [n_blocks(+1), ps,
    H, Dh], rows int [n_slots, V] -> [n_slots, V, H, Dh]."""
    flat = pages_l.reshape((-1,) + pages_l.shape[2:])
    return flat[rows]


def scatter_token(pages_l: torch.Tensor, dest: torch.Tensor,
                  tile: torch.Tensor) -> torch.Tensor:
    """Direct (offload-path) write of one decode step's tiles, IN PLACE.
    ``dest`` int [n_slots] physical rows; the sentinel ``pool_rows`` lands
    in the sink block. ``tile`` [n_slots, H, Dh]."""
    flat = pages_l.view((-1,) + pages_l.shape[2:])
    flat.index_copy_(0, dest.long(), tile.to(flat.dtype))
    return pages_l


# ---------------------------------------------------------------------------
# Staging-ring overlay (instantiation of core.ring, logical-row keys)
# ---------------------------------------------------------------------------


def ring_state(cache: PagedKV) -> R.RingState:
    return R.dense_state(cache["ring_pos"], cache["ring_fill"])


def ring_validity(cache: PagedKV) -> torch.Tensor:
    return ring_state(cache).live


def ring_full(cache: PagedKV) -> torch.Tensor:
    return R.full(ring_state(cache))


def ring_conflicts(cache: PagedKV, pos: torch.Tensor) -> torch.Tensor:
    """True if this step's logical destinations collide with pending staged
    entries of the same slot (drain first: keeps drain rows unique)."""
    return R.conflicts(ring_state(cache), (cache["ring_pos"],),
                       (pos[:, None],))


def stage_tile(plane: torch.Tensor, tile: torch.Tensor,
               cur: torch.Tensor) -> torch.Tensor:
    """Append one layer's tiles [n_slots, H, Dh] at ring column ``cur`` of
    ``plane`` [n_slots, R, H, Dh], IN PLACE."""
    return R.push_column(plane, cur, tile, axis=1)


def ring_commit(cache: PagedKV, pos: torch.Tensor,
                unload_mask: torch.Tensor) -> PagedKV:
    """Metadata half of the append: record logical rows (-1 where the slot
    wrote direct or is retired) at the cursor, advance it. IN PLACE."""
    cur = cache["ring_fill"]
    rows = torch.where(unload_mask, pos.long(), -1)
    R.push_column(cache["ring_pos"], cur, rows)
    cache["ring_fill"] = cur + 1
    return cache


def overlay_step_parts(
    cache: PagedKV,
    vmask: torch.Tensor,        # bool [n_slots, V] view validity after write
    pos: torch.Tensor,          # int [n_slots] this step's logical rows
    unload_mask: torch.Tensor,  # bool [n_slots] True = stage
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-step overlay bookkeeping, kept as SEPARATE sources. Returns
    (view_ok [n_slots, V] pool-view validity with staged rows shadowed out,
    ring_ok [n_slots, R] ring-lane validity including this step's append,
    cur, the ring column this step appends to)."""
    b, v = vmask.shape
    r = cache["ring_pos"].shape[1]
    cur = cache["ring_fill"]
    live = ring_validity(cache)
    ring_valid = live | (
        (torch.arange(r, device=vmask.device)[None, :] == cur)
        & unload_mask[:, None])
    shadowed = R.shadow_mask(
        live, cache["ring_pos"], v,
        extra_rows=torch.where(unload_mask, pos.long(), v))
    return vmask & ~shadowed, ring_valid, cur


def _drain(cache: PagedKV, gate: Optional[torch.Tensor]) -> PagedKV:
    """Copy live staged entries into the pool (only where ``gate``, a device
    bool scalar, holds; None = always) and empty the ring likewise."""
    l, b, r, h, dh = cache["ring_k"].shape
    n_phys = pool_rows(cache)
    ps = cache["pages_k"].shape[2]
    # resolve logical -> physical per ring entry, lanes flattened slot-major
    pos = cache["ring_pos"]
    safe = pos.clamp(0, view_len(cache) - 1)
    block = cache["page_table"].gather(1, safe // ps)
    phys = torch.where(
        (pos >= 0) & (pos < view_len(cache)) & (block >= 0),
        block * ps + safe % ps, n_phys)
    rows, ok = R.merge_lanes(ring_state(cache), phys)
    if gate is not None:
        ok = ok & gate
    for pk, rk in (("pages_k", "ring_k"), ("pages_v", "ring_v")):
        dest = cache[pk].view(l, -1, h * dh)[:, :n_phys]  # sink left out
        R.scatter_rows_layers(dest, cache[rk].view(l, b * r, h * dh),
                              rows, ok)
    if gate is None:
        cache["ring_pos"].fill_(-1)
        cache["ring_fill"] = torch.zeros_like(cache["ring_fill"])
    else:
        cache["ring_pos"] = torch.where(gate, -1, cache["ring_pos"])
        cache["ring_fill"] = torch.where(gate, 0, cache["ring_fill"])
    return cache


def drain_ring(cache: PagedKV) -> PagedKV:
    """Bulk-copy all staged entries into the pool, empty the ring. IN PLACE.

    ALL slots' entries flatten into ONE entry list (``core.ring.
    merge_lanes``) and each plane (K, V) lands with a single
    ``scatter_rows_layers`` call covering every layer: two kernel launches
    per drain. Block ownership makes destinations unique across slots,
    conflict-forced drains make them unique within a slot (the
    ``staged_scatter`` precondition)."""
    return _drain(cache, None)


def maybe_drain(cache: PagedKV,
                incoming_pos: Optional[torch.Tensor] = None,
                ) -> Tuple[PagedKV, torch.Tensor]:
    """Conditional drain without a host read: due when the ring is full OR
    the incoming logical rows conflict with pending entries. The drain is
    launched EVERY call with its validity mask gated by ``due`` (a row that
    is not valid costs the kernel a 5-byte read), and the ring is reset with
    ``torch.where(due, ...)``. Returns (cache, due: device bool scalar)."""
    due = ring_full(cache)
    if incoming_pos is not None:
        due = due | ring_conflicts(cache, incoming_pos)
    return _drain(cache, due), due
