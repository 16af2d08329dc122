"""Port of repro/kvcache/paged.py (the single-device serving path's share).

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
GPU, both planes in one launch). Ring entries record LOGICAL rows, resolved
through the page table at drain time. The decision module's region for a write is its physical BLOCK.

PyTorch idiom: the pool, the ring planes and the ring metadata are updated
IN PLACE (a functional update would copy the whole pool every step); the
functions return the cache they mutated. No function here reads a device
value on the host, so a decode segment runs without a synchronisation.

:class:`BlockPool` carries the prefix cache's refcounts, content hashes and
copy-on-write; ``unload_blocks`` / ``load_blocks`` / ``copy_block`` are the
host tier's and the CoW's block moves (pinned, stream-ordered copies on the
card). The chunk variants of the mixed-phase step
(``logical_to_physical_many``, ``scatter_chunk``, ``view_chunk_mask_from``,
``overlay_chunk_parts``) sit beside their one-token originals.
``snapshot_stack`` / ``select_snapshot`` are the recurrent (SSM) speculative
draft's rollback: one copy of its state a draft step, and a per-slot gather
at the committed count.

Under a mesh (``make_paged_kv(..., mesh=)``, DESIGN.md §9) the data planes
``pages_k`` / ``pages_v`` / ``ring_k`` / ``ring_v`` are
``distributed.ShardedTensor`` pieces ``[L, n_blocks + 1, ps, H / tp, Dh]``,
one per mesh device, each with its own sink block (whole copies where the
``model`` axis does not divide ``H``: ``serve_cache_shardings``); the page
table and the ring metadata stay whole on the lead device. Every write
(``scatter_token``, ``scatter_chunk``, ``stage_tile``, ``scatter_prefill``)
lands each shard's head slice on its device, every drain is one
``scatter_rows_layers`` call per device (every plane of every shard there)
from the lead's row list, and the host tier keeps the UNSHARDED layout:
the shards' slabs joined on the head axis in one pinned buffer, a restore
cutting it back. ``n_blocks`` / ``pool_rows`` / ``view_len`` read the
whole's shape.
"""
from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import ring as R
from ..core.types import resolve_device
from ..distributed.sharding import (ShardedTensor, pieces,
                                   serve_cache_shardings)

PagedKV = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------


class BlockPool:
    """Refcounted, content-hash-indexed allocator over the physical block
    pool (host side).

    Exclusive blocks keep the free-list discipline: LIFO reuse (blocks are
    popped from the END of the free list, the most recently freed first),
    tracked per slot in ALLOCATION order; ``free_slot`` releases in reverse
    allocation order, so the stack is restored exactly. The order matters
    beyond locality: the decision module's region is the block id, so the
    write-path telemetry equals the JAX engine's only if both pools hand out
    the same blocks. ``owner[b]`` is the slot that first acquired block
    ``b`` (-1 = free).

    Three lifecycle extensions back the prefix cache and the host tier:

    * **refcounts**: ``share`` adds a reference to an existing block instead
      of allocating; ``release_block`` / ``free_slot`` decrement, and a
      block leaves the live set only at refcount 0.
    * **content hashes**: ``register(slot, block, h)`` publishes a block
      under a chained page-content hash (first registrant wins); ``lookup``
      finds it at admission. A registered block whose refcount drops to 0
      goes to an LRU *evictable* list instead of the free list: it stays
      addressable by hash until ``alloc`` reclaims it (eviction
      de-registers).
    * **copy-on-write**: ``cow(slot, block)`` swaps a shared or registered
      block for a fresh private one at the same page index, so a slot about
      to write never mutates a block other holders can see.

    Every mutation ends in a conservation audit: free + live + evictable
    must equal ``n_blocks`` and refcounts must sum to the held references.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.owner = np.full((n_blocks,), -1, np.int32)
        self.refcount = np.zeros((n_blocks,), np.int32)
        # slot -> blocks in allocation order (= the slot's page order)
        self._held: Dict[int, List[int]] = {}
        # content-hash index: hash -> block and its inverse
        self._hash_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        # refcount-0 blocks still holding registered content, LRU order
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_available(self) -> int:
        """Blocks an ``alloc`` can produce right now (free + evictable)."""
        return len(self._free) + len(self._evictable)

    def held(self, slot: int) -> Tuple[int, ...]:
        """``slot``'s blocks in allocation (= page) order."""
        return tuple(self._held.get(slot, ()))

    def is_registered(self, block: int) -> bool:
        return int(block) in self._block_hash

    def audit(self) -> None:
        """Conservation check: every block is exactly one of free / live
        (refcount > 0) / evictable, and refcounts sum to the held
        references."""
        live = int(np.count_nonzero(self.refcount > 0))
        if len(self._free) + live + len(self._evictable) != self.n_blocks:
            raise RuntimeError(
                f"BlockPool conservation violated: "
                f"{len(self._free)} free + {live} live + "
                f"{len(self._evictable)} evictable != {self.n_blocks}")
        refs = sum(len(v) for v in self._held.values())
        if refs != int(self.refcount.sum()):
            raise RuntimeError(
                f"BlockPool refcount drift: {refs} held references vs "
                f"refcount sum {int(self.refcount.sum())}")

    def _take(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks off the free list, evicting LRU cached blocks
        (de-registering their hashes) when the free list runs short."""
        if n > self.n_available:
            return None
        while len(self._free) < n:
            b, _ = self._evictable.popitem(last=False)  # LRU first
            h = self._block_hash.pop(b)
            del self._hash_block[h]
            self._free.append(b)
        return [self._free.pop() for _ in range(n)]

    def alloc(self, slot: int, n: int) -> Optional[np.ndarray]:
        """Pop ``n`` fresh (refcount-1, private) blocks for ``slot``; None
        (no partial alloc) if free + evictable can't cover the request.
        ``alloc(slot, 0)`` returns an empty block list and changes
        nothing."""
        if n == 0:
            return np.zeros((0,), np.int32)
        taken = self._take(n)
        if taken is None:
            return None
        blocks = np.asarray(taken, np.int32)
        self.owner[blocks] = slot
        self.refcount[blocks] = 1
        self._held.setdefault(slot, []).extend(taken)
        self.audit()
        return blocks

    def lookup(self, h: int) -> Optional[int]:
        """Block registered under content hash ``h`` (live or evictable),
        or None."""
        return self._hash_block.get(h)

    def share(self, slot: int, block: int) -> None:
        """Add ``slot``'s reference to an existing block (prefix-cache
        hit): refcount + 1, revived from the evictable list if parked
        there."""
        block = int(block)
        if self.refcount[block] == 0:
            if block not in self._evictable:
                raise ValueError(
                    f"block {block} is free — cannot share it")
            del self._evictable[block]
            self.owner[block] = slot
        self.refcount[block] += 1
        self._held.setdefault(slot, []).append(block)
        self.audit()

    def register(self, slot: int, block: int, h: int) -> bool:
        """Publish ``block`` under content hash ``h``. First registrant
        wins: returns False (no state change) when ``h`` is already
        registered or the block already carries a hash."""
        block = int(block)
        if h in self._hash_block or block in self._block_hash:
            return False
        held = self._held.get(slot)
        if not held or block not in held:
            raise ValueError(
                f"slot {slot} does not hold block {block} — refusing to "
                f"register it")
        self._hash_block[h] = block
        self._block_hash[block] = h
        return True

    def _deref(self, block: int) -> None:
        if self.refcount[block] <= 0:
            raise ValueError(
                f"block {block} is already free (double free)")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self.owner[block] = -1
            if block in self._block_hash:
                # registered content survives at refcount 0: evictable
                self._evictable[block] = None
            else:
                self._free.append(block)

    def release_block(self, slot: int, block: int) -> None:
        """Drop ``slot``'s reference to ``block``. Raises on freeing a block
        the slot does not hold (unowned or already free)."""
        block = int(block)
        held = self._held.get(slot)
        if not held or block not in held:
            raise ValueError(
                f"slot {slot} does not hold block {block} "
                f"(double free or unowned block)")
        held.remove(block)
        if not held:
            del self._held[slot]
        self._deref(block)
        self.audit()

    def cow(self, slot: int, block: int) -> Optional[int]:
        """Copy-on-write: swap ``block`` for a fresh private block at the
        SAME page index in ``slot``'s held list, dropping the shared
        reference. Returns the new block id (the caller copies the device
        content, :func:`copy_block`), or None when the pool can't supply
        one."""
        block = int(block)
        held = self._held.get(slot)
        if not held or block not in held:
            raise ValueError(
                f"slot {slot} does not hold block {block} — cannot CoW")
        taken = self._take(1)
        if taken is None:
            return None
        new_b = taken[0]
        held[held.index(block)] = new_b
        self.owner[new_b] = slot
        self.refcount[new_b] = 1
        self._deref(block)
        self.audit()
        return new_b

    def free_slot(self, slot: int) -> np.ndarray:
        """Drop all of ``slot``'s references, in REVERSE allocation order
        (the free-list stack is restored as if the slot's allocs were
        undone). Returns the blocks released."""
        blocks = list(self._held.get(slot, ()))
        for b in reversed(blocks):
            self._deref(b)
        self._held.pop(slot, None)
        self.audit()
        return np.asarray(blocks[::-1], np.int32)


def prefix_page_hashes(prompt, page_size: int) -> List[int]:
    """Chained content hash per FULL page-aligned prompt chunk.

    ``h_i = hash((h_{i-1}, page_size, tokens of page i))``: chaining makes a
    page hash identify the whole prefix through it, so two prompts share
    page ``i`` iff their first ``(i + 1) * page_size`` tokens agree. Only
    full pages hash (decode rows land in the partial trailing page). The
    tokens are hashed as Python ``int`` tuples, whatever ``prompt`` is (a
    tensor, a numpy array, a list), so the values equal the JAX package's:
    Python's hash of a tuple of ints is the same in every process."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    p = np.asarray(prompt).reshape(-1)
    out: List[int] = []
    h = 0
    for i in range(len(p) // page_size):
        chunk = tuple(int(t) for t in p[i * page_size:(i + 1) * page_size])
        h = hash((h, page_size, chunk))
        out.append(h)
    return out


# ---------------------------------------------------------------------------
# Device cache construction / addressing
# ---------------------------------------------------------------------------


def make_paged_kv(n_layers: int, n_blocks: int, page_size: int, n_slots: int,
                  max_pages: int, h: int, dh: int, dtype=torch.float32,
                  ring_size: int = 0, device="cuda", mesh=None) -> PagedKV:
    """Paged cache dict; ``ring_size > 0`` attaches the staging overlay. The
    pool planes hold ``n_blocks + 1`` blocks: the last one is the drop
    sink (see the module docstring). On the card unless ``device`` says
    otherwise (``device="cpu"`` runs on the CPU on purpose). Under ``mesh``
    the data planes are placed by ``serve_cache_shardings``, piece by piece
    on the mesh's devices (the whole plane never exists at once), and the
    decision plane stays on ``device``, the mesh's lead."""
    device = resolve_device(device)
    shape = (n_layers, n_blocks + 1, page_size, h, dh)
    rshape = (n_layers, n_slots, ring_size, h, dh)
    planes = {"pages_k": shape, "pages_v": shape}
    if ring_size:
        planes.update(ring_k=rshape, ring_v=rshape)
    placed = ({} if mesh is None
              else serve_cache_shardings(None, mesh, planes))

    def zeros(name):
        if mesh is None:
            return torch.zeros(planes[name], dtype=dtype, device=device)
        return ShardedTensor.zeros(planes[name], placed[name], dtype)
    cache = {
        "pages_k": zeros("pages_k"),
        "pages_v": zeros("pages_v"),
        "page_table": torch.full((n_slots, max_pages), -1, dtype=torch.int64,
                                 device=device),
    }
    if ring_size:
        cache["ring_k"], cache["ring_v"] = zeros("ring_k"), zeros("ring_v")
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


def logical_to_physical_many(cache: PagedKV,
                             rows: torch.Tensor) -> torch.Tensor:
    """Per-slot logical rows -> physical pool rows, ``rows`` int [n_slots,
    C]: column ``j`` of slot ``b`` resolves through slot ``b``'s page table.
    Invalid rows (negative sentinel, out of view, unallocated page) map to
    ``pool_rows``, the sink, as in :func:`logical_to_physical`."""
    ps = cache["pages_k"].shape[2]
    rows = rows.long()
    safe = rows.clamp(0, view_len(cache) - 1)
    block = cache["page_table"].gather(1, safe // ps)
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


def view_chunk_mask_from(allocated: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """bool [n_slots, C, V]: per-query view validity of a mixed-phase chunk
    step, query ``j`` of slot ``b`` at logical row ``positions[b, j]``. A
    view row is visible when its logical id is <= the query's position and
    its page is allocated; the chunk's own rows land in the pool before the
    read, so causality inside the chunk falls out of the same rule."""
    rows = torch.arange(allocated.shape[1], device=allocated.device)
    return (rows[None, None, :] <= positions[:, :, None]) \
        & allocated[:, None, :]


def whole(x):
    """A data plane (or one layer of it) as one tensor on the lead device:
    a placed tensor's head slices joined, a plain one as it is."""
    return x.gather() if isinstance(x, ShardedTensor) else x


def _parts(plane, x: torch.Tensor, head_axis: int = -2):
    """``(piece, x's head slice for it, on its device)`` for each piece of
    ``plane``: the one pair ``(plane, x)`` for a plain tensor, every piece
    of a placed one (a whole copy takes all of ``x``)."""
    if not isinstance(plane, ShardedTensor):
        return [(plane, x)]
    n = x.shape[head_axis]
    return [(piece, x.narrow(head_axis, sl.start, sl.stop - sl.start).to(d))
            for piece, (d, sl) in zip(plane.shards, plane.slices(n))]


def gather_view(pages_l, rows: torch.Tensor) -> torch.Tensor:
    """One layer's per-slot contiguous KV view. pages_l [n_blocks(+1), ps,
    H, Dh], rows int [n_slots, V] -> [n_slots, V, H, Dh]. A placed layer
    is gathered shard by shard and the heads joined on the lead device."""
    if isinstance(pages_l, ShardedTensor):
        lead = pages_l.mesh.lead
        views = [gather_view(p, rows.to(p.device)).to(lead)
                 for _, p in pages_l.read_group()]
        return views[0] if len(views) == 1 else torch.cat(views, dim=2)
    flat = pages_l.reshape((-1,) + pages_l.shape[2:])
    return flat[rows]


def scatter_token(pages_l, dest: torch.Tensor,
                  tile: torch.Tensor):
    """Direct (offload-path) write of one decode step's tiles, IN PLACE.
    ``dest`` int [n_slots] physical rows; the sentinel ``pool_rows`` lands
    in the sink block. ``tile`` [n_slots, H, Dh]; each shard of a placed
    layer takes its head slice."""
    for piece, part in _parts(pages_l, tile):
        flat = piece.view((-1,) + piece.shape[2:])
        flat.index_copy_(0, dest.to(piece.device).long(), part.to(flat.dtype))
    return pages_l


def scatter_chunk(pages_l, dest: torch.Tensor, tiles: torch.Tensor):
    """Direct (offload-path) bulk write of one mixed-phase step's tiles, IN
    PLACE: the chunk analogue of :func:`scatter_token`. ``dest`` int
    [n_slots, C] physical rows, the sentinel ``pool_rows`` landing in the
    sink block; ``tiles`` [n_slots, C, H, Dh]. Live destinations are unique
    across slots (block ownership) and within a chunk (consecutive rows);
    only sink rows repeat, and nothing reads the sink. Per shard as in
    :func:`scatter_token`."""
    for piece, part in _parts(pages_l, tiles):
        flat = piece.view((-1,) + piece.shape[2:])
        flat.index_copy_(0, dest.to(piece.device).reshape(-1).long(),
                         part.reshape((-1,) + part.shape[2:]).to(flat.dtype))
    return pages_l


def scatter_prefill(plane, rows: torch.Tensor, tiles: torch.Tensor):
    """Bulk write of whole prompts into every layer of one pool plane, IN
    PLACE (the admission-time prefill: the offload/direct path). ``plane``
    [L, n_blocks + 1, ps, H, Dh], ``rows`` int [N] physical rows,
    ``tiles`` [L, N, H, Dh]; each shard takes its head slice."""
    for piece, part in _parts(plane, tiles):
        l = piece.shape[0]
        flat = piece.view((l, -1) + piece.shape[3:])
        flat.index_copy_(1, rows.to(piece.device).long(), part.to(flat.dtype))
    return plane


# ---------------------------------------------------------------------------
# Host tier: device <-> host bulk block transfers
# ---------------------------------------------------------------------------


def _block_index(cache: PagedKV, blocks) -> torch.Tensor:
    return torch.as_tensor(np.asarray(blocks, np.int64),
                           device=cache["page_table"].device)


def unload_blocks(cache: PagedKV,
                  blocks) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk device -> host copy of whole blocks: the staging machinery's
    bulk-transfer lane run in REVERSE (the paper's unload move applied to
    capacity). Returns host ``(k, v)`` tensors ``[L, len(blocks), ps, H,
    Dh]`` that never alias the pool, so the caller may free and rewrite the
    blocks right after.

    On a CUDA pool each plane is gathered on the device and copied into a
    PINNED host buffer with ``non_blocking=True`` on the current stream;
    pinning that fails raises (no silent path through pageable memory).
    Stream order is enough to make the copy safe without a wait: the freed
    blocks are rewritten only by later work on the same stream, which the
    device -> host copy precedes, and the host buffers are read only by a
    later host -> device copy (:func:`load_blocks`) on that stream. On a CPU
    pool the gather itself is the copy (advanced indexing never returns a
    view). A placed pool keeps the UNSHARDED layout here: each shard's slab
    is gathered on its device and the slabs joined on the head axis on the
    lead device, before the one pinned copy."""
    bl = _block_index(cache, blocks)
    out = []
    for name in ("pages_k", "pages_v"):
        plane = cache[name]
        if isinstance(plane, ShardedTensor):
            lead = plane.mesh.lead
            slabs = [p[:, bl.to(p.device)].to(lead)
                     for _, p in plane.read_group()]
            src = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=3)
        else:
            src = plane[:, bl]
        if src.device.type != "cpu":
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            if not host.is_pinned():
                raise RuntimeError("host tier: pinned host memory was not "
                                   "granted")
            host.copy_(src, non_blocking=True)
            src = host
        out.append(src)
    return out[0], out[1]


def load_blocks(cache: PagedKV, blocks, host_k, host_v) -> PagedKV:
    """Bulk host -> device restore into freshly allocated blocks (the
    page-in half of the host tier), IN PLACE: each plane is copied to the
    device with ``non_blocking=True`` (stream-ordered after the unload that
    filled the buffer, see :func:`unload_blocks`) and written with one
    ``index_copy_``. ``host_k`` / ``host_v`` are tensors or numpy arrays
    ``[L, len(blocks), ps, H, Dh]``, the UNSHARDED layout: under a mesh the
    whole slab goes to the lead device and each shard takes its head slice
    from there."""
    bl = _block_index(cache, blocks)
    for name, host in (("pages_k", host_k), ("pages_v", host_v)):
        plane = cache[name]
        if not isinstance(host, torch.Tensor):
            host = torch.tensor(np.asarray(host))
        src = host.to(bl.device, plane.dtype, non_blocking=True)
        for piece, part in _parts(plane, src, head_axis=3):
            piece.index_copy_(1, bl.to(piece.device), part)
    return cache


def copy_block(cache: PagedKV, src: int, dst: int) -> PagedKV:
    """Device-side whole-block copy, IN PLACE (the CoW data move: duplicate
    a shared block's content into its private replacement), on every
    shard."""
    for name in ("pages_k", "pages_v"):
        for plane in pieces(cache[name]):
            plane[:, int(dst)].copy_(plane[:, int(src)])
    return cache


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


def stage_tile(plane, tile: torch.Tensor, cur: torch.Tensor):
    """Append one layer's tiles [n_slots, H, Dh] at ring column ``cur`` of
    ``plane`` [n_slots, R, H, Dh], IN PLACE; each shard of a placed plane
    takes its head slice."""
    for piece, part in _parts(plane, tile):
        R.push_column(piece, cur.to(piece.device), part, axis=1)
    return plane


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


def overlay_chunk_parts(
    cache: PagedKV,
    positions: torch.Tensor,     # int [n_slots, C] per-query logical rows
    unload_mask: torch.Tensor,   # bool [n_slots] True = column-0 write stages
    allocated: Optional[torch.Tensor] = None,  # hoisted StepPlan.allocated
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked analogue of :func:`overlay_step_parts`. Returns (view_ok
    [n_slots, C, V] with staged rows shadowed out, ring_ok [n_slots, R] per
    lane, not broadcast over C: a slot's pending entries always hold rows
    below its current position (conflict-forced drains), so ring validity
    needs no per-query causal term; and cur, the ring column this step
    appends to). Only the column-0 decode write may stage."""
    r = cache["ring_pos"].shape[1]
    cur = cache["ring_fill"]
    live = ring_validity(cache)
    ring_valid = live | (
        (torch.arange(r, device=positions.device)[None, :] == cur)
        & unload_mask[:, None])
    v = view_len(cache)
    shadowed = R.shadow_mask(
        live, cache["ring_pos"], v,
        extra_rows=torch.where(unload_mask, positions[:, 0].long(), v))
    if allocated is None:
        allocated = step_plan(cache).allocated
    vmask = view_chunk_mask_from(allocated, positions)
    return vmask & ~shadowed[:, None, :], ring_valid, cur


def _drain(cache: PagedKV, gate: Optional[torch.Tensor]) -> PagedKV:
    """Copy live staged entries into the pool (only where ``gate``, a device
    bool scalar, holds; None = always) and empty the ring likewise. The row
    list is the lead's; each shard drains its own head slice with it, all
    the planes of one device in one ``scatter_rows_layers`` call."""
    l, b, r, _, dh = cache["ring_k"].shape
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
    # one drain a device: the K and V planes of every shard there
    by_device: Dict[torch.device, list] = {}
    for pk, rk in (("pages_k", "ring_k"), ("pages_v", "ring_v")):
        for pool, stage in zip(pieces(cache[pk]), pieces(cache[rk])):
            w = pool.shape[3] * dh
            dest = pool.view(l, -1, w)[:, :n_phys]  # sink left out
            by_device.setdefault(pool.device, []).append(
                (dest, stage.view(l, b * r, w)))
    for dev, planes in by_device.items():
        R.scatter_rows_layers(planes, rows.to(dev), ok.to(dev))
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
    merge_lanes``) and both planes (K, V) land with a single
    ``scatter_rows_layers`` call covering every layer: one kernel launch
    per drain (per device under a mesh, every shard there in it). Block
    ownership makes destinations
    unique across slots, conflict-forced drains make them unique within a
    slot (the ``staged_scatter`` precondition)."""
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


# ---------------------------------------------------------------------------
# Speculative-decoding draft-cache rollback (DESIGN.md §11)
# ---------------------------------------------------------------------------


def snapshot(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of every leaf of a lanes cache: the port updates caches IN
    PLACE, so a snapshot the draft loop keeps must be a copy."""
    return {k: v.clone() for k, v in cache.items()}


def snapshot_stack(snaps: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """Stack draft-cache snapshots along a NEW leading snapshot axis.

    The spec segment's draft loop keeps one snapshot per draft step
    (``snaps[j]`` = the state after the draft consumed ``j`` tokens of the
    round). Recurrent drafts (SSM) carry no sequence axis, so the stack is
    k + 2 copies of a per-slot state, and the per-slot rollback after the
    verify is one gather (:func:`select_snapshot`). Positional drafts
    (dense / moe KV lanes) never need this: their rollback is cursor
    arithmetic, stale rows past the committed position being overwritten
    before any read."""
    return {k: torch.stack([s[k] for s in snaps]) for k in snaps[0]}


def select_snapshot(stacked: Dict[str, torch.Tensor],
                    idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-slot rollback gather over a :func:`snapshot_stack` result.

    Every cache leaf follows the lanes convention, batch on axis 1, so a
    stacked leaf is ``[n_snaps, X, B, ...]``; slot ``b`` rolls back to
    snapshot ``idx[b]`` (its committed-token count this round: 0 = full
    rejection, k + 1 = full acceptance and the bonus token). Each leaf
    comes back contiguous, ``[X, B, ...]``."""
    def pick(leaf):
        moved = leaf.movedim(2, 0)                  # [B, n_snaps, X, ...]
        sel = moved[torch.arange(moved.shape[0], device=leaf.device),
                    idx.long()]
        return sel.movedim(0, 1).contiguous()       # [X, B, ...]
    return {k: pick(v) for k, v in stacked.items()}
