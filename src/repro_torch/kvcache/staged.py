"""Port of repro/kvcache/staged.py: staged KV-cache writes on the lanes
cache, the unload path for decode-time KV insertion, built on the shared
ring machinery in ``core.ring`` (the flat ``RemoteWriteEngine`` ring and the
paged overlay are its other instantiations).

A decode step writes one (k, v) tile per layer and sequence into an
arbitrary slot of a large ``[L, B, S, H, Dh]`` cache. Three write paths, as
in the paper:

* DIRECT (offload): ``transformer.direct_kv_write``, a per-sequence scatter
  straight into the cache.
* STAGED (unload): the new tiles append to a small RING overlay ``[L, B, R,
  H, Dh]`` at one column per step. Attention reads cache ∪ ring (their
  concatenation on the sequence axis under :func:`overlay_step`'s mask), so
  nothing is missing while entries are staged. A drain copies every staged
  entry to its slot in one launch of the ``staged_scatter`` kernel (K1).
* ADAPTIVE: the decision module routes per sequence (hot pages direct, cold
  ones staged).

The ring lives in the cache dict (``ring_k`` / ``ring_v`` payload planes,
``ring_slot`` [B, R] destination slots, -1 where a sequence wrote direct,
``ring_fill`` the append cursor), and every rule (validity, overflow,
conflicts) is ``core.ring``'s on a :func:`ring_state` view. Buffers are
updated IN PLACE where the JAX package returns new arrays.

The drain (:func:`drain_ring`): the JAX package drains each (layer,
sequence) through ``scatter_rows``; here each layer's K and V lanes are one
plane ``[B * S, H * Dh]`` and staged entry ``(b, r)`` goes to row ``b * S +
ring_slot[b, r]`` (an entry that is not live to row ``B * S``, outside the
plane, which the kernel drops), so both planes of every layer share one
routing list: one K1 launch a drain, the same bits as the per-sequence
drain. :func:`maybe_drain` launches it every call with the decision (ring
full, or a conflict with the next step's slots) folded into the routing's
``valid``, as ``kvcache.paged``'s gated drain does, so a decode loop reads
nothing on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import ring as R

Cache = Dict[str, torch.Tensor]


def add_ring(cache: Cache, ring_size: int) -> Cache:
    """A new cache dict: ``cache``'s leaves plus an empty staging ring of
    ``ring_size`` columns (``{k, v: [L, B, S, H, Dh]}``)."""
    l, b, s, h, dh = cache["k"].shape
    dev = cache["k"].device
    return dict(
        cache,
        ring_k=torch.zeros((l, b, ring_size, h, dh), dtype=cache["k"].dtype,
                           device=dev),
        ring_v=torch.zeros((l, b, ring_size, h, dh), dtype=cache["v"].dtype,
                           device=dev),
        ring_slot=torch.full((b, ring_size), -1, dtype=torch.int64,
                             device=dev),
        ring_fill=torch.zeros((), dtype=torch.int64, device=dev),
    )


def strip_ring(cache: Cache) -> Cache:
    return {k: v for k, v in cache.items() if not k.startswith("ring_")}


def ring_state(cache: Cache) -> R.RingState:
    """The shared bookkeeping view of the ring fields (dense mode)."""
    return R.dense_state(cache["ring_slot"], cache["ring_fill"])


def ring_validity(cache: Cache) -> torch.Tensor:
    """bool [B, R]: ring entries holding live (undrained) KV."""
    return ring_state(cache).live


def ring_full(cache: Cache) -> torch.Tensor:
    return R.full(ring_state(cache))


def ring_conflicts(cache: Cache, slots: torch.Tensor) -> torch.Tensor:
    """True (a device scalar) if this step's destination ``slots`` [B]
    collide with a pending staged entry of the same sequence: the drain
    must run first, so a drain's destination rows stay unique (the
    ``staged_scatter`` precondition) and program order per slot holds."""
    return R.conflicts(ring_state(cache), (cache["ring_slot"],),
                       (slots[:, None],))


def stage_tile(plane: torch.Tensor, tile: torch.Tensor,
               cur: torch.Tensor) -> torch.Tensor:
    """Append one layer's new KV tile [B, 1, H, Dh] at ring column ``cur``
    of the layer's ring plane [B, R, H, Dh], IN PLACE."""
    return R.push_column(plane, cur, tile[:, 0], axis=1)


def ring_commit(cache: Cache, slots: torch.Tensor,
                unload_mask: torch.Tensor) -> Cache:
    """Record this step's destination slots (-1 for sequences that wrote
    direct) at the cursor and advance it, IN PLACE: the metadata half of
    the append (``stage_tile`` staged the payload layer by layer)."""
    cur = cache["ring_fill"]
    rows = torch.where(unload_mask, slots.long(), -1)
    R.push_column(cache["ring_slot"], cur, rows)
    cache["ring_fill"] = cur + 1
    return cache


def _shadowed(cache: Cache, clen: int,
              extra_slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool [B, S]: cache slots whose authoritative value is pending in the
    ring (excluded from the base mask). ``extra_slot`` [B] adds one slot a
    sequence (sentinel ``clen`` = none), the entry staged this step."""
    return R.shadow_mask(ring_validity(cache), cache["ring_slot"], clen,
                         extra_rows=extra_slot)


def overlay_step(
    cache: Cache,
    vmask: torch.Tensor,        # bool [B, S] cache validity after the write
    slots: torch.Tensor,        # int [B] this step's destination slots
    unload_mask: torch.Tensor,  # bool [B] True = stage, False = direct
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-step overlay bookkeeping for ``decode_step``: (full_mask [B, S +
    R], the attention validity over cache ∪ ring; direct_slots [B], the
    cache slots of the direct subset, sentinel ``S`` for staged sequences;
    cur, the ring column this step appends to). A staged entry's cache slot
    is shadowed out of the base mask: its value lives in the ring until
    drained."""
    b, clen = vmask.shape
    r = cache["ring_slot"].shape[1]
    cur = cache["ring_fill"]
    ring_valid = ring_validity(cache) | (
        (torch.arange(r, device=vmask.device)[None, :] == cur)
        & unload_mask[:, None])
    slot_now = torch.where(unload_mask, slots.long(), clen)
    shadowed = _shadowed(cache, clen, extra_slot=slot_now)
    full_mask = torch.cat([vmask & ~shadowed, ring_valid], dim=1)
    direct_slots = torch.where(unload_mask, clen, slots.long())
    return full_mask, direct_slots, cur


def drain_plan(cache: Cache, gate: Optional[torch.Tensor] = None):
    """What one drain copies: ``(planes, rows, ok)``, each layer's K and V
    lanes as ``(dest [L, B * S, H * Dh], staging [L, B * R, H * Dh])``
    planes and one routing list for all of them (see the module
    docstring), live entries only where ``gate`` (a device bool scalar;
    None = always) holds."""
    l, b, r, h, dh = cache["ring_k"].shape
    s = cache["k"].shape[2]
    slot = cache["ring_slot"]
    ok = ring_validity(cache) & (slot < s)
    if gate is not None:
        ok = ok & gate
    lane = torch.arange(b, device=slot.device)[:, None] * s
    rows = torch.where(ok, lane + slot, b * s).reshape(-1)
    planes = [(cache[c].view(l, b * s, h * dh),
               cache[st].view(l, b * r, h * dh))
              for c, st in (("k", "ring_k"), ("v", "ring_v"))]
    return planes, rows, ok.reshape(-1)


def _drain(cache: Cache, gate: Optional[torch.Tensor]) -> Cache:
    """Copy the live staged entries to their cache slots and empty the ring
    (only where ``gate`` holds; None = always), IN PLACE: one
    ``staged_scatter`` launch over :func:`drain_plan`'s planes."""
    R.scatter_rows_layers(*drain_plan(cache, gate))
    if gate is None:
        cache["ring_slot"].fill_(-1)
        cache["ring_fill"] = torch.zeros_like(cache["ring_fill"])
    else:
        cache["ring_slot"] = torch.where(gate, -1, cache["ring_slot"])
        cache["ring_fill"] = torch.where(gate, 0, cache["ring_fill"])
    return cache


def drain_ring(cache: Cache) -> Cache:
    """Bulk-copy every staged entry to its cache slot and empty the ring
    (dense mode: the cursor rewinds), IN PLACE."""
    return _drain(cache, None)


def maybe_drain(cache: Cache, incoming_slots: Optional[torch.Tensor] = None,
                ) -> Tuple[Cache, torch.Tensor]:
    """The conditional drain of a decode loop, without a host read: due
    when the ring is full OR (with ``incoming_slots``) the next step's
    destinations conflict with pending entries. The drain is launched every
    call with ``due`` folded into its routing's validity. Returns (cache,
    due: a device bool scalar)."""
    due = ring_full(cache)
    if incoming_slots is not None:
        due = due | ring_conflicts(cache, incoming_slots)
    return _drain(cache, due), due


def overlay_masks(cache: Cache, base_mask: torch.Tensor) -> torch.Tensor:
    """Validity over cache ∪ ring for ``base_mask`` [B, S]: staged entries
    valid up to the cursor, their cache slots excluded from the base."""
    s = base_mask.shape[1]
    return torch.cat([base_mask & ~_shadowed(cache, s), ring_validity(cache)],
                     dim=1)


def overlay_kv(cache: Cache, layer_k: torch.Tensor, layer_v: torch.Tensor,
               ring_k: torch.Tensor, ring_v: torch.Tensor):
    """Concatenate a layer's cache and ring K/V along the sequence axis
    (``cache`` is unused, as in the JAX package's signature)."""
    return torch.cat([layer_k, ring_k], dim=1), torch.cat([layer_v, ring_v],
                                                          dim=1)


__all__ = ["add_ring", "drain_plan", "drain_ring", "maybe_drain", "overlay_kv",
           "overlay_masks", "overlay_step", "ring_commit", "ring_conflicts",
           "ring_full", "ring_state", "ring_validity", "stage_tile",
           "strip_ring"]
