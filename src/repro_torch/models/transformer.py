"""Port of repro/models/transformer.py (the dense serving path's share).

Dense decoder-only transformer as an ``nn.Module``: ``init`` (the JAX
package's scales, from a seeded ``torch.Generator``), ``init_cache``,
``prefill`` (attention through the ``flash_attention`` kernel, causal with
the sliding window; a sliding-window cache keeps the last ``cache_len``
positions at slot ``pos % cache_len``), the dense-lane ``decode_step`` (the
lanes layout: one cache lane per slot, read by the ``flash_decode`` kernel)
and ``decode_step_paged`` with ``attention="reference"`` (gather the
per-slot view from the pool, concatenate the ring, read it through
``flash_decode``) and ``"fused"`` (the ``flash_decode_paged`` kernel walks
the page table and folds the ring lanes into the same softmax). Under a
mesh the cache's data planes are split on the head axis: every write lands
each shard's head slice (``kvcache.paged``), the reference read gathers the
view shard by shard and joins the heads, and the fused read is one
``flash_decode_paged`` launch per device over its shards
(``flash_decode_paged_sharded``);
the projections run whole on the lead device. The layer
stack is a Python loop over ``nn.ModuleList`` blocks where the JAX package
scans stacked parameters.

``decode_chunk_paged`` is the mixed-phase step of the chunked paged engine
(each slot a prefill chunk, one decode token or nothing; the fused read is
``flash_decode_paged`` at ``C = chunk_size``), and ``chunk_prefill`` the
lanes layout's chunked prefill (each chunk read by ``flash_attention`` over
the cache unrolled to position order plus the chunk, so it computes what
``prefill`` computes, also past the sliding window). The staging-ring
overlay on the lanes cache (``kvcache/staged.py``) and the VLM
cross-attention blocks are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import DENSE, ModelConfig
from ..core.paths import resolve_device
from ..kvcache import paged as PG
from . import layers as L

Cache = Dict[str, torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.attn.init_(cfg, gen)
        self.mlp.init_(cfg, gen)


# ---------------------------------------------------------------------------
# Decode-time KV handling (dense lanes)
# ---------------------------------------------------------------------------


def lane_write_plan(slots: torch.Tensor, s: int):
    """Where one decode step writes in a ``[B, S, ...]`` lane cache, shared
    by every layer: ``(rows, at, keep)``, ``at`` the slots clamped into
    ``[0, S)``, ``keep`` False where a slot falls outside (dropped)."""
    rows = torch.arange(slots.shape[0], device=slots.device)
    keep = ((slots >= 0) & (slots < s))[:, None, None]
    return rows, slots.clamp(0, s - 1).long(), keep


def write_lanes(kc: torch.Tensor, vc: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, plan) -> None:
    """Write one step's K/V rows at ``plan = lane_write_plan(...)``, IN
    PLACE; a dropped row rewrites what it holds."""
    rows, at, keep = plan
    for c, new in ((kc, k_new), (vc, v_new)):
        c[rows, at] = torch.where(keep, new[:, 0].to(c.dtype), c[rows, at])


def direct_kv_write(kc: torch.Tensor, vc: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, slots: torch.Tensor):
    """Default (offload-path) writer: per-sequence scatter, IN PLACE.
    kc/vc: [B, S, Hkv, Dh]; k_new/v_new: [B, 1, Hkv, Dh]; slots: int [B].
    Out-of-range slots (outside ``[0, S)``) are DROPPED, as the JAX
    package's ``mode="drop"`` does: such a row rewrites what it holds, so
    nothing is read on the host."""
    write_lanes(kc, vc, k_new, v_new, lane_write_plan(slots, kc.shape[1]))
    return kc, vc


def cache_slots(cfg: ModelConfig, pos: torch.Tensor,
                cache_len: int) -> torch.Tensor:
    """Ring addressing for SWA caches; linear otherwise."""
    if cfg.sliding_window and cache_len <= cfg.sliding_window:
        return pos % cache_len
    return torch.clamp(pos, max=cache_len - 1)


def valid_mask(cfg: ModelConfig, pos: torch.Tensor,
               cache_len: int) -> torch.Tensor:
    """bool [B, S]: which cache slots hold live keys after writing at
    ``pos``. Linear cache: slots 0..pos. SWA ring: all slots once
    ``pos >= cache_len - 1``, else slots 0..pos."""
    slot_ids = torch.arange(cache_len, device=pos.device)[None, :]
    linear = slot_ids <= pos[:, None]
    if cfg.sliding_window and cache_len <= cfg.sliding_window:
        return linear | (pos[:, None] >= cache_len - 1)
    return linear


# ---------------------------------------------------------------------------
# One layer's attention and MLP: the bodies DecoderLM runs for each layer,
# ZambaLM for each application of its shared block and WhisperModel (with
# ``use_rope=False``) for its decoder's self-attention. ``ln1`` / ``ln2`` and
# ``pa`` / ``pm`` are the block's norm, attention and MLP tensors in the
# compute dtype; ``kc`` / ``vc`` the layer's K/V lanes [B, clen, Hkv, Dh]
# ---------------------------------------------------------------------------


def dense_ffn(cfg: ModelConfig, ln2, pm, x: torch.Tensor) -> torch.Tensor:
    """The pre-norm MLP on the residual stream ``x`` (its output, not yet
    added)."""
    return L.apply_mlp(cfg, pm, L.apply_norm(cfg, ln2, x))


def attend_prefill(cfg: ModelConfig, ln1, pa, x: torch.Tensor,
                   positions: torch.Tensor, kc: torch.Tensor,
                   vc: torch.Tensor, use_rope: bool = True) -> torch.Tensor:
    """``x`` plus the prompt's causal attention (``flash_attention``); the
    prompt's K/V written into the lanes in one dense slice. A prompt longer
    than the lanes (sliding window) keeps its last ``clen`` positions, each
    at slot ``pos % clen``. ``use_rope=False``: learned positions (whisper's
    decoder), no rotary."""
    s, clen = x.shape[1], kc.shape[1]
    hn = L.apply_norm(cfg, ln1, x)
    # q/k/v once: the values layers.attention would recompute
    q = L.project_q(cfg, pa, hn, positions, use_rope)
    k, v = L.project_kv(cfg, pa, hn, positions if use_rope else None)
    for dst, kv in ((kc, k), (vc, v)):
        if s <= clen:
            dst[:, :s] = kv
        else:
            dst.copy_(torch.roll(kv[:, -clen:], s % clen, dims=1))
    out = L.attention_core(cfg, q, k, v)
    return x + torch.einsum("bshk,hkd->bsd", out, pa["wo"].to(x.dtype))


def attend_chunk(cfg: ModelConfig, ln1, pa, x: torch.Tensor,
                 positions: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 start_pos: int, use_rope: bool = True) -> torch.Tensor:
    """``x`` plus a prompt chunk's attention over the lanes as they stand
    before the chunk plus its own keys (``chunk_attention``); then the
    chunk's K/V written (``write_chunk``)."""
    hn = L.apply_norm(cfg, ln1, x)
    k_new, v_new = L.project_kv(cfg, pa, hn, positions if use_rope else None)
    x = x + L.chunk_attention(cfg, pa, hn, positions, kc, vc, k_new, v_new,
                              start_pos, use_rope)
    L.write_chunk(kc, k_new, start_pos)
    L.write_chunk(vc, v_new, start_pos)
    return x


def attend_decode(cfg: ModelConfig, ln1, pa, x: torch.Tensor,
                  pos: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  plan, vmask: torch.Tensor,
                  use_rope: bool = True) -> torch.Tensor:
    """``x`` [B, 1, D] plus one decode step's attention: the new K/V row
    written at ``plan`` (``lane_write_plan``), then the lanes read through
    ``flash_decode`` under ``vmask``."""
    hn = L.apply_norm(cfg, ln1, x)
    k_new, v_new = L.project_kv(cfg, pa, hn,
                                pos[:, None] if use_rope else None)
    write_lanes(kc, vc, k_new, v_new, plan)
    return x + L.decode_attention(cfg, pa, hn, pos, kc, vc, vmask, use_rope)


class DecoderLM(nn.Module):
    """Dense decoder-only LM, with or without a sliding window. Parameters
    are fp32 masters created on ``device`` (the GPU unless the caller asks
    for the CPU; ``"cuda"`` without CUDA raises); activations and the KV
    cache use ``cfg.dtype``. A subclass of another family swaps the block
    (``block_cls``) and its FFN (``_ffn``): ``models.moe_lm.MoELM``."""

    family = DENSE
    block_cls = DenseBlock

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family != self.family or cfg.cross_attn_every:
            raise NotImplementedError(
                f"not ported yet: {cfg.name} (family {cfg.family!r}, "
                f"cross_attn_every={cfg.cross_attn_every}) in "
                f"{type(self).__name__}, which takes the {self.family!r} "
                f"family")
        device = resolve_device(device)
        self.cfg = cfg
        self.is_vlm = False
        self.device = device
        self.embed = L.Embed(cfg, device)
        self.ln_f = L.Norm(cfg, device)
        self.blocks = nn.ModuleList(
            self.block_cls(cfg, device) for _ in range(cfg.n_layers))

    def _ffn(self, blk, x: torch.Tensor) -> torch.Tensor:
        """The block's FFN on the residual stream ``x`` (pre-norm)."""
        return dense_ffn(self.cfg, blk.ln2.tensors(), blk.mlp.tensors(x.dtype),
                         x)

    # -- init ------------------------------------------------------------
    def init(self, seed: int = 0) -> "DecoderLM":
        """Random weights with the JAX package's scales, from ``seed``. (The
        two frameworks draw different numbers from one seed; to compare them
        carry weights across with ``checkpoint.params_from_numpy``.)"""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.init_(self.cfg, gen)
        for blk in self.blocks:
            blk.init_(self.cfg, gen)
        return self

    # -- KV cache ----------------------------------------------------------
    def cache_len(self, max_seq: int) -> int:
        if self.cfg.sliding_window:
            return min(max_seq, self.cfg.sliding_window)
        return max_seq

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> Cache:
        cfg = self.cfg
        dims = L.attn_dims(cfg)
        dtype = dtype or compute_dtype(cfg)
        shape = (cfg.n_layers, batch, self.cache_len(max_seq),
                 dims.n_kv_heads, dims.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                max_seq: int) -> Tuple[torch.Tensor, Cache]:
        """Run the full prompt, build the cache, return last-token logits
        (fp32 [B, V]). Prefill writes the whole prompt's KV in one dense
        slice: the offload/direct path. A prompt longer than the cache
        (sliding window) keeps its last ``cache_len`` positions, each at
        slot ``pos % cache_len``."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, s = tokens.shape
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_seq, dtype)
        for i, blk in enumerate(self.blocks):
            x = attend_prefill(cfg, blk.ln1.tensors(), blk.attn.tensors(dtype),
                               x, positions, cache["k"][i], cache["v"][i])
            x = x + self._ffn(blk, x)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x[:, -1:])
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- chunked prefill (dense lanes) -------------------------------------
    @torch.no_grad()
    def chunk_prefill(self, cache: Cache, tokens: torch.Tensor,
                      start_pos: int) -> Tuple[torch.Tensor, Cache]:
        """Process one prompt chunk against the running lane cache, updated
        IN PLACE: tokens [B, C] at absolute positions ``start_pos ..``,
        returns the last chunk token's logits (fp32 [B, V]) and the cache.
        Per layer the chunk's queries read the cache as it stands BEFORE
        the chunk's write plus the chunk's own keys (``chunk_attention``),
        then the chunk is written (``write_chunk``), so chunk after chunk
        this computes what ``prefill`` computes over the whole prompt, also
        once the prompt passes a sliding window. Chunk writes are dense
        slices: the offload/direct path."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, c = tokens.shape
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        positions = (start_pos
                     + torch.arange(c, device=tokens.device)).expand(b, c)
        for i, blk in enumerate(self.blocks):
            x = attend_chunk(cfg, blk.ln1.tensors(), blk.attn.tensors(dtype),
                             x, positions, cache["k"][i], cache["v"][i],
                             start_pos)
            x = x + self._ffn(blk, x)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x[:, -1:])
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- decode (dense lanes) ----------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step against the dense lane cache, updated IN PLACE.
        tokens [B], pos [B] -> logits [B, V] (fp32), cache. Each layer's new
        K/V row goes to ``cache_slots(pos)`` by direct scatter (the offload
        path); ``write_mask`` [B] False sends a slot's rows to the drop row
        ``cache_len``, so a retired slot never writes. Where each step
        writes is worked out once for all layers. No value is read on the
        host."""
        if "ring_k" in cache:
            raise NotImplementedError(
                "not ported yet: the staging-ring overlay on the lanes cache "
                "(kvcache/staged.py); the lanes layout is direct-only here")
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens[:, None], dtype)
        clen = cache["k"].shape[2]
        slots = cache_slots(cfg, pos, clen)
        if write_mask is not None:
            slots = torch.where(write_mask, slots, clen)
        plan = lane_write_plan(slots, clen)
        vmask = valid_mask(cfg, pos, clen)
        for i, blk in enumerate(self.blocks):
            x = attend_decode(cfg, blk.ln1.tensors(), blk.attn.tensors(dtype),
                              x, pos, cache["k"][i], cache["v"][i], plan,
                              vmask)
            x = x + self._ffn(blk, x)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- decode (paged pool) -----------------------------------------------
    @torch.no_grad()
    def decode_step_paged(
        self,
        cache: PG.PagedKV,
        tokens: torch.Tensor,
        pos: torch.Tensor,
        write_mask: torch.Tensor,
        unload_mask: Optional[torch.Tensor] = None,
        attention: str = "reference",
        plan: Optional[PG.StepPlan] = None,
    ) -> Tuple[torch.Tensor, PG.PagedKV]:
        """One decode step against a PAGED KV pool, updated IN PLACE.

        tokens [B], pos [B] (logical positions, per slot) -> logits [B, V]
        (fp32), cache. ``write_mask`` [B]: False suppresses every KV write
        for that slot (its physical destination resolves to the sink).
        ``unload_mask`` [B] routes live writes: True = stage into the ring
        overlay (unload path), False/None = direct scatter to the slot's
        physical row (offload path). ``attention`` picks the read
        implementation: ``"reference"`` gathers the per-slot view and
        concatenates the ring; ``"fused"`` hands the pool, the block table
        and the ring planes to ``flash_decode_paged``. ``plan`` threads the
        per-segment page-table products; derived here when None. No value is
        read on the host."""
        cfg = self.cfg
        fused = attention == "fused"
        dtype = compute_dtype(cfg)
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens[:, None], dtype)
        ring = PG.has_ring(cache)
        if plan is None:
            plan = PG.step_plan(cache)
        vmask = PG.view_mask_from(plan.allocated, pos)
        if ring:
            if unload_mask is None:
                unload_mask = torch.ones_like(write_mask)
            unload_mask = unload_mask & write_mask
            view_ok, ring_ok, cur = PG.overlay_step_parts(
                cache, vmask, pos, unload_mask)
            full_mask = torch.cat([view_ok, ring_ok], dim=1)
            direct = write_mask & ~unload_mask
        else:
            view_ok = full_mask = vmask
            ring_ok = None
            direct = write_mask
        # physical destination for the direct subset; the -1 sentinel sends
        # staged and dead slots to the sink
        dest = PG.logical_to_physical(cache, torch.where(direct, pos, -1))
        view_ok_c = view_ok[:, None, :].contiguous() if fused else None

        for i, blk in enumerate(self.blocks):
            pa = blk.attn.tensors(dtype)
            pk, pv = cache["pages_k"][i], cache["pages_v"][i]
            hn = L.apply_norm(cfg, blk.ln1.tensors(), x)
            k_new, v_new = L.project_kv(cfg, pa, hn, pos[:, None])
            PG.scatter_token(pk, dest, k_new[:, 0])
            PG.scatter_token(pv, dest, v_new[:, 0])
            rk = rv = None
            if ring:
                rk, rv = cache["ring_k"][i], cache["ring_v"][i]
                PG.stage_tile(rk, k_new[:, 0], cur)
                PG.stage_tile(rv, v_new[:, 0], cur)
            if fused:
                a = L.fused_paged_attention(
                    cfg, pa, hn, pos[:, None], pk, pv, plan.blocks,
                    view_ok_c, rk, rv, ring_ok)
            else:
                ak = PG.gather_view(pk, plan.view_ids)
                av = PG.gather_view(pv, plan.view_ids)
                if ring:
                    ak = torch.cat([ak, PG.whole(rk)], dim=1)
                    av = torch.cat([av, PG.whole(rv)], dim=1)
                a = L.decode_attention(cfg, pa, hn, pos, ak, av, full_mask)
            x = x + a
            x = x + self._ffn(blk, x)

        if ring:
            PG.ring_commit(cache, pos, unload_mask)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- mixed-phase chunk step (paged pool) --------------------------------
    @torch.no_grad()
    def decode_chunk_paged(
        self,
        cache: PG.PagedKV,
        tokens: torch.Tensor,       # int [B, C] token slab
        start: torch.Tensor,        # int [B] logical row/position of column 0
        n_valid: torch.Tensor,      # int [B] live columns (chunk len | 1 | 0)
        write_mask: torch.Tensor,   # bool [B] gates every KV write
        unload_mask: Optional[torch.Tensor] = None,
        attention: str = "reference",
        plan: Optional[PG.StepPlan] = None,
        all_logits: bool = False,
    ) -> Tuple[torch.Tensor, PG.PagedKV]:
        """One MIXED-PHASE step against the paged pool, updated IN PLACE:
        each slot processes a [C]-token slab, a prefill chunk (``n_valid``
        prompt tokens from its chunk cursor), one decode token (``n_valid
        == 1``, column 0) or nothing (``n_valid == 0``). Column ``j`` of
        slot ``b`` sits at logical row ``start[b] + j``.

        The chunk's rows land in the pool (the bulk/offload path) before
        the read; ``unload_mask`` may stage only the column-0 decode write.
        ``attention`` picks the read as in :meth:`decode_step_paged`:
        ``"fused"`` is ``flash_decode_paged`` with ``q[B, C, Hq, Dh]``,
        ``"reference"`` the gathered view plus the ring read column by
        column (``masked_chunk_attention``). Returns logits [B, V] (fp32)
        at each slot's LAST valid column, the sampling position of both
        phases, or with ``all_logits`` logits [B, C, V] at every column
        (column ``j`` predicts position ``start + j + 1``, what a
        speculative verify reads). No value is read on the host."""
        cfg = self.cfg
        fused = attention == "fused"
        dtype = compute_dtype(cfg)
        b, c = tokens.shape
        dev = tokens.device
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        offs = torch.arange(c, device=dev)
        positions = start.long()[:, None] + offs[None, :]
        wvalid = (offs[None, :] < n_valid[:, None]) & write_mask[:, None]
        ring = PG.has_ring(cache)
        if plan is None:
            plan = PG.step_plan(cache)
        if ring:
            if unload_mask is None:
                unload_mask = torch.zeros((b,), dtype=torch.bool, device=dev)
            unload_mask = unload_mask & wvalid[:, 0]
            view_ok, ring_ok, cur = PG.overlay_chunk_parts(
                cache, positions, unload_mask, allocated=plan.allocated)
            direct = wvalid & ~unload_mask[:, None]
        else:
            view_ok = PG.view_chunk_mask_from(plan.allocated, positions)
            ring_ok = None
            direct = wvalid
        dest = PG.logical_to_physical_many(
            cache, torch.where(direct, positions, -1))
        if fused:
            view_ok = view_ok.contiguous()
        else:
            full_mask = view_ok if not ring else torch.cat(
                [view_ok, ring_ok[:, None, :].expand(b, c, ring_ok.shape[1])],
                dim=2)

        for i, blk in enumerate(self.blocks):
            pa = blk.attn.tensors(dtype)
            pk, pv = cache["pages_k"][i], cache["pages_v"][i]
            hn = L.apply_norm(cfg, blk.ln1.tensors(), x)
            k_new, v_new = L.project_kv(cfg, pa, hn, positions)
            PG.scatter_chunk(pk, dest, k_new)
            PG.scatter_chunk(pv, dest, v_new)
            rk = rv = None
            if ring:
                rk, rv = cache["ring_k"][i], cache["ring_v"][i]
                PG.stage_tile(rk, k_new[:, 0], cur)
                PG.stage_tile(rv, v_new[:, 0], cur)
            if fused:
                a = L.fused_paged_attention(
                    cfg, pa, hn, positions, pk, pv, plan.blocks, view_ok,
                    rk, rv, ring_ok)
            else:
                ak = PG.gather_view(pk, plan.view_ids)
                av = PG.gather_view(pv, plan.view_ids)
                if ring:
                    ak = torch.cat([ak, PG.whole(rk)], dim=1)
                    av = torch.cat([av, PG.whole(rv)], dim=1)
                a = L.masked_chunk_attention(cfg, pa, hn, positions, ak, av,
                                             full_mask)
            x = x + a
            x = x + self._ffn(blk, x)

        if ring:
            PG.ring_commit(cache, start, unload_mask)
        if all_logits:
            x = L.apply_norm(cfg, self.ln_f.tensors(), x)
            return L.lm_logits(cfg, self.embed.tensors(), x), cache
        # logits at each slot's last valid column: the final prompt token
        # (prefill, the phase flip's sampling) or the decode token (column 0)
        sel = (n_valid.long() - 1).clamp(min=0)
        x = x[torch.arange(b, device=dev), sel][:, None]
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache
