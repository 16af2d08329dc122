"""Port of repro/models/transformer.py (the dense serving path's share).

Dense decoder-only transformer as an ``nn.Module``: ``init`` (the JAX
package's scales, from a seeded ``torch.Generator``), ``init_cache``,
``prefill`` and ``decode_step_paged`` with ``attention="reference"`` (gather
the per-slot view from the pool, concatenate the ring) and ``"fused"`` (the
``flash_decode_paged`` kernel walks the page table and folds the ring lanes
into the same softmax). The layer stack is a Python loop over
``nn.ModuleList`` blocks where the JAX package scans stacked parameters.

``decode_chunk_paged``, ``chunk_prefill``, the dense-lane ``decode_step``,
the VLM cross-attention blocks and sliding-window caches are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import DENSE, ModelConfig
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


def dense_block(cfg: ModelConfig, blk: DenseBlock, x: torch.Tensor,
                positions: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    dt = x.dtype
    x = x + L.attention(cfg, blk.attn.tensors(dt),
                        L.apply_norm(cfg, blk.ln1.tensors(), x), positions,
                        mask=mask)
    x = x + L.apply_mlp(cfg, blk.mlp.tensors(dt),
                        L.apply_norm(cfg, blk.ln2.tensors(), x))
    return x


class DecoderLM(nn.Module):
    """Dense decoder-only LM. Parameters are fp32 masters created on
    ``device``; activations and the KV cache use ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, device="cpu"):
        super().__init__()
        if cfg.family != DENSE or cfg.cross_attn_every or cfg.sliding_window:
            raise NotImplementedError(
                f"not ported yet: {cfg.name} (family {cfg.family!r}, "
                f"cross_attn_every={cfg.cross_attn_every}, "
                f"sliding_window={cfg.sliding_window}); the dense, "
                f"linear-addressed decoder only")
        self.cfg = cfg
        self.is_vlm = False
        self.device = torch.device(device)
        self.embed = L.Embed(cfg, device)
        self.ln_f = L.Norm(cfg, device)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, device) for _ in range(cfg.n_layers))

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
        slice: the offload/direct path."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        dims = L.attn_dims(cfg)
        b, s = tokens.shape
        dev = tokens.device
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        positions = torch.arange(s, device=dev).expand(b, s)
        mask = L.causal_mask(s, s, device=dev)
        cache = self.init_cache(b, max_seq, dtype)
        for i, blk in enumerate(self.blocks):
            pa = blk.attn.tensors(dtype)
            hn = L.apply_norm(cfg, blk.ln1.tensors(), x)
            # q/k/v once: the values layers.attention would recompute
            q = L.project_q(cfg, pa, hn, positions)
            k, v = L.project_kv(cfg, pa, hn, positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            out = L.sdpa(q, L.repeat_kv(k, dims.n_heads),
                         L.repeat_kv(v, dims.n_heads), mask)
            x = x + torch.einsum("bshk,hkd->bsd", out, pa["wo"].to(dtype))
            x = x + L.apply_mlp(cfg, blk.mlp.tensors(dtype),
                                L.apply_norm(cfg, blk.ln2.tensors(), x))
        x = L.apply_norm(cfg, self.ln_f.tensors(), x[:, -1:])
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
                    ak = torch.cat([ak, rk], dim=1)
                    av = torch.cat([av, rv], dim=1)
                a = L.decode_attention(cfg, pa, hn, pos, ak, av, full_mask)
            x = x + a
            x = x + L.apply_mlp(cfg, blk.mlp.tensors(dtype),
                                L.apply_norm(cfg, blk.ln2.tensors(), x))

        if ring:
            PG.ring_commit(cache, pos, unload_mask)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache
