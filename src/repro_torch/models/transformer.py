"""Port of repro/models/transformer.py: the decoder-only stack, dense and
VLM.

Dense decoder-only transformer as an ``nn.Module``: ``init`` (the JAX
package's scales, from a seeded ``torch.Generator``), ``init_cache``,
``prefill`` (attention through the ``flash_attention`` kernel, causal with
the sliding window; a sliding-window cache keeps the last ``cache_len``
positions at slot ``pos % cache_len``), ``forward`` / ``loss`` (training:
the attention body of ``prefill`` without a cache, each layer under
``torch.utils.checkpoint`` with ``remat``), the dense-lane ``decode_step`` (the
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
``prefill`` computes, also past the sliding window). ``decode_step`` on a
lanes cache with a staging ring (``kvcache.staged.add_ring``) routes each
sequence's writes by ``unload_mask``: staged ones append to the ring and
the read is ``flash_decode`` over cache ∪ ring (their concatenation) under
``staged.overlay_step``'s mask.

VLM (llama-3.2-vision style, ``cfg.cross_attn_every > 0``): every
``cross_attn_every``-th layer is a gated cross-attention ``CrossBlock`` over
the request's image embeddings (the stub frontend's ``media``). The stack
runs in GROUPS: ``cross_attn_every - 1`` self layers, then one cross layer;
self layer ``g * n_self_per_group + j`` runs before cross layer ``g``. The
cache adds ``cross_k`` / ``cross_v`` ``[n_groups, B, n_image_tokens, Hkv,
Dh]``, projected from the media by ``prefill`` and by every
``chunk_prefill`` call (as the JAX package does); a decode step reads them
through ``flash_decode`` with every image token valid. The cross read of a
prompt or a chunk is one non-causal ``flash_attention`` call, shared with
whisper's decoder (:func:`attend_cross`). ``forward`` / ``loss`` (training)
walk the groups, each checkpointed under ``remat`` with its self layers
checkpointed inside it, as the reference nests them; without media a cross
layer attends causally over the text, as the reference's ``forward`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import DENSE, VLM, ModelConfig
from ..core.paths import resolve_device
from ..kvcache import paged as PG
from ..kvcache import staged as ST
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


class CrossBlock(L.ParamGroup):
    """A gated cross-attention layer (llama-3.2-vision style): ``ln1``,
    ``attn``, ``ln2``, ``mlp`` and the two 0-d fp32 gates ``gate_attn`` /
    ``gate_mlp``, which start at zero as in the JAX package (so a fresh
    model's cross layers add nothing until the gates are set or loaded)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__({"gate_attn": (), "gate_mlp": ()}, device)
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.attn.init_(cfg, gen)
        self.mlp.init_(cfg, gen)

    def gates(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tanh`` of each gate, taken in fp32 and cast to ``dtype``, as
        the JAX package does before the product."""
        return (torch.tanh(self.gate_attn).to(dtype),
                torch.tanh(self.gate_mlp).to(dtype))


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
# ``use_rope=False``) for its decoder's self-attention; the cross reads that
# WhisperModel's decoder and the VLM's cross layers share. ``ln1`` / ``ln2``
# and ``pa`` / ``pm`` are the block's norm, attention and MLP tensors in the
# compute dtype; ``kc`` / ``vc`` the layer's K/V lanes [B, clen, Hkv, Dh]
# ---------------------------------------------------------------------------


def dense_ffn(cfg: ModelConfig, ln2, pm, x: torch.Tensor) -> torch.Tensor:
    """The pre-norm MLP on the residual stream ``x`` (its output, not yet
    added)."""
    return L.apply_mlp(cfg, pm, L.apply_norm(cfg, ln2, x))


def attend_prefill(cfg: ModelConfig, ln1, pa, x: torch.Tensor,
                   positions: torch.Tensor, kc: Optional[torch.Tensor] = None,
                   vc: Optional[torch.Tensor] = None,
                   use_rope: bool = True) -> torch.Tensor:
    """``x`` plus the prompt's causal attention (``flash_attention``); the
    prompt's K/V written into the lanes in one dense slice. A prompt longer
    than the lanes (sliding window) keeps its last ``clen`` positions, each
    at slot ``pos % clen``. ``use_rope=False``: learned positions (whisper's
    decoder), no rotary. Without lanes (``kc`` / ``vc`` None: training's
    forward) nothing is written."""
    s = x.shape[1]
    hn = L.apply_norm(cfg, ln1, x)
    # q/k/v once: the values layers.attention would recompute
    q = L.project_q(cfg, pa, hn, positions, use_rope)
    k, v = L.project_kv(cfg, pa, hn, positions if use_rope else None)
    for dst, kv in ((kc, k), (vc, v)):
        if dst is None:
            continue
        clen = dst.shape[1]
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
                  use_rope: bool = True, ring=None) -> torch.Tensor:
    """``x`` [B, 1, D] plus one decode step's attention: the new K/V row
    written at ``plan`` (``lane_write_plan``), then the lanes read through
    ``flash_decode`` under ``vmask``. With ``ring = (rk, rv, cur)`` (the
    layer's staging-ring planes [B, R, Hkv, Dh] and the append column) the
    new row is also staged at ``cur`` and the read covers cache ∪ ring, the
    two concatenated on the sequence axis (``vmask`` is then ``[B, S +
    R]``, from ``staged.overlay_step``)."""
    hn = L.apply_norm(cfg, ln1, x)
    k_new, v_new = L.project_kv(cfg, pa, hn,
                                pos[:, None] if use_rope else None)
    write_lanes(kc, vc, k_new, v_new, plan)
    if ring is not None:
        rk, rv, cur = ring
        ST.stage_tile(rk, k_new, cur)
        ST.stage_tile(rv, v_new, cur)
        kc, vc = torch.cat([kc, rk], dim=1), torch.cat([vc, rv], dim=1)
    return x + L.decode_attention(cfg, pa, hn, pos, kc, vc, vmask, use_rope)


def attend_cross(cfg: ModelConfig, ln, pa, x: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor,
                 gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` [B, S, D] plus its cross-attention over the K/V ``ck`` / ``cv``
    [B, T, Hkv, Dh] (whisper's encoder output, the VLM's image tokens):
    q from the normed ``x`` with no rotary, every query reads every key,
    one non-causal ``flash_attention`` call. ``gate`` (the VLM's ``tanh``
    of ``gate_attn`` in the compute dtype) scales the projected output
    before it is added. (The reference's whisper chunk reads its cross
    cache with every frame at position 0, so every key is valid for every
    query: the same read.)"""
    hn = L.apply_norm(cfg, ln, x)
    q = L.project_q(cfg, pa, hn, None, use_rope=False)
    out = L.attention_core(cfg, q, ck, cv, causal=False)
    h = torch.einsum("bshk,hkd->bsd", out, pa["wo"].to(x.dtype))
    return x + (h if gate is None else gate * h)


def attend_cross_decode(cfg: ModelConfig, ln, pa, x: torch.Tensor,
                        pos: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                        mask: torch.Tensor,
                        gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step's cross read: ``x`` [B, 1, D] plus ``flash_decode``
    over ``ck`` / ``cv`` [B, T, Hkv, Dh] under ``mask`` (all true: every
    key valid), no rotary, scaled by ``gate`` where given."""
    hn = L.apply_norm(cfg, ln, x)
    h = L.decode_attention(cfg, pa, hn, pos, ck, cv, mask, use_rope=False)
    return x + (h if gate is None else gate * h)


def remat_call(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint``
    (non-reentrant: its activations recomputed in the backward, a
    checkpoint inside it recomputed again there) when ``remat``: the JAX
    package's ``jax.checkpoint`` of a scan body."""
    if not remat:
        return fn(*args, **kwargs)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def batch_loss(logits: torch.Tensor, batch, device) -> torch.Tensor:
    """Mean token cross-entropy of fp32 ``logits`` [B, S, V] against
    ``batch["labels"]`` (under ``batch["loss_mask"]`` where given), both
    taken onto ``device``."""
    mask = batch.get("loss_mask")
    return L.cross_entropy_loss(
        logits, torch.as_tensor(batch["labels"], device=device),
        None if mask is None else torch.as_tensor(mask, device=device))


class DecoderLM(nn.Module):
    """Dense decoder-only LM, with or without a sliding window, and the VLM
    (``cfg.cross_attn_every > 0``: groups of self layers, each followed by
    a gated ``CrossBlock``). Parameters are fp32 masters created on
    ``device`` (the GPU unless the caller asks for the CPU; ``"cuda"``
    without CUDA raises); activations and the KV cache use ``cfg.dtype``. A
    subclass of another family swaps the block (``block_cls``) and its FFN
    (``_ffn``): ``models.moe_lm.MoELM``."""

    family = DENSE
    # the families this class builds: the dense one and the VLM
    families = (DENSE, VLM)
    block_cls = DenseBlock

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        vlm = cfg.cross_attn_every > 0
        if cfg.family not in self.families or vlm != (cfg.family == VLM):
            raise NotImplementedError(
                f"not ported yet: {cfg.name} (family {cfg.family!r}, "
                f"cross_attn_every={cfg.cross_attn_every}) in "
                f"{type(self).__name__}, which takes the "
                f"{' / '.join(map(repr, self.families))} family")
        device = resolve_device(device)
        self.cfg = cfg
        self.is_vlm = vlm
        self.device = device
        if vlm:
            if cfg.n_layers % cfg.cross_attn_every:
                raise ValueError(
                    f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple "
                    f"of cross_attn_every {cfg.cross_attn_every}")
            self.n_groups = cfg.n_layers // cfg.cross_attn_every
            self.n_self_per_group = cfg.cross_attn_every - 1
        else:
            self.n_groups, self.n_self_per_group = cfg.n_layers, 1
        self.embed = L.Embed(cfg, device)
        self.ln_f = L.Norm(cfg, device)
        self.blocks = nn.ModuleList(
            self.block_cls(cfg, device)
            for _ in range(self.n_groups * self.n_self_per_group))
        if vlm:
            self.cross_blocks = nn.ModuleList(
                CrossBlock(cfg, device) for _ in range(self.n_groups))

    def _ffn(self, blk, x: torch.Tensor) -> torch.Tensor:
        """The block's FFN on the residual stream ``x`` (pre-norm)."""
        return dense_ffn(self.cfg, blk.ln2.tensors(), blk.mlp.tensors(x.dtype),
                         x)

    def _stack(self):
        """The layers in the order they run: ``(i, blk, cross)`` with
        ``cross`` None for self layer ``i``, else cross layer ``i`` after
        its group's self layers (self layer ``g * n_self_per_group + j``
        before cross layer ``g``, the JAX package's reshape order)."""
        nspg = self.n_self_per_group
        for i, blk in enumerate(self.blocks):
            yield i, blk, None
            if self.is_vlm and i % nspg == nspg - 1:
                g = i // nspg
                yield g, None, self.cross_blocks[g]

    def _media(self, media) -> torch.Tensor:
        """The VLM's image embeddings ``[B, n_image_tokens, D]`` on the
        model's device in the compute dtype (cast on entry, as the JAX
        package does)."""
        cfg = self.cfg
        if media is None:
            raise ValueError(
                f"{cfg.name} takes media: every request needs its image "
                f"embeddings [{cfg.n_image_tokens}, {cfg.d_model}]")
        return torch.as_tensor(media, device=self.device).to(
            compute_dtype(cfg))

    def _cross_layer(self, cb: CrossBlock, x: torch.Tensor,
                     media: Optional[torch.Tensor],
                     cache: Optional[Cache] = None,
                     g: int = 0) -> torch.Tensor:
        """A cross layer over a whole sequence, a prompt or a chunk: its
        image K/V projected from the media (not normed; into ``cache``'s
        group ``g`` where a cache is given) and read by every query (one
        non-causal K3 call), then its gated MLP. Without media (training's
        ``forward`` only) the layer is what the reference computes there,
        ``layers.attention`` with no ``kv_x``: gated CAUSAL self-attention
        over ``x``, no rotary (ROADMAP.md, "Known differences")."""
        cfg, dtype = self.cfg, x.dtype
        pa = cb.attn.tensors(dtype)
        g_attn, g_mlp = cb.gates(dtype)
        if media is None:
            h = L.attention(cfg, pa, L.apply_norm(cfg, cb.ln1.tensors(), x),
                            None, use_rope=False)
            x = x + g_attn * h
        else:
            ck, cv = L.project_kv(cfg, pa, media, None)
            if cache is not None:
                cache["cross_k"][g].copy_(ck)
                cache["cross_v"][g].copy_(cv)
            x = attend_cross(cfg, cb.ln1.tensors(), pa, x, ck, cv,
                             gate=g_attn)
        return x + g_mlp * dense_ffn(cfg, cb.ln2.tensors(),
                                     cb.mlp.tensors(dtype), x)

    # -- init ------------------------------------------------------------
    def init(self, seed: int = 0) -> "DecoderLM":
        """Random weights with the JAX package's scales, from ``seed``; the
        VLM's gates stay zero. (The two frameworks draw different numbers
        from one seed; to compare them carry weights across with
        ``checkpoint.params_from_numpy``.)"""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.init_(self.cfg, gen)
        for blk in self.blocks:
            blk.init_(self.cfg, gen)
        for cb in getattr(self, "cross_blocks", ()):
            cb.init_(self.cfg, gen)
        return self

    # -- KV cache ----------------------------------------------------------
    def cache_len(self, max_seq: int) -> int:
        if self.cfg.sliding_window:
            return min(max_seq, self.cfg.sliding_window)
        return max_seq

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> Cache:
        """``k`` / ``v`` ``[n_self_layers, B, cache_len, Hkv, Dh]``; the
        VLM adds ``cross_k`` / ``cross_v`` ``[n_groups, B, n_image_tokens,
        Hkv, Dh]``."""
        cfg = self.cfg
        dims = L.attn_dims(cfg)
        dtype = dtype or compute_dtype(cfg)

        def zeros(n, s):
            return torch.zeros((n, batch, s, dims.n_kv_heads, dims.head_dim),
                               dtype=dtype, device=self.device)
        n_self = len(self.blocks)
        cache = {"k": zeros(n_self, self.cache_len(max_seq)),
                 "v": zeros(n_self, self.cache_len(max_seq))}
        if self.is_vlm:
            cache["cross_k"] = zeros(self.n_groups, cfg.n_image_tokens)
            cache["cross_v"] = zeros(self.n_groups, cfg.n_image_tokens)
        return cache

    # -- full forward (training) ---------------------------------------------
    def _block(self, blk, x: torch.Tensor, positions: torch.Tensor, **kw):
        """One self layer over a whole sequence, without a cache: the
        attention body ``prefill`` runs (``attend_prefill``), then the
        block's FFN. Returns ``(x,)``; a subclass adds its FFN's statistics
        (``MoELM``: the aux loss and the expert loads)."""
        x = attend_prefill(self.cfg, blk.ln1.tensors(),
                           blk.attn.tensors(x.dtype), x, positions)
        return self._ffn_stats(blk, x, **kw)

    def _ffn_stats(self, blk, x: torch.Tensor):
        """``(x + the block's FFN,)``: the dense family has no statistics."""
        return (x + self._ffn(blk, x),)

    def _trunk(self, x: torch.Tensor, positions: torch.Tensor, remat: bool,
               **kw):
        """Every self layer in order; under ``remat`` each one is
        ``torch.utils.checkpoint`` (non-reentrant), its activations
        recomputed in the backward. Returns ``(x, [the stats of each
        layer])``."""
        stats = []
        for blk in self.blocks:
            x, *st = remat_call(remat, self._block, blk, x, positions, **kw)
            stats.append(st)
        return x, stats

    def _vlm_group(self, x: torch.Tensor, positions: torch.Tensor,
                   media: Optional[torch.Tensor], g: int,
                   remat: bool) -> torch.Tensor:
        """Group ``g`` of the VLM: its self layers (each checkpointed under
        ``remat``), then its cross layer."""
        nspg = self.n_self_per_group
        for blk in self.blocks[g * nspg:(g + 1) * nspg]:
            x, = remat_call(remat, self._block, blk, x, positions)
        return self._cross_layer(self.cross_blocks[g], x, media)

    def _vlm_trunk(self, x: torch.Tensor, positions: torch.Tensor,
                   media: Optional[torch.Tensor], remat: bool) -> torch.Tensor:
        """The VLM's groups in order. Under ``remat`` each group is
        checkpointed and so is each self layer inside it, as the reference
        nests ``jax.checkpoint``: a self layer runs three times in a step
        (the forward, the group's recompute, its own), a cross layer
        twice."""
        for g in range(self.n_groups):
            x = remat_call(remat, self._vlm_group, x, positions, media, g,
                           remat)
        return x

    def _embed_positions(self, tokens):
        """(embeddings in the compute dtype, positions ``0..S-1``) of
        ``tokens [B, S]``, taken onto the model's device."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        x = L.embed_tokens(self.cfg, self.embed.tensors(), tokens,
                           compute_dtype(self.cfg))
        return x, torch.arange(s, device=self.device).expand(b, s)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(self.cfg, self.ln_f.tensors(), x)
        return L.lm_logits(self.cfg, self.embed.tensors(), x)

    def forward(self, tokens: torch.Tensor, media=None,
                remat: bool = False) -> torch.Tensor:
        """tokens [B, S] -> logits fp32 [B, S, V], causal over the whole
        sequence (positions ``0..S-1``): embed in the compute dtype, the
        trunk, ``ln_f``, the fp32 head. Differentiable: the training path.
        The VLM reads ``media`` [B, n_image_tokens, D] (cast to the compute
        dtype on entry) in its cross layers; with ``media`` None they
        attend causally over the text, as the reference's ``forward``
        does. Other models ignore ``media``."""
        x, positions = self._embed_positions(tokens)
        if self.is_vlm:
            media = None if media is None else self._media(media)
            x = self._vlm_trunk(x, positions, media, remat)
        else:
            x, _ = self._trunk(x, positions, remat)
        return self._logits(x)

    def loss(self, batch, remat: bool = True) -> torch.Tensor:
        """Mean token cross-entropy of ``batch`` (``tokens``, ``labels``,
        optional ``loss_mask``; the VLM's ``media`` where given), fp32
        scalar."""
        logits = self.forward(batch["tokens"], batch.get("media"),
                              remat=remat)
        return self._ce(logits, batch)

    def _ce(self, logits: torch.Tensor, batch) -> torch.Tensor:
        return batch_loss(logits, batch, self.device)

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int,
                media: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the full prompt, build the cache, return last-token logits
        (fp32 [B, V]). Prefill writes the whole prompt's KV in one dense
        slice: the offload/direct path. A prompt longer than the cache
        (sliding window) keeps its last ``cache_len`` positions, each at
        slot ``pos % cache_len``. The VLM takes ``media`` [B,
        n_image_tokens, D] (required) and writes each cross layer's image
        K/V; other models ignore it."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, s = tokens.shape
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        media = self._media(media) if self.is_vlm else None
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        cache = self.init_cache(b, max_seq, dtype)
        for i, blk, cb in self._stack():
            if cb is not None:
                x = self._cross_layer(cb, x, media, cache, i)
                continue
            x = attend_prefill(cfg, blk.ln1.tensors(), blk.attn.tensors(dtype),
                               x, positions, cache["k"][i], cache["v"][i])
            x = x + self._ffn(blk, x)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x[:, -1:])
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- chunked prefill (dense lanes) -------------------------------------
    @torch.no_grad()
    def chunk_prefill(self, cache: Cache, tokens: torch.Tensor,
                      start_pos: int, media: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Cache]:
        """Process one prompt chunk against the running lane cache, updated
        IN PLACE: tokens [B, C] at absolute positions ``start_pos ..``,
        returns the last chunk token's logits (fp32 [B, V]) and the cache.
        Per layer the chunk's queries read the cache as it stands BEFORE
        the chunk's write plus the chunk's own keys (``chunk_attention``),
        then the chunk is written (``write_chunk``), so chunk after chunk
        this computes what ``prefill`` computes over the whole prompt, also
        once the prompt passes a sliding window. Chunk writes are dense
        slices: the offload/direct path. The VLM takes ``media`` on EVERY
        chunk (required): each cross layer projects its image K/V again and
        writes it, as the JAX package's ``chunk_prefill`` does."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, c = tokens.shape
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens, dtype)
        media = self._media(media) if self.is_vlm else None
        positions = (start_pos
                     + torch.arange(c, device=tokens.device)).expand(b, c)
        for i, blk, cb in self._stack():
            if cb is not None:
                x = self._cross_layer(cb, x, media, cache, i)
                continue
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
                    unload_mask: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step against the dense lane cache, updated IN PLACE.
        tokens [B], pos [B] -> logits [B, V] (fp32), cache. Each layer's new
        K/V row goes to ``cache_slots(pos)`` by direct scatter (the offload
        path); ``write_mask`` [B] False sends a slot's rows to the drop row
        ``cache_len``, so a retired slot never writes. Where each step
        writes is worked out once for all layers. No value is read on the
        host.

        With a staging ring in the cache (``kvcache.staged.add_ring``; the
        dense family, as in the JAX package) ``unload_mask`` [B] routes each
        sequence (None: all staged): True appends its rows to the ring (the
        unload path; the caller drains), False scatters them direct; every
        layer reads cache ∪ ring under ``staged.overlay_step``'s mask, and
        ``ring_commit`` records the staged slots. The VLM's cross layers
        read their image K/V through ``flash_decode``, every token valid."""
        cfg = self.cfg
        has_ring = "ring_k" in cache
        if has_ring and self.is_vlm:
            raise NotImplementedError(
                "staging-ring KV overlay is wired for the dense family; "
                "VLM decode uses the direct path (DESIGN.md "
                "§Arch-applicability)")
        dtype = compute_dtype(cfg)
        b = tokens.shape[0]
        x = L.embed_tokens(cfg, self.embed.tensors(), tokens[:, None], dtype)
        clen = cache["k"].shape[2]
        slots = cache_slots(cfg, pos, clen)
        if write_mask is not None:
            slots = torch.where(write_mask, slots, clen)
        vmask = valid_mask(cfg, pos, clen)
        ring = None
        if has_ring:
            if unload_mask is None:
                unload_mask = torch.ones((b,), dtype=torch.bool,
                                         device=pos.device)
            if write_mask is not None:
                unload_mask = unload_mask & write_mask
            vmask, direct_slots, cur = ST.overlay_step(cache, vmask, slots,
                                                       unload_mask)
            plan = lane_write_plan(direct_slots, clen)
        else:
            plan = lane_write_plan(slots, clen)
        if self.is_vlm:
            cross_mask = torch.ones((b, cache["cross_k"].shape[2]),
                                    dtype=torch.bool, device=pos.device)
        for i, blk, cb in self._stack():
            if cb is not None:
                g_attn, g_mlp = cb.gates(dtype)
                x = attend_cross_decode(
                    cfg, cb.ln1.tensors(), cb.attn.tensors(dtype), x, pos,
                    cache["cross_k"][i], cache["cross_v"][i], cross_mask,
                    gate=g_attn)
                x = x + g_mlp * dense_ffn(cfg, cb.ln2.tensors(),
                                          cb.mlp.tensors(dtype), x)
                continue
            if has_ring:
                ring = (cache["ring_k"][i], cache["ring_v"][i], cur)
            x = attend_decode(cfg, blk.ln1.tensors(), blk.attn.tensors(dtype),
                              x, pos, cache["k"][i], cache["v"][i], plan,
                              vmask, ring=ring)
            x = x + self._ffn(blk, x)
        if has_ring:
            ST.ring_commit(cache, slots, unload_mask)
        x = L.apply_norm(cfg, self.ln_f.tensors(), x)
        logits = L.lm_logits(cfg, self.embed.tensors(), x)[:, 0]
        return logits, cache

    # -- decode (paged pool) -----------------------------------------------
    def _refuse_paged(self) -> None:
        if self.is_vlm:
            raise NotImplementedError(
                "paged KV decode covers linear-addressed dense caches; "
                "SWA/VLM serve from dense lanes (DESIGN.md "
                "§Arch-applicability)")

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
        read on the host. The VLM refuses, as in the JAX package (it serves
        from lanes)."""
        cfg = self.cfg
        self._refuse_paged()
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
        speculative verify reads). No value is read on the host. The VLM
        refuses, as in the JAX package."""
        cfg = self.cfg
        self._refuse_paged()
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
