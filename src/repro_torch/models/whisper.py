"""Port of repro/models/whisper.py: the encoder-decoder family (whisper).

The audio frontend is a STUB, as in the JAX package: a request's media are
precomputed frame embeddings ``[B, F, D]``. The backbone is whole: an
encoder of ``n_enc_layers`` ``DenseBlock``\\ s over the frames (learned frame
positions ``enc_pos``), and a decoder of ``n_layers`` ``DecoderBlock``\\ s
(self-attention, cross-attention over the encoder's output, a GELU MLP, all
pre-LayerNorm) with learned token positions ``dec_pos``; no rotary anywhere.

The encoder's self-attention is CAUSAL, because the reference computes it so:
its encoder calls ``layers.attention`` with no mask and no ``kv_x``, which
masks causally, though its docstring calls the encoder bidirectional. The
port follows the reference's code (ROADMAP.md, "Known differences").

``WhisperModel`` has ``DecoderLM``'s serving API: ``init(seed)``,
``init_cache``, ``prefill(tokens, max_seq, media=...)``, the lanes
``chunk_prefill(cache, tokens, start_pos, media=None)`` and
``decode_step(cache, tokens, pos, write_mask=None)``, the cache updated IN
PLACE. The cache has two kinds of leaves, batch on axis 1: ``k`` / ``v``
``[L, B, max_seq, H, Dh]`` grow with every decode write (the write path),
``cross_k`` / ``cross_v`` ``[L, B, n_audio_frames, H, Dh]`` are written once,
at admission, from the encoder, and no decode write touches them.

Every attention runs through the hand-written kernels: the encoder (causal),
the decoder's prompt (causal) and the cross-attention of a prompt or a
chunk (non-causal, its queries against every frame) through
``flash_attention`` (K3); a decode step's self and cross reads through
``flash_decode`` (K4, the cross read under an all-true mask). The cross
reads are ``transformer.attend_cross`` / ``attend_cross_decode``, which the
VLM's gated cross layers share.

``forward`` / ``loss`` (training) run the encoder and the decoder under
autograd, every attention through K3 (``FlashAttentionFunction``, its
backward the hand-written ``flash_attention_bwd``): the causal encoder, each
decoder layer's causal self-attention and its non-causal cross read of the
encoder's output, the cross K/V projected inside the layer, so the encoder's
gradient sums over every decoder layer. Under ``remat`` each encoder and
each decoder layer is checkpointed, as in the reference. ``loss`` needs
``batch["media"]``: without it it raises prefill's ``ValueError`` (the
reference fails there with a ``KeyError``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ENCDEC, ModelConfig
from ..core.paths import resolve_device
from . import layers as L
from .transformer import (DenseBlock, attend_chunk, attend_cross,
                          attend_cross_decode, attend_decode, attend_prefill,
                          batch_loss, cache_slots, compute_dtype, dense_ffn,
                          lane_write_plan, remat_call, valid_mask)

Cache = Dict[str, torch.Tensor]


def check_frames(cfg, frames) -> None:
    """Raise unless ``frames`` are given: whisper's encoder reads every
    request's frames (on one device and on a mesh alike)."""
    if frames is None:
        raise ValueError(
            f"{cfg.name} takes media: every request needs its frames "
            f"[{cfg.n_audio_frames}, {cfg.d_model}]")


class DecoderBlock(nn.Module):
    """One decoder layer's parameter groups, in the JAX package's names."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.self_attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.cross_attn = L.Attention(cfg, device)
        self.ln3 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.self_attn.init_(cfg, gen)
        self.cross_attn.init_(cfg, gen)
        self.mlp.init_(cfg, gen)


class WhisperModel(nn.Module):
    """Encoder-decoder backbone. Parameters are fp32 masters on ``device``
    (the GPU unless the caller asks for the CPU); activations and both
    caches use ``cfg.dtype``. ``dec_pos`` has ``max(cfg.max_position,
    max_seq)`` rows, as the reference's ``init(key, max_seq)`` makes it."""

    family = ENCDEC

    def __init__(self, cfg: ModelConfig, device="cuda", max_seq: int = 0):
        super().__init__()
        if cfg.family != self.family:
            raise NotImplementedError(
                f"not ported yet: {cfg.name} (family {cfg.family!r}) in "
                f"{type(self).__name__}, which takes the {self.family!r} "
                f"family")
        device = resolve_device(device)
        self.cfg = cfg
        self.is_vlm = False
        self.device = device
        d = cfg.d_model

        def table(rows):
            return nn.Parameter(torch.zeros((rows, d), dtype=torch.float32,
                                            device=device),
                                requires_grad=False)

        self.embed = L.Embed(cfg, device)
        self.enc_pos = table(cfg.n_audio_frames)
        self.dec_pos = table(max(cfg.max_position, max_seq))
        self.enc_blocks = nn.ModuleList(
            DenseBlock(cfg, device) for _ in range(cfg.n_enc_layers))
        self.ln_enc = L.Norm(cfg, device)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg, device) for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg, device)

    def init(self, seed: int = 0) -> "WhisperModel":
        """Random weights with the JAX package's scales (positions N(0,
        0.01)), from ``seed`` (to compare with the JAX package carry its
        weights across with ``checkpoint.params_from_numpy``)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.init_(self.cfg, gen)
        with torch.no_grad():
            for t in (self.enc_pos, self.dec_pos):
                t.copy_(L._normal(t.shape, 0.01, gen, self.device))
        for blk in list(self.enc_blocks) + list(self.dec_blocks):
            blk.init_(self.cfg, gen)
        return self

    # -- full forward (training) -------------------------------------------
    def forward(self, tokens: torch.Tensor, media=None,
                remat: bool = False) -> torch.Tensor:
        """tokens [B, S] and media (the frames [B, F, D]) -> logits fp32
        [B, S, V]: the encoder, then the decoder over the tokens plus
        ``dec_pos[:S]``, ``ln_f``, the fp32 head. Differentiable: the
        training path."""
        enc_out = self._encode(media, remat)
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens, self.dec_pos[:tokens.shape[1]])
        for blk in self.dec_blocks:
            x = remat_call(remat, self._dec_layer, x, enc_out, blk)
        x = L.apply_norm(self.cfg, self.ln_f.tensors(), x)
        return L.lm_logits(self.cfg, self.embed.tensors(), x)

    def loss(self, batch, remat: bool = True) -> torch.Tensor:
        """Mean token cross-entropy of ``batch`` (``tokens``, ``labels``,
        ``media``, optional ``loss_mask``), fp32 scalar."""
        logits = self.forward(batch["tokens"], batch.get("media"), remat)
        return batch_loss(logits, batch, self.device)

    def _dec_layer(self, x: torch.Tensor, enc_out: torch.Tensor,
                   blk: DecoderBlock, cache: Optional[Cache] = None,
                   i: int = 0) -> torch.Tensor:
        """Decoder layer ``i`` over a whole sequence (a prompt): causal
        self-attention (no rotary), the cross read of ``enc_out`` (its K/V
        projected here), the MLP; with a ``cache``, the prompt's K/V and
        the cross K/V written into layer ``i``'s leaves."""
        cfg, dtype = self.cfg, x.dtype
        kc, vc = (None, None) if cache is None else (cache["k"][i],
                                                     cache["v"][i])
        x = attend_prefill(cfg, blk.ln1.tensors(),
                           blk.self_attn.tensors(dtype), x, None, kc, vc,
                           use_rope=False)
        ck, cv = self._cross_kv(blk, enc_out)
        if cache is not None:
            cache["cross_k"][i], cache["cross_v"][i] = ck, cv
        x = attend_cross(cfg, blk.ln2.tensors(), blk.cross_attn.tensors(dtype),
                         x, ck, cv)
        return x + dense_ffn(cfg, blk.ln3.tensors(), blk.mlp.tensors(dtype), x)

    # -- shared pieces -----------------------------------------------------
    def _embed(self, tokens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Token embeddings [B, S, D] plus the learned positions ``rows``
        ([S, D] or [B, S, D]), in the compute dtype."""
        dtype = compute_dtype(self.cfg)
        x = L.embed_tokens(self.cfg, self.embed.tensors(), tokens, dtype)
        return x + rows.to(dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(self.cfg, self.ln_f.tensors(), x[:, -1:])
        return L.lm_logits(self.cfg, self.embed.tensors(), x)[:, 0]

    def _chunk_rows(self, start_pos: int, c: int) -> torch.Tensor:
        """``dec_pos`` rows ``start_pos .. + c``, the start clamped so the
        rows stay in the table (the reference's ``dynamic_slice``)."""
        s0 = max(0, min(int(start_pos), self.dec_pos.shape[0] - c))
        return self.dec_pos[s0:s0 + c]

    def _decode_rows(self, pos: torch.Tensor) -> torch.Tensor:
        """``dec_pos[pos]`` [B, D]; a position past the table gives NaN, as
        the reference's ``take`` fills it. No value is read on the host."""
        n = self.dec_pos.shape[0]
        rows = self.dec_pos[pos.clamp(0, n - 1)]
        return torch.where((pos < n)[:, None], rows,
                           torch.full_like(rows, float("nan")))

    def _cross_kv(self, blk: DecoderBlock, enc_out: torch.Tensor):
        return L.project_kv(self.cfg, blk.cross_attn.tensors(enc_out.dtype),
                            enc_out, None)

    # -- encoder -----------------------------------------------------------
    @torch.no_grad()
    def encode(self, frames: Optional[torch.Tensor]) -> torch.Tensor:
        """frames [B, F, D] stub embeddings -> encoder output [B, F, D] in
        the compute dtype (serving: no graph)."""
        return self._encode(frames)

    def _encode(self, frames: Optional[torch.Tensor],
                remat: bool = False) -> torch.Tensor:
        """The encoder, differentiable. The frames are cast to the compute
        dtype BEFORE ``enc_pos`` is added, as the reference does. Each
        layer's self-attention is causal (``layers.attention`` without
        ``kv_x``); under ``remat`` each layer is checkpointed."""
        cfg = self.cfg
        check_frames(cfg, frames)
        dtype = compute_dtype(cfg)
        frames = torch.as_tensor(frames, device=self.device)
        x = frames.to(dtype) + self.enc_pos.to(dtype)[None, :frames.shape[1]]
        for blk in self.enc_blocks:
            x = remat_call(remat, self._enc_layer, x, blk)
        return L.apply_norm(cfg, self.ln_enc.tensors(), x)

    def _enc_layer(self, x: torch.Tensor, blk: DenseBlock) -> torch.Tensor:
        cfg, dtype = self.cfg, x.dtype
        x = x + L.attention(cfg, blk.attn.tensors(dtype),
                            L.apply_norm(cfg, blk.ln1.tensors(), x),
                            None, use_rope=False)
        return x + dense_ffn(cfg, blk.ln2.tensors(), blk.mlp.tensors(dtype),
                             x)

    # -- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=None) -> Cache:
        cfg = self.cfg
        dims = L.attn_dims(cfg)
        dtype = dtype or compute_dtype(cfg)

        def mk(s):
            return torch.zeros((cfg.n_layers, batch, s, dims.n_kv_heads,
                                dims.head_dim), dtype=dtype,
                               device=self.device)
        return {"k": mk(max_seq), "v": mk(max_seq),
                "cross_k": mk(cfg.n_audio_frames),
                "cross_v": mk(cfg.n_audio_frames)}

    # -- prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int,
                media: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Cache]:
        """Encode the media, run the whole prompt; returns the last-token
        logits (fp32 [B, V]) and the cache: the prompt's K/V at slots
        ``0 .. S-1`` of ``max_seq`` and each layer's cross K/V."""
        enc_out = self.encode(media)
        b, s = tokens.shape
        x = self._embed(tokens, self.dec_pos[:s])
        cache = self.init_cache(b, max_seq, compute_dtype(self.cfg))
        for i, blk in enumerate(self.dec_blocks):
            x = self._dec_layer(x, enc_out, blk, cache, i)
        return self._logits(x), cache

    @torch.no_grad()
    def chunk_prefill(self, cache: Cache, tokens: torch.Tensor,
                      start_pos: int, media: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Cache]:
        """One prompt chunk, the cache updated IN PLACE. With ``media`` (the
        first chunk) the encoder runs and each layer's cross K/V is written;
        later chunks read it from the cache. Self-attention reads the lanes
        before the chunk plus the chunk's own keys (``attend_chunk``), then
        writes the chunk; cross-attention is one non-causal K3 read over
        every frame."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        b, c = tokens.shape
        x = self._embed(tokens, self._chunk_rows(start_pos, c))
        positions = (start_pos
                     + torch.arange(c, device=tokens.device)).expand(b, c)
        enc_out = self.encode(media) if media is not None else None
        for i, blk in enumerate(self.dec_blocks):
            x = attend_chunk(cfg, blk.ln1.tensors(),
                             blk.self_attn.tensors(dtype), x, positions,
                             cache["k"][i], cache["v"][i], start_pos,
                             use_rope=False)
            if enc_out is not None:
                ck, cv = self._cross_kv(blk, enc_out)
                cache["cross_k"][i].copy_(ck)
                cache["cross_v"][i].copy_(cv)
            x = attend_cross(cfg, blk.ln2.tensors(),
                             blk.cross_attn.tensors(dtype), x,
                             cache["cross_k"][i], cache["cross_v"][i])
            x = x + dense_ffn(cfg, blk.ln3.tensors(), blk.mlp.tensors(dtype),
                              x)
        return self._logits(x), cache

    # -- decode (dense lanes) ----------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step, the cache updated IN PLACE: tokens [B], pos [B]
        -> logits [B, V] (fp32). Each layer writes its new self K/V row at
        ``min(pos, S - 1)`` (``write_mask`` False sends a slot's rows to the
        drop row), reads the lanes through ``flash_decode``, then reads the
        cross K/V, every frame valid, through ``flash_decode``. No value is
        read on the host."""
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        x = self._embed(tokens[:, None], self._decode_rows(pos)[:, None])
        clen = cache["k"].shape[2]
        slots = cache_slots(cfg, pos, clen)
        if write_mask is not None:
            slots = torch.where(write_mask, slots, clen)
        plan = lane_write_plan(slots, clen)
        vmask = valid_mask(cfg, pos, clen)
        cross_mask = torch.ones((pos.shape[0], cache["cross_k"].shape[2]),
                                dtype=torch.bool, device=pos.device)
        for i, blk in enumerate(self.dec_blocks):
            x = attend_decode(cfg, blk.ln1.tensors(),
                              blk.self_attn.tensors(dtype), x, pos,
                              cache["k"][i], cache["v"][i], plan, vmask,
                              use_rope=False)
            x = attend_cross_decode(cfg, blk.ln2.tensors(),
                                    blk.cross_attn.tensors(dtype), x, pos,
                                    cache["cross_k"][i], cache["cross_v"][i],
                                    cross_mask)
            x = x + dense_ffn(cfg, blk.ln3.tensors(), blk.mlp.tensors(dtype),
                              x)
        return self._logits(x), cache


__all__ = ["DecoderBlock", "WhisperModel", "attend_cross", "check_frames"]
