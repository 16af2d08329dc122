"""Port of repro/models/ssm_lm.py: the SSM and hybrid language models.

* ``MambaLM``: mamba2-130m, a pure stack of SSD blocks (attention-free).
* ``ZambaLM``: zamba2-2.7b, the mamba2 trunk with ONE SHARED attention+MLP
  block (a ``DenseBlock``) applied every ``hybrid_attn_every`` layers; its
  weights are reused at every application, and each application keeps its
  OWN KV cache.

Both have ``DecoderLM``'s serving API, so the scheduler drives them alike:
``init(seed)``, ``init_cache``, ``prefill(tokens, max_seq)``, the lanes
``chunk_prefill(cache, tokens, start_pos)`` and ``decode_step(cache,
tokens, pos, write_mask=None)``, the cache updated IN PLACE. The cache
leaves keep the JAX package's layout, batch on axis 1: ``ssm [L, B, H, P,
N]``, ``conv [L, B, W-1, Ch]`` and, for zamba, ``k`` / ``v`` ``[n_groups,
B, S, Hkv, Dh]``. The recurrent state of a slot is slot-private: a decode
step updates it for every slot (as the JAX package does) and admission
overwrites it; ``write_mask`` gates only the shared block's KV writes.

The shared block's attention runs through the hand-written kernels, as the
dense model's does: prefill and each lanes chunk through
``flash_attention`` (K3), decode through ``flash_decode`` (K4). The SSD has
no kernel in the JAX package (``jnp`` code), so it is plain PyTorch here
(``models.mamba2``). ``forward`` / ``loss`` (training) run the whole
sequence under autograd: the SSD's plain PyTorch, the shared block's
attention through K3 (``FlashAttentionFunction``, its backward the
hand-written ``flash_attention_bwd``). Under ``remat`` each mamba layer is
checkpointed and, in zamba, each group too (the mamba layers checkpointed
inside it), as the reference nests ``jax.checkpoint``: a zamba mamba layer
runs three times in a step, the shared block twice an application.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import HYBRID, SSM, ModelConfig
from ..core.paths import resolve_device
from . import layers as L
from . import mamba2 as M
from .transformer import (DenseBlock, attend_chunk, attend_decode,
                          attend_prefill, batch_loss, cache_slots,
                          compute_dtype, dense_ffn, lane_write_plan,
                          remat_call, valid_mask)

Cache = Dict[str, torch.Tensor]


class MambaLM(nn.Module):
    """Pure SSD stack (mamba2). Parameters are fp32 masters on ``device``
    (the GPU unless the caller asks for the CPU); activations and the
    recurrent state use ``cfg.dtype``."""

    family = SSM

    def __init__(self, cfg: ModelConfig, device="cuda"):
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
        self.embed = L.Embed(cfg, device)
        self.ln_f = L.Norm(cfg, device)
        self.blocks = nn.ModuleList(M.MambaBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    def init(self, seed: int = 0):
        """Random weights with the JAX package's scales, from ``seed`` (to
        compare with the JAX package carry its weights across with
        ``checkpoint.params_from_numpy``)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.init_(self.cfg, gen)
        for blk in self._init_order():
            blk.init_(self.cfg, gen)
        return self

    def _init_order(self):
        return list(self.blocks)

    # -- full forward (training) -------------------------------------------
    def forward(self, tokens: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """tokens [B, S] -> logits fp32 [B, S, V] over the whole sequence:
        embed in the compute dtype, the trunk, ``ln_f``, the fp32 head (the
        embedding itself where tied, so its gradient sums both uses).
        Differentiable: the training path."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._trunk(self._embed(tokens), remat)
        x = L.apply_norm(self.cfg, self.ln_f.tensors(), x)
        return L.lm_logits(self.cfg, self.embed.tensors(), x)

    def loss(self, batch, remat: bool = True) -> torch.Tensor:
        """Mean token cross-entropy of ``batch`` (``tokens``, ``labels``,
        optional ``loss_mask``), fp32 scalar."""
        return batch_loss(self.forward(batch["tokens"], remat=remat), batch,
                          self.device)

    def _layer(self, x: torch.Tensor, blk: M.MambaBlock) -> torch.Tensor:
        """One mamba layer over a whole sequence, its weights cast at this
        use (inside autograd while training)."""
        return M.mamba_block(self.cfg, blk.params(compute_dtype(self.cfg)),
                             x)[0]

    def _trunk(self, x: torch.Tensor, remat: bool) -> torch.Tensor:
        for blk in self.blocks:
            x = remat_call(remat, self._layer, x, blk)
        return x

    # -- shared pieces -----------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_tokens(self.cfg, self.embed.tensors(), tokens,
                              compute_dtype(self.cfg))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits [B, V] of the last position of x [B, S, D]."""
        x = L.apply_norm(self.cfg, self.ln_f.tensors(), x[:, -1:])
        return L.lm_logits(self.cfg, self.embed.tensors(), x)[:, 0]

    def _block_params(self):
        dtype = compute_dtype(self.cfg)
        return [blk.params(dtype) for blk in self.blocks]

    # -- recurrent cache ---------------------------------------------------
    def init_cache(self, batch: int, max_seq: int = 0, dtype=None) -> Cache:
        cfg = self.cfg
        per_layer = M.init_mamba_state(cfg, batch, dtype or compute_dtype(cfg),
                                       self.device)
        return {k: torch.zeros((cfg.n_layers,) + a.shape, dtype=a.dtype,
                               device=self.device)
                for k, a in per_layer.items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                max_seq: int = 0) -> Tuple[torch.Tensor, Cache]:
        """Run the whole prompt; returns the last-token logits (fp32
        [B, V]) and the recurrent cache (every layer's final state and
        pre-conv tail)."""
        x = self._embed(tokens)
        ssm: List[torch.Tensor] = []
        conv: List[torch.Tensor] = []
        for p in self._block_params():
            x, st, tail = M.mamba_block(self.cfg, p, x)
            ssm.append(st)
            conv.append(tail)
        return self._logits(x), {"ssm": torch.stack(ssm),
                                 "conv": torch.stack(conv)}

    @torch.no_grad()
    def chunk_prefill(self, cache: Cache, tokens: torch.Tensor,
                      start_pos: int) -> Tuple[torch.Tensor, Cache]:
        """One prompt chunk, carrying the recurrent state in and out (SSM
        prefill is chunkable by nature); the cache is updated IN PLACE."""
        x = self._embed(tokens)
        for i, p in enumerate(self._block_params()):
            x, st, tail = M.mamba_block_chunk(self.cfg, p, x,
                                              cache["ssm"][i],
                                              cache["conv"][i])
            cache["ssm"][i].copy_(st)
            cache["conv"][i].copy_(tail)
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step, the cache updated IN PLACE: tokens [B], pos [B]
        -> logits [B, V] (fp32). Every slot's state advances (slot-private,
        as in the JAX package); ``write_mask`` has nothing to gate here."""
        x = self._embed(tokens[:, None])[:, 0]
        for i, p in enumerate(self._block_params()):
            x, st, tail = M.mamba_decode_step(self.cfg, p, x,
                                              cache["ssm"][i],
                                              cache["conv"][i])
            cache["ssm"][i].copy_(st)
            cache["conv"][i].copy_(tail)
        return self._logits(x[:, None]), cache


class ZambaLM(MambaLM):
    """Zamba2-style hybrid: the mamba2 trunk and one shared attention
    block (``shared``, a ``DenseBlock``) after every ``hybrid_attn_every``
    mamba layers; application ``g`` reads and writes its own ``k[g]`` /
    ``v[g]`` lanes."""

    family = HYBRID

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__(cfg, device)
        if cfg.hybrid_attn_every <= 0 or cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(
                f"{cfg.name}: n_layers {cfg.n_layers} must be a multiple of "
                f"hybrid_attn_every {cfg.hybrid_attn_every} > 0")
        self.n_groups = cfg.n_layers // cfg.hybrid_attn_every
        self.per_group = cfg.hybrid_attn_every
        self.shared = DenseBlock(cfg, self.device)  # ONE shared block

    def _init_order(self):
        return list(self.blocks) + [self.shared]

    def _groups(self):
        """(group index, [(layer index, block params)]) over the trunk."""
        ps = self._block_params()
        for g in range(self.n_groups):
            ids = range(g * self.per_group, (g + 1) * self.per_group)
            yield g, [(i, ps[i]) for i in ids]

    def _shared_params(self):
        sh, dtype = self.shared, compute_dtype(self.cfg)
        return (sh.ln1.tensors(), sh.attn.tensors(dtype), sh.ln2.tensors(),
                sh.mlp.tensors(dtype))

    def _group(self, x: torch.Tensor, positions: torch.Tensor, g: int,
               remat: bool) -> torch.Tensor:
        """Group ``g`` over a whole sequence: its mamba layers (each
        checkpointed under ``remat``), then the shared block over a causal
        mask, its attention through K3."""
        for blk in self.blocks[g * self.per_group:(g + 1) * self.per_group]:
            x = remat_call(remat, self._layer, x, blk)
        ln1, pa, ln2, pm = self._shared_params()
        x = attend_prefill(self.cfg, ln1, pa, x, positions)
        return x + dense_ffn(self.cfg, ln2, pm, x)

    def _trunk(self, x: torch.Tensor, remat: bool) -> torch.Tensor:
        """The groups in order, each checkpointed under ``remat`` (the
        shared block's gradient sums over its applications)."""
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        for g in range(self.n_groups):
            x = remat_call(remat, self._group, x, positions, g, remat)
        return x

    # -- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=None) -> Cache:
        cfg = self.cfg
        dims = L.attn_dims(cfg)
        dtype = dtype or compute_dtype(cfg)
        cache = super().init_cache(batch, max_seq, dtype)
        shape = (self.n_groups, batch, max_seq, dims.n_kv_heads,
                 dims.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=self.device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=self.device)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                max_seq: int) -> Tuple[torch.Tensor, Cache]:
        """Whole-prompt prefill: the trunk's states and tails, and each
        application's prompt KV at slots ``0 .. S-1`` of ``max_seq``. The
        shared block attends through ``flash_attention``."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        ln1, pa, ln2, pm = self._shared_params()
        cache = self.init_cache(b, max_seq, x.dtype)
        ssm, conv = [], []
        for g, layers in self._groups():
            for _, p in layers:
                x, st, tail = M.mamba_block(cfg, p, x)
                ssm.append(st)
                conv.append(tail)
            x = attend_prefill(cfg, ln1, pa, x, positions, cache["k"][g],
                               cache["v"][g])
            x = x + dense_ffn(cfg, ln2, pm, x)
        cache["ssm"] = torch.stack(ssm)
        cache["conv"] = torch.stack(conv)
        return self._logits(x), cache

    @torch.no_grad()
    def chunk_prefill(self, cache: Cache, tokens: torch.Tensor,
                      start_pos: int) -> Tuple[torch.Tensor, Cache]:
        """One prompt chunk, IN PLACE: the trunk's states carried per
        layer; each application reads its KV lanes as they stand before
        the chunk plus the chunk's own keys (``chunk_attention``, through
        ``flash_attention``), then writes the chunk (``write_chunk``)."""
        cfg = self.cfg
        b, c = tokens.shape
        x = self._embed(tokens)
        positions = (start_pos
                     + torch.arange(c, device=tokens.device)).expand(b, c)
        ln1, pa, ln2, pm = self._shared_params()
        for g, layers in self._groups():
            for i, p in layers:
                x, st, tail = M.mamba_block_chunk(cfg, p, x, cache["ssm"][i],
                                                  cache["conv"][i])
                cache["ssm"][i].copy_(st)
                cache["conv"][i].copy_(tail)
            x = attend_chunk(cfg, ln1, pa, x, positions, cache["k"][g],
                             cache["v"][g], start_pos)
            x = x + dense_ffn(cfg, ln2, pm, x)
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    pos: torch.Tensor,
                    write_mask: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step, IN PLACE: every slot's trunk state advances;
        each application writes its new K/V row at ``min(pos, S - 1)`` of
        its lanes (``write_mask`` False sends a slot's rows to the drop row)
        and reads them through ``flash_decode``."""
        cfg = self.cfg
        x = self._embed(tokens[:, None])[:, 0]
        ln1, pa, ln2, pm = self._shared_params()
        clen = cache["k"].shape[2]
        slots = cache_slots(cfg, pos, clen)
        if write_mask is not None:
            slots = torch.where(write_mask, slots, clen)
        plan = lane_write_plan(slots, clen)
        vmask = valid_mask(cfg, pos, clen)
        for g, layers in self._groups():
            for i, p in layers:
                x, st, tail = M.mamba_decode_step(cfg, p, x, cache["ssm"][i],
                                                  cache["conv"][i])
                cache["ssm"][i].copy_(st)
                cache["conv"][i].copy_(tail)
            h = attend_decode(cfg, ln1, pa, x[:, None], pos, cache["k"][g],
                              cache["v"][g], plan, vmask)
            x = (h + dense_ffn(cfg, ln2, pm, h))[:, 0]
        return self._logits(x[:, None]), cache


__all__ = ["MambaLM", "ZambaLM"]
