"""Port of repro/models/layers.py (the dense serving path's share).

Shared model building blocks: norms, rotary (with partial-rotary support),
GQA attention with optional QKV bias, and the SwiGLU / squared-ReLU / GELU
MLPs. The functions are pure functions over explicit parameter mappings
(``p["wq"]`` ...), in the JAX package's layouts, so each can be held against
its counterpart on the same numpy inputs; the ``nn.Module`` classes below
own the parameters and hand those mappings out.

Conventions
-----------
* Activations: [B, S, D]. Attention heads: q [B, S, Hq, Dh]; kv [B, S, Hkv,
  Dh] (GQA: Hq % Hkv == 0).
* Softmax and norms accumulate in float32 regardless of compute dtype;
  masked logits are -1e30 (never -inf), so an all-masked row is a finite
  uniform softmax.
* Parameters are fp32 masters. Where the JAX package casts a weight to the
  compute type at each use (``.astype(dtype)``), the modules here keep one
  compute-type copy cast once (``tensors(dtype)``): same values, no cast per
  step. The functions still call ``.to(dtype)``, a no-op on such a copy.
  Training (``set_trainable(model)``: ``requires_grad`` on the masters)
  casts at each use instead, inside autograd, as the JAX package does, so
  the gradient reaches the fp32 master; the serving path (under
  ``no_grad``) keeps its cached copy, which ``drop_casts(model)`` discards
  after every optimizer step so that serving reads the new weights.

The attention cores run through the hand-written kernels: prefill through
``flash_attention`` (causal, sliding window, GQA by index), decode through
``flash_decode`` (dense KV set, one launch per query column of a chunk) or
``flash_decode_paged`` (the paged pool); the lanes layout's chunked prefill
reads through ``flash_attention`` too (``chunk_attention``). On a CPU tensor
each runs its plain version, which keeps the JAX package's ``_sdpa_once`` op
order (fp32 logits, -1e30 mask, fp32 softmax, cast to ``q.dtype``, then
P.V).

Under grad mode ``attention_core`` runs K3 through
``FlashAttentionFunction`` (its backward the hand-written
``flash_attention_bwd``); ``cross_entropy_loss`` is the training loss.

Under a mesh (the sharded train step, ``models.parallel``), each piece is a
function on one device's tensors plus an explicit collective of
``distributed.collectives``: ``pad_to_multiple`` / ``pad_axis`` (the TP
padding of heads, vocab and experts with zeros, JAX's ``_tp_head_pad``),
``shard_batch`` (each device's rows), ``embed_tokens_sharded`` (the lookup
on a ``tok`` split on D, then D gathered over ``model``),
``lm_logits_sharded`` (each device's vocab lanes, the padded ones at -1e30)
and ``vocab_parallel_nll`` (the cross entropy over logits split on their
vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..configs.base import (GELU, LAYERNORM, RMSNORM, SQUARED_RELU, SWIGLU,
                            ModelConfig)

Tensors = Mapping[str, torch.Tensor]


class ParamGroup(nn.Module):
    """A bag of named fp32 master parameters in the JAX package's layout.
    ``tensors(dtype)`` is the mapping the layer functions consume: the
    masters themselves for float32; else, while grad mode is on and the
    masters require grad (training), a cast made at this use inside
    autograd; else a copy cast ONCE and kept (serving)."""

    def __init__(self, shapes: Dict[str, tuple], device):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device),
                requires_grad=False))
        self._cast: Dict[torch.dtype, Dict[str, torch.Tensor]] = {}

    def tensors(self, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        if dtype == torch.float32:
            return dict(self.named_parameters(recurse=False))
        own = dict(self.named_parameters(recurse=False))
        if torch.is_grad_enabled() and any(v.requires_grad
                                           for v in own.values()):
            return {k: v.to(dtype) for k, v in own.items()}
        if dtype not in self._cast:
            self._cast[dtype] = {
                k: v.detach().to(dtype)
                for k, v in self.named_parameters(recurse=False)}
        return self._cast[dtype]

    def load(self, values: Mapping[str, torch.Tensor]) -> None:
        """Overwrite the masters (and drop any compute-type copy)."""
        own = dict(self.named_parameters(recurse=False))
        if set(values) != set(own):
            raise KeyError(f"parameter names differ: got {sorted(values)}, "
                           f"want {sorted(own)}")
        with torch.no_grad():
            for k, v in values.items():
                if tuple(v.shape) != tuple(own[k].shape):
                    raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                     f"{tuple(own[k].shape)}")
                own[k].copy_(v)
        self._cast.clear()


def set_trainable(model: nn.Module, trainable: bool = True) -> nn.Module:
    """Training mode: ``requires_grad`` on every fp32 master of ``model``
    (its ``ParamGroup``s then cast at each use under grad mode); ``False``
    turns it off again. Returns ``model``."""
    for p in model.parameters():
        p.requires_grad_(trainable)
    return model


def drop_casts(model: nn.Module) -> None:
    """Discard every cached compute-type copy of ``model``'s masters (after an
    optimizer step changed them in place): the next serving call casts the
    new values."""
    for m in model.modules():
        if isinstance(m, ParamGroup):
            m._cast.clear()


def _normal(shape, scale: float, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(ParamGroup):
    def __init__(self, cfg: ModelConfig, device, d: Optional[int] = None):
        d = d or cfg.d_model
        shapes = {"scale": (d,)}
        if cfg.norm == LAYERNORM:
            shapes["bias"] = (d,)
        super().__init__(shapes, device)
        with torch.no_grad():
            self.scale.fill_(1.0)


def apply_norm(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == RMSNORM:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    elif cfg.norm == LAYERNORM:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(cfg.norm)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support)
# ---------------------------------------------------------------------------


def rope_frequencies(cfg: ModelConfig, head_dim: int,
                     device="cpu") -> torch.Tensor:
    """inv_freq [rot_half] for the rotated fraction of the head dim."""
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    if rot == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    exponent = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=device) / rot
    return 1.0 / (cfg.rope_theta ** exponent)


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate INTERLEAVED pairs ([::2], [1::2]) of the first
    ``rope_fraction`` of the head dim. x: [B, S, H, Dh]; positions: [B, S]
    absolute token positions."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(cfg, head_dim, x.device)
    rot = 2 * inv_freq.shape[0]
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions.float()[..., None] * inv_freq  # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    if x_pass.shape[-1]:
        return torch.cat([rotated, x_pass], dim=-1)
    return rotated


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


def attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


class Attention(ParamGroup):
    """GQA attention parameters; the head axis stays explicit
    (wq [D, Hq, Dh], wk/wv [D, Hkv, Dh], wo [Hq, Dh, D])."""

    def __init__(self, cfg: ModelConfig, device):
        dims = attn_dims(cfg)
        d, hq, hkv, hd = (cfg.d_model, dims.n_heads, dims.n_kv_heads,
                          dims.head_dim)
        shapes = {"wq": (d, hq, hd), "wk": (d, hkv, hd), "wv": (d, hkv, hd),
                  "wo": (hq, hd, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(hq, hd), bk=(hkv, hd), bv=(hkv, hd))
        super().__init__(shapes, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        d, dev = cfg.d_model, self.wq.device
        hq, hd = self.wq.shape[1:]
        with torch.no_grad():
            for name in ("wq", "wk", "wv"):
                w = getattr(self, name)
                w.copy_(_normal(w.shape, d ** -0.5, gen, dev))
            self.wo.copy_(_normal(self.wo.shape, (hq * hd) ** -0.5, gen, dev))
        self._cast.clear()


def _qkv(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
         kv_x: Optional[torch.Tensor] = None):
    """Project to q, k, v. ``kv_x`` (if given) is the cross-attention source."""
    dtype = x.dtype
    kv_src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    k = torch.einsum("btd,dhk->bthk", kv_src, p["wk"].to(dtype))
    v = torch.einsum("btd,dhk->bthk", kv_src, p["wv"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return q, k, v


def attention_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Prefill attention core: q ``[B, S, Hq, Dh]`` against k/v
    ``[B, T, Hkv, Dh]`` -> ``[B, S, Hq, Dh]`` through ``flash_attention``
    (its plain version on a CPU tensor), causal with the model's sliding
    window, GQA by index. The tensors go in transposed, without a copy.
    Under grad mode, with an operand that requires grad, the call is
    ``FlashAttentionFunction`` (K3 saving its ``lse``; its backward the
    hand-written ``flash_attention_bwd``)."""
    from ..kernels import FlashAttentionFunction, flash_attention

    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            cfg.sliding_window if causal else 0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(*args).transpose(1, 2)
    return flash_attention(*args).transpose(1, 2)


def attention(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
              positions: torch.Tensor, *,
              kv_x: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full (prefill) attention. Causal (with the sliding window) unless
    ``kv_x`` given."""
    q, k, v = _qkv(cfg, p, x, kv_x)
    if use_rope and kv_x is None:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    out = attention_core(cfg, q, k, v, causal=kv_x is None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def project_q(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
              positions: Optional[torch.Tensor],
              use_rope: bool = True) -> torch.Tensor:
    """Query projection (+ bias + RoPE) for decode-time attention: THE one q
    path shared by the plain attention cores and the fused read kernel."""
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
    if use_rope:
        q = apply_rope(cfg, q, positions)
    return q


def decode_attention(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                     pos: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len_mask: torch.Tensor,
                     use_rope: bool = True) -> torch.Tensor:
    """One-token decode against a KV set through ``flash_decode`` (its plain
    version on a CPU tensor). x: [B, 1, D]; pos: [B]; k_cache/v_cache:
    [B, S, Hkv, Dh], already holding the new token's kv, GQA un-repeated;
    kv_len_mask: bool [B, S]."""
    from ..kernels import flash_decode

    q = project_q(cfg, p, x, pos[:, None], use_rope)
    out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, kv_len_mask)
    return torch.einsum("bhk,hkd->bd", out, p["wo"].to(x.dtype))[:, None]


def masked_chunk_attention(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                           positions: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, mask: torch.Tensor,
                           use_rope: bool = True) -> torch.Tensor:
    """Chunk queries against a gathered KV set with an EXPLICIT mask: the
    mixed-phase step's reference read. x: [B, C, D]; positions: [B, C];
    k_cache/v_cache: [B, T, Hkv, Dh]; mask: bool [B, C, T]. Each query
    column is one ``flash_decode`` call over the same KV set (its plain
    version on a CPU tensor), so with C = 1 this is :func:`decode_attention`."""
    from ..kernels import flash_decode

    q = project_q(cfg, p, x, positions, use_rope)   # [B, C, Hq, Dh]
    out = torch.stack([
        flash_decode(q[:, j].contiguous(), k_cache, v_cache, mask[:, j])
        for j in range(q.shape[1])], dim=1)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def fused_paged_attention(
    cfg: ModelConfig, p: Tensors,
    x: torch.Tensor,          # [B, C, D] normed activations (C=1 for step)
    positions: torch.Tensor,  # [B, C] absolute query positions
    pages_k: torch.Tensor,    # [n_blocks, ps, Hkv, Dh] physical pool (layer)
    pages_v: torch.Tensor,
    blocks: torch.Tensor,     # int32 [B, P] clamped physical block ids
    view_ok: torch.Tensor,    # bool [B, C, P*ps]
    ring_k: Optional[torch.Tensor] = None,   # [B, R, Hkv, Dh] staging lanes
    ring_v: Optional[torch.Tensor] = None,
    ring_ok: Optional[torch.Tensor] = None,  # bool [B, R]
    use_rope: bool = True,
) -> torch.Tensor:
    """Decode attention through the ``flash_decode_paged`` read kernel: it
    walks the page table and overlays the staging ring inside one softmax,
    so no gathered view is materialized. Projections and the output einsum
    are shared with the plain cores. Under a mesh (the pool and ring planes
    are ``ShardedTensor`` pieces split on their head axis) the read is
    ``flash_decode_paged_sharded``: one K2 launch per device, its grid over
    the shards there (on distinct cards the heads are joined on the lead
    device)."""
    from ..distributed.sharding import ShardedTensor
    from ..kernels import flash_decode_paged, flash_decode_paged_sharded

    q = project_q(cfg, p, x, positions, use_rope)   # [B, C, Hq, Dh]
    if isinstance(pages_k, ShardedTensor):
        out = flash_decode_paged_sharded(
            pages_k.mesh, q, pages_k, pages_v, blocks, view_ok, ring_k,
            ring_v, ring_ok, axis=pages_k.mesh_axis or "model")
    else:
        out = flash_decode_paged(q, pages_k, pages_v, blocks, view_ok,
                                 ring_k, ring_v, ring_ok)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def slot_positions(clen: int, last_pos: int,
                   device="cpu") -> torch.Tensor:
    """int [clen]: the absolute position held in each slot of a (ring)
    cache after writing ``last_pos``; negative = not written yet. Linear
    caches (slot = position) and sliding-window rings (slot = position %
    clen) alike."""
    s = torch.arange(clen, device=device)
    return last_pos - ((last_pos % clen - s) % clen)


def chunk_attention(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                    positions: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, start_pos: int,
                    use_rope: bool = True) -> torch.Tensor:
    """Chunked-prefill attention: the C queries of a chunk at absolute
    positions ``start_pos ..`` against the cache as it stands BEFORE the
    chunk's write, plus the chunk's own keys. x: [B, C, D]; k_cache/v_cache:
    [B, clen, Hkv, Dh] (a ring under a sliding window); k_new/v_new: [B, C,
    Hkv, Dh]. The cache's written slots are unrolled to position order (a
    roll by the ring's phase), the chunk appended, and ``flash_attention``
    reads them causally with the model's window, the queries at the end of
    the key stream. So every key the window allows is read even where the
    chunk's own write will overwrite it in the ring: this is what
    ``prefill`` computes over the whole prompt."""
    clen = k_cache.shape[1]
    n_prev = min(start_pos, clen)
    shift = -(start_pos % clen) if start_pos > clen else 0

    def stream(cache, new):
        prev = cache[:, :n_prev] if not shift else torch.roll(cache, shift, 1)
        return torch.cat([prev, new.to(cache.dtype)], dim=1)

    q = project_q(cfg, p, x, positions, use_rope)
    out = attention_core(cfg, q, stream(k_cache, k_new),
                         stream(v_cache, v_new))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def write_chunk(cache: torch.Tensor, chunk: torch.Tensor,
                start_pos: int) -> torch.Tensor:
    """Write a [B, C, H, Dh] chunk into the slots of a [B, clen, H, Dh]
    (ring) cache at positions ``start_pos ..``, IN PLACE: a dense slice
    update, the offload/direct path. Three cases, as in the JAX package: the
    chunk fits before the ring's end, wraps past it, or covers the whole
    ring (then its last clen positions are kept, rolled to their slots)."""
    c, clen = chunk.shape[1], cache.shape[1]
    chunk = chunk.to(cache.dtype)
    s0 = start_pos % clen
    if c >= clen:
        cache.copy_(torch.roll(chunk[:, -clen:], (start_pos + c) % clen, 1))
    elif s0 + c <= clen:
        cache[:, s0:s0 + c] = chunk
    else:
        first = clen - s0
        cache[:, s0:] = chunk[:, :first]
        cache[:, :c - first] = chunk[:, first:]
    return cache


def project_kv(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
               positions: Optional[torch.Tensor]):
    """k, v for cache insertion."""
    dtype = x.dtype
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dtype))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dtype))
    if "bk" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if positions is not None:
        k = apply_rope(cfg, k, positions)
    return k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(ParamGroup):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        d, f = cfg.d_model, d_ff or cfg.d_ff
        shapes = {"wi": (d, f), "wo": (f, d)}
        if cfg.activation == SWIGLU:
            shapes["wg"] = (d, f)
        super().__init__(shapes, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        d, f = self.wi.shape
        dev = self.wi.device
        with torch.no_grad():
            self.wi.copy_(_normal(self.wi.shape, d ** -0.5, gen, dev))
            self.wo.copy_(_normal(self.wo.shape, f ** -0.5, gen, dev))
            if hasattr(self, "wg"):
                self.wg.copy_(_normal(self.wg.shape, d ** -0.5, gen, dev))
        self._cast.clear()


def apply_mlp(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dtype))
    if cfg.activation == SWIGLU:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dtype))
        h = nn.functional.silu(g) * h
    elif cfg.activation == SQUARED_RELU:
        h = torch.relu(h).square()
    elif cfg.activation == GELU:
        h = nn.functional.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dtype))


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


class Embed(ParamGroup):
    def __init__(self, cfg: ModelConfig, device):
        shapes = {"tok": (cfg.vocab, cfg.d_model)}
        if not cfg.tie_embeddings:
            shapes["head"] = (cfg.vocab, cfg.d_model)
        super().__init__(shapes, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        dev = self.tok.device
        with torch.no_grad():
            self.tok.copy_(_normal(self.tok.shape, 0.02, gen, dev))
            if hasattr(self, "head"):
                self.head.copy_(_normal(self.head.shape,
                                        cfg.d_model ** -0.5, gen, dev))
        self._cast.clear()


def embed_tokens(cfg: ModelConfig, p: Tensors, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Rows of the fp32 table cast to ``dtype`` (the same values as casting
    the table first, without a copy of the table)."""
    return p["tok"][tokens.long()].to(dtype)


def lm_logits(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    """Final logits in float32, against the fp32 master head."""
    w = p["tok"] if cfg.tie_embeddings else p["head"]
    return torch.einsum("bsd,vd->bsv", x.float(), w.float())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy: logits fp32 ``[B, S, V]``, labels int
    ``[B, S]``; ``logsumexp - gold logit``, then the mean, or the sum over
    ``mask`` divided by ``max(sum(mask), 1)``."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


# ---------------------------------------------------------------------------
# Under a mesh: one device's share plus an explicit collective
# ---------------------------------------------------------------------------


def pad_to_multiple(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m``: the count of heads, vocab
    lanes or experts a ``model`` axis of ``m`` runs (JAX's ``_tp_head_pad``,
    the head padding of ``lm_logits`` and of the MoE layer)."""
    return (n + m - 1) // m * m


def pad_axis(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zeros appended on ``dim`` up to length ``n`` (zero heads,
    head rows or experts: their outputs and gradients are exactly zero)."""
    extra = n - x.shape[dim]
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def shard_batch(sm, x: torch.Tensor, axes):
    """Each device's rows of the batch-leading ``x`` on its device: part
    ``index(r, axes)`` of the split over the dp ``axes`` (JAX's
    ``shard_batch`` constraint)."""
    k = sm.size(axes)
    w = x.shape[0] // k
    return [x[sm.index(r, axes) * w:(sm.index(r, axes) + 1) * w].to(
        sm.device(r)) for r in range(sm.n)]


def embed_tokens_sharded(sm, tok, tokens, dtype, d_over_model: bool):
    """The lookup on each device's piece of the table (``tok [V, D / m]``
    where it is split on D over ``model``), then the residual stream's D
    gathered over ``model``."""
    from ..distributed.collectives import all_gather

    x = [t[i.long()].to(dtype) for t, i in zip(tok, tokens)]
    return all_gather(sm, x, "model", 2, "embed") if d_over_model else x


def lm_logits_sharded(xs, w, first, vocab: int):
    """Each device's fp32 logits over its vocab lanes ``[first, first +
    rows)`` against its head rows ``w [rows, D]`` (zero rows past the
    vocab), the lanes past ``vocab`` at -1e30 as ``lm_logits`` masks them."""
    out = []
    for x, wr, lo in zip(xs, w, first):
        logits = torch.einsum("bsd,vd->bsv", x.float(), wr.float())
        if lo + wr.shape[0] > vocab:
            lane = torch.arange(lo, lo + wr.shape[0], device=x.device)
            logits = torch.where(lane < vocab, logits,
                                 torch.full((), -1e30, device=x.device))
        out.append(logits)
    return out


def vocab_parallel_nll(sm, logits, first, labels):
    """Each token's ``logsumexp - gold logit`` from fp32 logits split on
    their vocab over ``model`` (device ``r`` holding lanes ``first[r] ..``):
    the max and the sum of exponentials combined over ``model``, the gold
    logit from the rank whose lanes hold the label."""
    from ..distributed.collectives import pmax, psum

    mx = pmax(sm, [lg.amax(dim=-1) for lg in logits], "model", "loss_max")
    se, gold = [], []
    for lg, m, lo, lab in zip(logits, mx, first, labels):
        se.append(torch.exp(lg - m[..., None]).sum(dim=-1))
        lane = torch.arange(lo, lo + lg.shape[-1], device=lg.device)
        gold.append(torch.where(lane == lab.long()[..., None], lg,
                                0.0).sum(dim=-1))
    se = psum(sm, se, "model", "loss_sumexp")
    gold = psum(sm, gold, "model", "loss_gold")
    return [torch.log(s) + m - g for s, m, g in zip(se, mx, gold)]
