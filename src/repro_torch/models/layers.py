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

TP head padding, ``shard_batch``, ``chunk_attention``/``write_chunk``
(dense-lane chunked prefill) and ``cross_entropy_loss`` (training) are not
ported yet.
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
    masters themselves for float32, else a copy cast ONCE and kept."""

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


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Expand [B, T, Hkv, Dh] -> [B, T, Hq, Dh] for GQA."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return k.repeat_interleave(n_heads // hkv, dim=2)


# above this many score elements per batch entry, sdpa processes queries in
# blocks so the fp32 score tensor never materializes at [S, T]
_SDPA_BLOCK_THRESHOLD = 4096 * 2048
_SDPA_QBLOCK = 1024


def _sdpa_once(q, k, v, mask, scale):
    logits = torch.einsum("bshk,bthk->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention, fp32 softmax. q: [B, S, H, Dh]; k/v:
    [B, T, H, Dh]; mask: broadcastable to [B, H, S, T] (True = attend).
    Long sequences run BLOCKED over queries (exact per-block softmax)."""
    scale = q.shape[-1] ** -0.5
    s, t = q.shape[1], k.shape[1]
    if s * t <= _SDPA_BLOCK_THRESHOLD or s <= _SDPA_QBLOCK or s % _SDPA_QBLOCK:
        return _sdpa_once(q, k, v, mask, scale)
    outs = []
    for i in range(0, s, _SDPA_QBLOCK):
        qb = q[:, i: i + _SDPA_QBLOCK]
        mb = None
        if mask is not None:
            mb = mask[:, :, i: i + _SDPA_QBLOCK] if mask.dim() == 4 else mask
        outs.append(_sdpa_once(qb, k, v, mb, scale))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """[1, 1, s, t] causal (optionally sliding-window) mask. ``offset``:
    absolute position of query row 0 minus key col 0."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


def attention(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
              positions: torch.Tensor, *,
              kv_x: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full (prefill) attention. Causal unless ``kv_x`` given."""
    dims = attn_dims(cfg)
    q, k, v = _qkv(cfg, p, x, kv_x)
    if use_rope and kv_x is None:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions)
    k = repeat_kv(k, dims.n_heads)
    v = repeat_kv(v, dims.n_heads)
    if mask is None and kv_x is None:
        mask = causal_mask(x.shape[1], k.shape[1], cfg.sliding_window,
                           device=x.device)
    out = sdpa(q, k, v, mask)
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
    """One-token decode against a KV set. x: [B, 1, D]; pos: [B];
    k_cache/v_cache: [B, S, Hkv, Dh], already holding the new token's kv;
    kv_len_mask: bool [B, S]."""
    dims = attn_dims(cfg)
    q = project_q(cfg, p, x, pos[:, None], use_rope)
    k = repeat_kv(k_cache, dims.n_heads)
    v = repeat_kv(v_cache, dims.n_heads)
    out = sdpa(q, k, v, kv_len_mask[:, None, None, :])
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
    are shared with the plain cores."""
    from ..kernels import flash_decode_paged

    q = project_q(cfg, p, x, positions, use_rope)   # [B, C, Hq, Dh]
    out = flash_decode_paged(q, pages_k, pages_v, blocks, view_ok,
                             ring_k, ring_v, ring_ok)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


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
