"""Port of repro/models/moe.py: the Mixture-of-Experts layer with the
paper's dual-path expert dispatch.

Dispatching a token to an expert is a "remote write" into a per-expert
buffer, and both paths are here:

* ``direct`` (the paper's OFFLOAD path): every token-expert assignment is
  scattered straight into the per-expert buffer at a slot computed from a
  cumulative one-hot (its rank among same-expert assignments), an unsorted
  scatter (plain ``index_copy_``, as it is an XLA scatter in JAX).
* ``staged`` (the UNLOAD path): assignments are first stably sorted by
  destination expert (the staging ring: sequential appends), then drained
  into expert-major order. The drain is the kernel ``staged_scatter`` (K1):
  ``dest[E*C, D]`` zeros, the staging rows ``x[token_sorted]``, the
  destination row per staged entry, with the out-of-range sentinel ``E*C``
  for the dropped ones, which K1 drops as JAX's ``mode="drop"`` does.
* ``adaptive``: a hot-expert mask (``core.decision.expert_hot_mask``, the
  paper's frequency policy over expert-load counters) sends hot experts'
  assignments direct and cold ones staged, into disjoint slots of one
  buffer.

Training differentiates all three: under grad the staged drain is
``staged_drain`` (one K1 launch into a fresh buffer; its backward the
adjoint gather ``staged_gather``), the direct scatter stays a plain
``index_copy_``, whose gradient autograd takes (an XLA scatter in JAX too).

Capacity is per call: ``expert_capacity(cfg, T)`` from the call's token
count, and assignments past it are dropped (slot -1, weight 0). Routing
takes the top-k of the router's softmax with the lower expert first on
ties, as ``jax.lax.top_k`` does. The JAX package's expert padding and
buffer placement act only under a mesh: the sharded train step's
counterpart is ``models.parallel.moe_ffn`` (expert parallelism over
``model``, the routing of the whole microbatch).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import staged_drain, staged_scatter
from . import layers as L

DISPATCH_MODES = ("direct", "staged", "adaptive")


class MoEMLP(L.ParamGroup):
    """The router and the stacked expert SwiGLU weights: ``router [D, E]``
    (used in fp32), ``wi`` / ``wg [E, D, F]``, ``wo [E, F, D]``."""

    def __init__(self, cfg: ModelConfig, device):
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
        super().__init__({"router": (d, e), "wi": (e, d, f),
                          "wg": (e, d, f), "wo": (e, f, d)}, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        d, f = cfg.d_model, cfg.expert_d_ff
        dev = self.router.device
        with torch.no_grad():
            for name, scale in (("router", d ** -0.5), ("wi", d ** -0.5),
                                ("wg", d ** -0.5), ("wo", f ** -0.5)):
                w = getattr(self, name)
                w.copy_(L._normal(w.shape, scale, gen, dev))
        self._cast.clear()


class MoEBlock(nn.Module):
    """GQA attention + MoE FFN (the JAX package's ``init_moe_block``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.Norm(cfg, device)
        self.moe = MoEMLP(cfg, device)

    def init_(self, cfg: ModelConfig, gen: torch.Generator) -> None:
        self.attn.init_(cfg, gen)
        self.moe.init_(cfg, gen)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def topk_route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """The router's fp32 softmax over ``x [T, D]`` and its top-k: ``(probs
    [T, E], expert_idx int64 [T, K], weights [T, K] fp32, renormalized)``,
    ties with the lower expert first."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    # the first k of a stable descending sort: ties keep the lower expert
    # first, as jax.lax.top_k does (torch.topk promises no order)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.top_k], idx[:, :cfg.top_k]
    return probs, idx, weights / weights.sum(dim=-1, keepdim=True)


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of flat tokens ``x [T, D]`` by the fp32 ``router
    [D, E]``. Returns (expert_idx int64[T, K], weights [T, K] in x's dtype,
    aux_loss fp32 scalar, expert_load int64[E], the monitor's counter
    update)."""
    probs, idx, weights = topk_route(cfg, router, x)
    e = cfg.n_experts
    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    f_e = nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = cfg.router_aux_coef * e * (f_e * p_e).sum()
    load = torch.bincount(idx.reshape(-1), minlength=e)
    return idx, weights.to(x.dtype), aux, load


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


# ---------------------------------------------------------------------------
# Expert FFN over packed buffers
# ---------------------------------------------------------------------------


def expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D], SwiGLU per expert (batched products)."""
    dtype = buf.dtype
    h = torch.bmm(buf, p["wi"].to(dtype))
    g = torch.bmm(buf, p["wg"].to(dtype))
    return torch.bmm(nn.functional.silu(g) * h, p["wo"].to(dtype))


# ---------------------------------------------------------------------------
# Path 1: DIRECT dispatch (offload analogue), an unsorted scatter
# ---------------------------------------------------------------------------


def dispatch_direct(x: torch.Tensor, expert_idx: torch.Tensor,
                    keep: torch.Tensor, capacity: int, n_experts: int,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter assignments straight into per-expert buffers. ``x [T, D]``,
    ``expert_idx`` / ``keep [T, K]``. Returns (buffer [E, C, D], slot
    [T, K]: the slot each kept assignment landed in, -1 if dropped). The
    dropped rows go to a sink row past the buffer, so nothing is read on
    the host."""
    t, k = expert_idx.shape
    flat_e = expert_idx.reshape(-1)
    onehot = nn.functional.one_hot(flat_e, n_experts)
    onehot = onehot * keep.reshape(-1, 1).to(onehot.dtype)
    ranks = torch.cumsum(onehot, dim=0) - onehot   # rank among same-expert
    slot = ranks.gather(1, flat_e[:, None])[:, 0]
    ok = keep.reshape(-1) & (slot < capacity)
    sink = n_experts * capacity
    flat_dst = torch.where(ok, flat_e * capacity + slot, sink)
    buf = torch.zeros((sink + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, flat_dst, x.repeat_interleave(k, dim=0))
    buf = buf[:sink].reshape(n_experts, capacity, x.shape[1])
    return buf, torch.where(ok, slot, -1).reshape(t, k)


def combine_direct(out_buf: torch.Tensor, expert_idx: torch.Tensor,
                   slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs back to token order and mix them with the
    router weights (a dropped assignment weighs 0)."""
    e, c, d = out_buf.shape
    gathered = out_buf.reshape(e * c, d)[expert_idx * c + slot.clamp(min=0)]
    w = torch.where(slot >= 0, weights, 0.0)[..., None].to(out_buf.dtype)
    return (gathered * w).sum(dim=1)


# ---------------------------------------------------------------------------
# Path 2: STAGED dispatch (unload analogue), sort into staging, then drain
# ---------------------------------------------------------------------------


def staging_plan(expert_idx: torch.Tensor, keep: torch.Tensor,
                 capacity: int, n_experts: int):
    """The staging ring's bookkeeping for ``expert_idx`` / ``keep [T, K]``:
    a stable sort of the assignments by destination expert (dropped ones
    last), each one's rank in its expert's segment and its drain row.
    Returns (perm [T*K], dst [T*K]: ``expert * C + rank``, or the
    out-of-range sentinel ``E*C`` where not ``ok``, ok [T*K], slot [T, K]
    in the original order, -1 if dropped)."""
    t, k = expert_idx.shape
    tk = t * k
    dev = expert_idx.device
    flat_e = torch.where(keep.reshape(-1), expert_idx.reshape(-1), n_experts)
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    # rank within the expert's segment = position - segment start
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=dev))
    pos = torch.arange(tk, device=dev)
    slot_sorted = pos - seg_start[sorted_e]
    ok = (sorted_e < n_experts) & (slot_sorted < capacity)
    dst = torch.where(ok, sorted_e * capacity + slot_sorted,
                      n_experts * capacity)
    inv = torch.empty_like(perm)
    inv[perm] = pos
    slot = torch.where(ok, slot_sorted, -1)[inv].reshape(t, k)
    return perm, dst, ok, slot


def dispatch_staged(x: torch.Tensor, expert_idx: torch.Tensor,
                    keep: torch.Tensor, capacity: int, n_experts: int,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort assignments by destination expert, then drain them through K1.
    The sorted assignment list IS the staging buffer (``staging_plan``);
    the drain moves each staged row to ``expert * C + rank`` and drops the
    sentinel rows. Returns (buffer [E, C, D], sort_perm [T*K], slot [T, K]
    in the original order, -1 if dropped)."""
    k = expert_idx.shape[1]
    perm, dst, ok, slot = staging_plan(expert_idx, keep, capacity, n_experts)
    staged = x[perm // k]                 # [T*K, D], the staging content
    if torch.is_grad_enabled() and staged.requires_grad:
        # training: the functional drain (K1), its backward the adjoint
        buf = staged_drain(staged, dst, ok, n_experts * capacity)
    else:
        buf = torch.zeros((n_experts * capacity, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        staged_scatter(buf, staged, dst, ok)  # the drain: K1
    return buf.reshape(n_experts, capacity, x.shape[1]), perm, slot


# ---------------------------------------------------------------------------
# MoE layer with path selection
# ---------------------------------------------------------------------------


def moe_ffn_layer(cfg: ModelConfig, moe: MoEMLP, x: torch.Tensor,
                  mode: str = "staged",
                  hot_mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss, expert_load [E]). Every token
    of the call routes (dead and padded slots too), and the capacity is
    that of the call's ``B * S`` tokens, as in the JAX package.

    mode: ``direct`` (all assignments offloaded), ``staged`` (all
    unloaded, drained by K1) or ``adaptive`` (``hot_mask [E]``: hot
    experts direct, cold ones staged)."""
    if mode not in DISPATCH_MODES:
        raise ValueError(f"mode {mode!r} not in {DISPATCH_MODES}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    idx, weights, aux, load = route(cfg, moe.tensors()["router"], xt)
    cap = expert_capacity(cfg, b * s)
    keep = torch.ones_like(idx, dtype=torch.bool)
    e = cfg.n_experts
    p = moe.tensors(x.dtype)
    if mode == "direct":
        buf, slot = dispatch_direct(xt, idx, keep, cap, e)
        y = combine_direct(expert_ffn(p, buf), idx, slot, weights)
    elif mode == "staged":
        buf, _, slot = dispatch_staged(xt, idx, keep, cap, e)
        y = combine_direct(expert_ffn(p, buf), idx, slot, weights)
    else:
        if hot_mask is None:
            raise ValueError("adaptive mode needs hot_mask [E]")
        hot = hot_mask.to(x.device)[idx]
        # both sub-paths on disjoint assignment subsets: disjoint slots
        buf_h, slot_h = dispatch_direct(xt, idx, hot, cap, e)
        buf_c, _, slot_c = dispatch_staged(xt, idx, ~hot, cap, e)
        out = expert_ffn(p, buf_h + buf_c)
        y = (combine_direct(out, idx, slot_h, weights)
             + combine_direct(out, idx, slot_c, weights))
    return y.reshape(b, s, d), aux, load
