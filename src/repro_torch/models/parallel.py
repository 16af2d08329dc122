"""The sharded train step's model side: every family (dense ``DecoderLM``,
MoE ``MoELM``, SSM ``MambaLM``, hybrid ``ZambaLM``, encoder-decoder
``WhisperModel`` and the VLM's ``DecoderLM``) on a ``(data, model)`` or
``(pod, data, model)`` mesh, one process, the mesh's devices distinct cards
or virtual ones.

A sharded value is a list with one tensor per mesh device; each function
here runs one device's share on that device's tensors and moves data only
through the named collectives of ``distributed.collectives``, which count
their bytes. The parameters are the pieces the JAX package's rules give
(``distributed.sharding.layer_pspec``), fp32 masters; the math is that of
the unsharded model (the padding below adds only zeros).

* Rows: each microbatch is split over the dp axes by ``batch_pspec``
  (``layers.shard_batch``), its media (whisper's frames, the VLM's image
  embeddings) like its tokens; every device computes the loss of the WHOLE
  microbatch (the sums over its rows added over the dp axes and divided by
  the microbatch's mask count), so the loss is one number on every device.
* FSDP: a leaf split over ``data`` is gathered over ``data`` inside its
  layer (its gradient reduce-scattered back); under remat the layer's
  gather runs again in the backward, as often as the layer runs. A leaf the
  batch axes do not split has its gradient summed over them after the
  step's microbatches.
* Embedding: the lookup runs on the table's own piece (``tok`` is split on
  D over ``model`` where D divides, never on its vocab), then the residual
  stream's D is gathered over ``model``: the only ``model``-axis gather of
  the Megatron paths.
* Attention (Megatron): each model rank projects its q heads and the kv
  heads they read, applies rotary (where the family has it), runs K3
  forward and K3's backward on those heads only, applies its rows of
  ``wo``, and the partial outputs are summed over ``model``. Under
  ``heads`` the projections arrive split; under ``qheads_kvrepl`` the q
  side does and the kv projections are whole on every rank (each rank takes
  the kv heads its q heads read); under ``headdim`` and ``replicate`` the
  projections are made whole over ``model`` and their heads padded with
  zero heads to a multiple of it (``layers.pad_to_multiple``, JAX's
  ``_tp_head_pad``), each rank running its share; the padded heads' rows
  are zeros, so their outputs and gradients are exactly zero and nothing of
  them is kept. A cross read (whisper's decoder over the encoder's output,
  the VLM's cross layers over the image embeddings) projects each rank's kv
  heads from the whole source, which enters the rank's work through
  ``copy_to`` (its gradient, where it has one, summed over ``model``), and
  runs K3 non-causally. The VLM's gates multiply the SUMMED output, so
  their gradient is the same on every model rank and is not summed there.
* MLP: a column split of ``wi`` / ``wg`` over ff and a row split of
  ``wo``, then a sum over ``model`` (an ff that ``model`` does not divide
  runs whole on every rank).
* Mamba (the SSM trunk, zamba2's too): the rules split ``in_proj`` and
  ``out_proj`` on D over ``data`` and nothing of the layer over ``model``,
  so each device gathers them over ``data`` and every model rank runs its
  rows' whole layer, the SSD included; no ``model``-axis collective.
* Head and loss (vocab parallel): each model rank makes ``[B, S, V/m]``
  fp32 logits (the head zero-padded to a multiple of ``model`` where V is
  not, its padded lanes at -1e30, as ``lm_logits`` does); the logsumexp
  combines a max and a sum over ``model`` and the gold logit comes from the
  rank whose lanes hold it (``layers.vocab_parallel_nll``), so ``[B, S, V]``
  never exists on one device.
* MoE (expert parallelism): routing, capacity, slot order, the aux loss
  and the loads are those of the whole microbatch: every device routes its
  rows, an assignment's slot is its rank among the microbatch's
  assignments to its expert (the count of earlier rows' assignments on the
  dp ranks before it added as an integer prefix, never a float cumsum),
  the capacity is ``expert_capacity`` of the microbatch's tokens, and the
  aux loss is the product of the summed routing fractions and mean
  probabilities. Model rank ``m`` holds experts ``[m E/M, (m+1) E/M)``
  (zero experts pad E to a multiple of ``model`` first where it does not
  divide; the router still spans the real E) and runs the three dispatch
  modes of ``moe.moe_ffn_layer`` on them: the staged path drains through
  K1 into its shard's buffer (``staged_drain``, its adjoint
  ``staged_gather``), once per shard; the combined outputs are summed over
  ``model``.
* Nesting: each family's checkpoints are the unsharded model's (zamba2's
  and the VLM's groups around their checkpointed layers), so a layer's
  kernels and collectives run as often as ``models.trunk_parts`` says
  (``models.remat_calls`` counts the kernels' calls from it).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import DENSE, ENCDEC, HYBRID, SSM
from ..distributed.collectives import (StepMesh, all_gather, copy_to,
                                       exclusive_prefix, psum, scatter_to)
from ..distributed.sharding import (NamedSharding, ShardedTensor,
                                    attention_scheme, axis_size, batch_pspec,
                                    entry_axes, layer_pspec)
from . import layers as L
from .layout import jax_key
from .model import trunk_parts
from .transformer import remat_call
from .whisper import check_frames

Ranks = List[torch.Tensor]

def release_masters(model: nn.Module) -> None:
    """Replace every master of ``model`` by a ``meta`` tensor of its shape:
    its pieces hold it now, and no device keeps the whole."""
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=False)
        if isinstance(mod, L.ParamGroup):
            mod._cast.clear()


class MeshPlan:
    """What a model's sharded step takes from the rules, worked out once
    for a model and a mesh: each parameter's spec, the attention scheme,
    each model rank's q heads and the kv heads they read, and the padded
    head, vocab and expert counts (no heads in the SSM family), and how the
    family nests its trunk (``trunk_parts``)."""

    def __init__(self, model, mesh):
        cfg = model.cfg
        self.model, self.cfg, self.mesh = model, cfg, mesh
        self.specs = {n: layer_pspec(cfg, mesh, n, p.shape)
                      for n, p in model.named_parameters()}
        self.parts = trunk_parts(cfg)
        self.m = m = axis_size(mesh, "model")
        self.scheme = attention_scheme(cfg, mesh)
        self.hp, self.kv_heads = 0, []
        if cfg.n_heads:
            self._heads(cfg, m)
        head = "embed.head" if "embed.head" in self.specs else "embed.tok"
        self.head_name = head
        self.vocab_split = self.specs[head][0] == "model" or m == 1
        self.vp = cfg.vocab if self.vocab_split \
            else L.pad_to_multiple(cfg.vocab, m)
        self.n_experts = getattr(cfg, "n_experts", 0)
        self.ep = L.pad_to_multiple(self.n_experts, m)
        if self.n_experts:
            spec = self.specs["blocks.0.moe.wi"]
            self.expert_split = spec[0] == "model" or m == 1

    def _heads(self, cfg, m):
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.hp = hq if self.scheme in ("heads", "qheads_kvrepl") \
            else L.pad_to_multiple(hq, m)
        # each model rank's kv heads (an index per kv head it runs; hkv for
        # a zero head) where the kv projections are whole on every rank
        group, hq_m = hq // hkv, self.hp // m
        for mi in range(m):
            kv = [j // group if j < hq else hkv
                  for j in range(mi * hq_m, (mi + 1) * hq_m)]
            uniq = [x for i, x in enumerate(kv) if i == 0 or kv[i - 1] != x]
            if hq_m % len(uniq) == 0 and kv == [
                    u for u in uniq for _ in range(hq_m // len(uniq))]:
                kv = uniq          # GQA by index within the rank
            self.kv_heads.append(kv)

    def model_index(self, sm: StepMesh, r: int) -> int:
        return sm.index(r, "model")


# ---------------------------------------------------------------------------
# leaves: FSDP gathers and model-axis wholes
# ---------------------------------------------------------------------------


def _gather_axis(sm, xs, spec, axis, what):
    """``xs`` with the tensor axis that ``spec`` splits over mesh axis
    ``axis`` gathered (as is where it splits none)."""
    for ax, entry in enumerate(spec):
        if axis in entry_axes(entry):
            if entry != axis:
                raise ValueError(f"{what}: {spec} splits over {entry}")
            return all_gather(sm, xs, axis, ax, what)
    return xs


def _fsdp(plan: MeshPlan, sm, params, name: str):
    """The pieces of ``name`` with their FSDP split over ``data`` gathered
    (labelled by the JAX key in the collectives' counts)."""
    return _gather_axis(sm, params[name], plan.specs[name], "data",
                        jax_key(name)[0])


def _whole_over_model(plan, sm, xs, name):
    return _gather_axis(sm, xs, plan.specs[name], "model", jax_key(name)[0])


def _heads_of_rank(plan, sm, xs, name, dim):
    """An invariant head-axis tensor (axis ``dim``) padded with zero heads
    to ``plan.hp`` and cut to each model rank's share."""
    xs = [L.pad_axis(x, dim, plan.hp) for x in xs]
    return scatter_to(sm, xs, "model", dim, jax_key(name)[0])


def _kv_of_rank(plan, sm, xs, name, dim):
    """Whole kv projections: each model rank takes the kv heads its q
    heads read (a zero head for a padded q head)."""
    xs = copy_to(sm, xs, "model", jax_key(name)[0])
    out = []
    for r, x in enumerate(xs):
        idx = torch.tensor(plan.kv_heads[plan.model_index(sm, r)],
                           device=x.device)
        out.append(L.pad_axis(x, dim, x.shape[dim] + 1).index_select(dim,
                                                                    idx))
    return out


def attention_weights(plan: MeshPlan, sm: StepMesh, params, prefix: str):
    """Each device's q / k / v / o weights (and biases) for its heads:
    ``{"wq": ranks, ...}`` (FSDP gathered)."""
    p = {k: _fsdp(plan, sm, params, prefix + k)
         for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
         if prefix + k in params}
    s = plan.scheme
    if s == "heads":
        return p
    out = {}
    if s == "qheads_kvrepl":
        for k in ("wq", "wo", "bq"):
            if k in p:
                out[k] = p[k]
    else:
        for k, dim in (("wq", 1), ("wo", 0), ("bq", 0)):
            if k in p:
                whole = _whole_over_model(plan, sm, p[k], prefix + k)
                out[k] = _heads_of_rank(plan, sm, whole, prefix + k, dim)
    for k, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if k in p:
            whole = _whole_over_model(plan, sm, p[k], prefix + k)
            out[k] = _kv_of_rank(plan, sm, whole, prefix + k, dim)
    return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _norm(params, name: str, n: int):
    """Each device's norm tensors of ``name`` (``blocks.0.ln1``)."""
    return [{k: params[f"{name}.{k}"][r] for k in ("scale", "bias")
             if f"{name}.{k}" in params} for r in range(n)]


def attention(plan: MeshPlan, sm: StepMesh, params, prefix: str, xs: Ranks,
              positions: Optional[Ranks], *, attn: str = "attn",
              ln: str = "ln1", kv: Optional[Ranks] = None,
              gate: Optional[Ranks] = None) -> Ranks:
    """``x`` plus the block's attention (pre-norm ``ln``, the weights under
    ``prefix + attn``), Megatron-split over ``model``: K3 and its backward
    on each rank's heads. Causal over ``x`` itself, with rotary at
    ``positions`` (None: no rotary); with ``kv`` (a cross read: the
    source's rows, not normed) every query reads every source row and
    nothing is rotated. ``gate`` (each device's 0-d factor) scales the
    output summed over ``model``."""
    cfg = plan.cfg
    norm = _norm(params, prefix + ln, sm.n)
    w = attention_weights(plan, sm, params, prefix + attn + ".")
    hn = copy_to(sm, [L.apply_norm(cfg, norm[r], x) for r, x in enumerate(xs)],
                 "model", "attn_in")
    if kv is not None:
        kv = copy_to(sm, kv, "model", "cross_in")
    rope = positions is not None and kv is None
    parts = []
    for r, x in enumerate(hn):
        pa = {k: v[r] for k, v in w.items()}
        pos = positions[r] if rope else None
        q = L.project_q(cfg, pa, x, pos, rope)
        k, v = L.project_kv(cfg, pa, x if kv is None else kv[r], pos)
        o = L.attention_core(cfg, q, k, v, causal=kv is None)
        parts.append(torch.einsum("bshk,hkd->bsd", o, pa["wo"].to(x.dtype)))
    out = psum(sm, parts, "model", "attn_out")
    if gate is not None:
        out = [g * o for g, o in zip(gate, out)]
    return [x + o for x, o in zip(xs, out)]


def mlp(plan: MeshPlan, sm: StepMesh, params, prefix: str,
        xs: Ranks, *, ln: str = "ln2",
        gate: Optional[Ranks] = None) -> Ranks:
    """``x`` plus the block's MLP (pre-norm ``ln``): ``wi`` / ``wg`` split
    by columns over ff and ``wo`` by rows, the partial outputs summed over
    ``model``; an ff ``model`` does not split runs whole on every rank.
    ``gate`` scales the summed output."""
    cfg = plan.cfg
    split = plan.specs[prefix + "mlp.wi"][-1] == "model" and plan.m > 1
    norm = _norm(params, prefix + ln, sm.n)
    w = {k: _fsdp(plan, sm, params, prefix + "mlp." + k)
         for k in ("wi", "wg", "wo") if prefix + "mlp." + k in params}
    hn = [L.apply_norm(cfg, norm[r], x) for r, x in enumerate(xs)]
    if split:
        hn = copy_to(sm, hn, "model", "mlp_in")
    out = [L.apply_mlp(cfg, {k: v[r] for k, v in w.items()}, x)
           for r, x in enumerate(hn)]
    if split:
        out = psum(sm, out, "model", "mlp_out")
    if gate is not None:
        out = [g * o for g, o in zip(gate, out)]
    return [x + o for x, o in zip(xs, out)]


# ---------------------------------------------------------------------------
# mamba2: FSDP over data, the whole layer on every model rank
# ---------------------------------------------------------------------------

# a mamba layer's leaves the rules leave whole (``in_proj`` / ``out_proj``
# are split on D over ``data``)
_MAMBA_WHOLE = ("conv_w", "conv_b", "A_log", "dt_bias", "D", "norm")


def mamba_layer(plan: MeshPlan, sm: StepMesh, params, i: int,
                xs: Ranks) -> Ranks:
    """Mamba layer ``i`` (``blocks.i``) on each device's rows: ``in_proj``
    and ``out_proj`` gathered over ``data``, the rest whole, the layer's
    math (``mamba2.mamba_block``: the SSD in plain PyTorch) that of one
    device; the fp32 masters cast at each use, as the block does."""
    from .mamba2 import mamba_block

    prefix = f"blocks.{i}."
    w = {k: _fsdp(plan, sm, params, prefix + k)
         for k in ("in_proj", "out_proj")}
    norm = _norm(params, prefix + "ln", sm.n)
    out = []
    for r, x in enumerate(xs):
        p = {k: params[prefix + k][r] for k in _MAMBA_WHOLE}
        p.update({k: v[r] for k, v in w.items()}, ln=norm[r])
        out.append(mamba_block(plan.cfg, p, x)[0])
    return out


# ---------------------------------------------------------------------------
# MoE: routing of the whole microbatch, experts split over model
# ---------------------------------------------------------------------------


def expert_weights(plan: MeshPlan, sm: StepMesh, params, prefix: str):
    """Each device's ``wi`` / ``wg`` / ``wo`` for its expert shard (FSDP
    gathered; zero experts where E was padded)."""
    out = {}
    for k in ("wi", "wg", "wo"):
        name = prefix + k
        xs = _fsdp(plan, sm, params, name)
        if not plan.expert_split:
            whole = _whole_over_model(plan, sm, xs, name)
            xs = scatter_to(sm, [L.pad_axis(x, 0, plan.ep) for x in whole],
                            "model", 0, jax_key(name)[0])
        out[k] = xs
    return out


def route_whole(plan: MeshPlan, sm: StepMesh, router: Ranks, xt: Ranks,
                n_tokens: int):
    """Every device's routing of its rows, with the aux loss and the loads
    of the whole microbatch (``n_tokens`` tokens over the batch axes):
    ``(idx [T, K], weights [T, K], aux (the same on every device), load
    [E] summed over the batch axes)``."""
    from .moe import topk_route

    cfg, e = plan.cfg, plan.n_experts
    idx, weights, f_sum, p_sum, load = [], [], [], [], []
    for r, x in enumerate(xt):
        probs, i, w = topk_route(cfg, router[r], x)
        idx.append(i)
        weights.append(w.to(x.dtype))
        f_sum.append(nn.functional.one_hot(i[:, 0], e).float().sum(dim=0))
        p_sum.append(probs.sum(dim=0))
        # bincount's output size depends on the data: no meta kernel
        flat = i.reshape(-1)
        load.append(torch.zeros(e, dtype=torch.int64, device=flat.device)
                    .index_add_(0, flat, torch.ones_like(flat)))
    axes = sm.batch_axes
    f_sum = psum(sm, f_sum, axes, "moe_route_fraction")
    p_sum = psum(sm, p_sum, axes, "moe_route_prob")
    load = psum(sm, load, axes, "moe_load")
    aux = [cfg.router_aux_coef * e * ((f / n_tokens) * (p / n_tokens)).sum()
           for f, p in zip(f_sum, p_sum)]
    return idx, weights, aux, load


def global_slots(sm: StepMesh, idx: Ranks, n_experts: int) -> Ranks:
    """Each assignment's slot in its expert's buffer for the whole
    microbatch: its rank among the assignments to that expert in row order
    (``[T * K]``), the earlier dp ranks' counts added as an integer
    prefix."""
    local, counts = [], []
    for i in idx:
        flat = i.reshape(-1)
        # [E, T * K]: the scan runs along the contiguous axis (integer:
        # exact, in any order)
        onehot = nn.functional.one_hot(flat, n_experts).t().contiguous()
        ranks = torch.cumsum(onehot, dim=1) - onehot
        local.append(ranks.gather(0, flat[None, :])[0])
        counts.append(onehot.sum(dim=1))
    offset = exclusive_prefix(sm, counts, sm.batch_axes, "moe_slot_prefix")
    return [lo + off[i.reshape(-1)] for lo, off, i in zip(local, offset, idx)]


def _shard_dispatch(x, flat_e, slot, ok, e0, e_local, cap, k, staged):
    """One device's dispatch of its kept assignments ``ok`` (flat ``[T *
    K]``) into its expert shard's buffer ``[e_local, cap, D]``: direct (an
    unsorted ``index_copy_``) or staged (a stable sort by expert, then the
    K1 drain ``staged_drain`` into the shard's buffer); returns (buffer,
    each assignment's row in it, or -1)."""
    from ..kernels import staged_drain, staged_scatter

    n = e_local * cap
    row = torch.where(ok, (flat_e - e0) * cap + slot, n)
    if not staged:
        buf = torch.zeros((n + 1, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        buf = buf.index_copy(0, row, x.repeat_interleave(k, dim=0))[:n]
    else:
        key = torch.where(ok, flat_e - e0, e_local)
        perm = torch.argsort(key, stable=True)
        staged_rows = x[perm // k]
        dst, valid = row[perm], ok[perm]
        if torch.is_grad_enabled() and staged_rows.requires_grad:
            buf = staged_drain(staged_rows, dst, valid, n)
        else:
            buf = torch.zeros((n, x.shape[1]), dtype=x.dtype,
                              device=x.device)
            staged_scatter(buf, staged_rows, dst, valid)
    return buf.reshape(e_local, cap, x.shape[1]), torch.where(ok, row, -1)


def _combine(out_buf, row, weights):
    """The expert outputs of each assignment's row mixed by its router
    weight (a row of -1 weighs 0): ``[T, D]``. An assignment without a row
    here reads its own zero row past the buffer, so no two assignments
    read one row: the gather's backward (a sorted index_put) then has no
    run of repeated indices to walk (half the assignments of a device
    belong to other shards)."""
    e, c, d = out_buf.shape
    t, k = weights.shape
    n = e * c
    idx = torch.where(row >= 0, row, n + torch.arange(t * k,
                                                      device=row.device))
    src = torch.cat([out_buf.reshape(n, d), out_buf.new_zeros(t * k, d)])
    gathered = src[idx].reshape(t, k, d)
    w = torch.where(row.reshape(t, k) >= 0, weights, 0.0)[..., None]
    return (gathered * w.to(out_buf.dtype)).sum(dim=1)


def moe_ffn(plan: MeshPlan, sm: StepMesh, params, prefix: str, xs: Ranks,
            mode: str, hot_mask: Optional[torch.Tensor]):
    """``x`` plus the block's MoE FFN (pre-norm) over the mesh, the
    dispatch mode's paths run on each device's expert shard: ``(x, aux,
    load)``."""
    from .moe import DISPATCH_MODES, expert_capacity, expert_ffn

    if mode not in DISPATCH_MODES:
        raise ValueError(f"mode {mode!r} not in {DISPATCH_MODES}")
    if mode == "adaptive" and hot_mask is None:
        raise ValueError("adaptive mode needs hot_mask [E]")
    cfg = plan.cfg
    ln = [{k: params[prefix + "ln2." + k][r]
           for k in ("scale", "bias") if prefix + "ln2." + k in params}
          for r in range(sm.n)]
    hn = [L.apply_norm(cfg, ln[r], x) for r, x in enumerate(xs)]
    b, s, d = hn[0].shape
    xt = [h.reshape(-1, d) for h in hn]
    n_tokens = b * s * sm.size(sm.batch_axes)
    router = _fsdp(plan, sm, params, prefix + "moe.router")
    idx, weights, aux, load = route_whole(plan, sm, router, xt, n_tokens)
    slots = global_slots(sm, idx, plan.n_experts)
    cap = expert_capacity(cfg, n_tokens)
    w = expert_weights(plan, sm, params, prefix + "moe.")
    xt = copy_to(sm, xt, "model", "moe_in")
    weights = copy_to(sm, weights, "model", "moe_weights")
    e_local = plan.ep // plan.m
    parts = []
    for r, x in enumerate(xt):
        e0 = plan.model_index(sm, r) * e_local
        flat = idx[r].reshape(-1)
        k = idx[r].shape[1]
        ok = (slots[r] < cap) & (flat >= e0) & (flat < e0 + e_local)
        p = {n: v[r] for n, v in w.items()}
        if mode == "adaptive":
            hot = hot_mask.to(x.device)[flat]
            buf_h, row_h = _shard_dispatch(x, flat, slots[r], ok & hot, e0,
                                           e_local, cap, k, staged=False)
            buf_c, row_c = _shard_dispatch(x, flat, slots[r], ok & ~hot, e0,
                                           e_local, cap, k, staged=True)
            out = expert_ffn(p, buf_h + buf_c)
            y = (_combine(out, row_h, weights[r])
                 + _combine(out, row_c, weights[r]))
        else:
            buf, row = _shard_dispatch(x, flat, slots[r], ok, e0, e_local,
                                       cap, k, staged=mode == "staged")
            y = _combine(expert_ffn(p, buf), row, weights[r])
        parts.append(y.reshape(b, s, d))
    out = psum(sm, parts, "model", "moe_out")
    return [x + o for x, o in zip(xs, out)], aux, load


# ---------------------------------------------------------------------------
# embedding, head and the vocab-parallel loss
# ---------------------------------------------------------------------------


def embed(plan: MeshPlan, sm: StepMesh, params, tokens: Ranks,
          dtype) -> Ranks:
    """The lookup on each device's piece of ``tok`` (its FSDP split over
    ``data`` gathered first), then the residual stream's D gathered over
    ``model`` where ``tok`` is split on D there."""
    tok = _fsdp(plan, sm, params, "embed.tok")
    return L.embed_tokens_sharded(sm, tok, tokens, dtype,
                                  plan.specs["embed.tok"][1] == "model")


def vocab_logits(plan: MeshPlan, sm: StepMesh, params, xs: Ranks):
    """Each device's fp32 logits ``[B, S, V / m]`` over its vocab lanes
    (zero-padded head rows and -1e30 on the padded lanes where ``model``
    does not divide V) and the first lane's id."""
    name = plan.head_name
    w = _fsdp(plan, sm, params, name)
    if not plan.vocab_split:
        whole = _whole_over_model(plan, sm, w, name)
        w = scatter_to(sm, [L.pad_axis(x, 0, plan.vp) for x in whole],
                       "model", 0, jax_key(name)[0])
    xs = copy_to(sm, xs, "model", "head_in")
    first = [plan.model_index(sm, r) * (plan.vp // plan.m)
             for r in range(sm.n)]
    return L.lm_logits_sharded(xs, w, first, plan.cfg.vocab), first


# ---------------------------------------------------------------------------
# the loss of one microbatch
# ---------------------------------------------------------------------------


def batch_axes(plan: MeshPlan, shape) -> tuple:
    """The dp axes ``batch_pspec`` splits a microbatch's rows over."""
    return entry_axes(batch_pspec(plan.cfg, plan.mesh, "tokens", shape)[0])


def _layer(plan, sm, params, i, xs, positions, mode, hot_mask):
    prefix = f"blocks.{i}."
    xs = attention(plan, sm, params, prefix, xs, positions)
    if plan.n_experts:
        return moe_ffn(plan, sm, params, prefix, xs, mode, hot_mask)
    return mlp(plan, sm, params, prefix, xs), None, None


def _zamba_group(plan, sm, params, g, xs, positions, remat):
    """zamba2's group ``g``: its mamba layers (each checkpointed under
    ``remat``), then the shared block (``shared.``, Megatron-split)."""
    per = plan.cfg.hybrid_attn_every
    for i in range(g * per, (g + 1) * per):
        xs = remat_call(remat, mamba_layer, plan, sm, params, i, xs)
    xs = attention(plan, sm, params, "shared.", xs, positions)
    return mlp(plan, sm, params, "shared.", xs)


def _gates(params, name, dtype, n):
    """Each device's ``tanh`` of a VLM gate, taken in fp32 and cast to the
    compute dtype (``CrossBlock.gates``)."""
    return [torch.tanh(params[name][r]).to(dtype) for r in range(n)]


def _vlm_group(plan, sm, params, g, xs, positions, media, remat):
    """The VLM's group ``g``: its self layers (each checkpointed under
    ``remat``), then its gated cross layer over ``media`` (without media,
    gated causal self-attention without rotary, as the reference's
    ``forward`` computes it)."""
    nspg = plan.cfg.cross_attn_every - 1
    for i in range(g * nspg, (g + 1) * nspg):
        xs = remat_call(remat, _layer, plan, sm, params, i, xs, positions,
                        None, None)[0]
    prefix = f"cross_blocks.{g}."
    dtype = xs[0].dtype
    xs = attention(plan, sm, params, prefix, xs, None, kv=media,
                   gate=_gates(params, prefix + "gate_attn", dtype, sm.n))
    return mlp(plan, sm, params, prefix, xs,
               gate=_gates(params, prefix + "gate_mlp", dtype, sm.n))


def _enc_layer(plan, sm, params, i, xs):
    """whisper's encoder layer ``i``: causal self-attention without rotary
    (as the reference computes it), then the MLP."""
    prefix = f"enc_blocks.{i}."
    xs = attention(plan, sm, params, prefix, xs, None)
    return mlp(plan, sm, params, prefix, xs)


def _dec_layer(plan, sm, params, i, xs, enc):
    """whisper's decoder layer ``i``: causal self-attention, the cross read
    of the encoder's output ``enc``, the MLP; no rotary."""
    prefix = f"dec_blocks.{i}."
    xs = attention(plan, sm, params, prefix, xs, None, attn="self_attn")
    xs = attention(plan, sm, params, prefix, xs, None, attn="cross_attn",
                   ln="ln2", kv=enc)
    return mlp(plan, sm, params, prefix, xs, ln="ln3")


def _encode(plan, sm, params, frames: Ranks, remat: bool) -> Ranks:
    """whisper's encoder over each device's frames (in the compute dtype,
    ``enc_pos`` added after the cast, as the reference does), each layer
    checkpointed under ``remat``, then ``ln_enc``."""
    cfg = plan.cfg
    xs = [f + params["enc_pos"][r].to(f.dtype)[None, :f.shape[1]]
          for r, f in enumerate(frames)]
    for i in range(cfg.n_enc_layers):
        xs = remat_call(remat, _enc_layer, plan, sm, params, i, xs)
    norm = _norm(params, "ln_enc", sm.n)
    return [L.apply_norm(cfg, norm[r], x) for r, x in enumerate(xs)]


def _trunk(plan, sm, params, xs, positions, media, remat, mode, hot_mask):
    """The family's layers over the embedded rows ``xs``, nested under
    remat as the unsharded model nests them: ``(xs, aux, loads)`` (the MoE
    aux loss and per-layer loads, else None)."""
    model, cfg = plan.model, plan.cfg
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            xs = remat_call(remat, mamba_layer, plan, sm, params, i, xs)
    elif cfg.family == HYBRID:
        for g in range(model.n_groups):
            xs = remat_call(remat, _zamba_group, plan, sm, params, g, xs,
                            positions, remat)
    elif cfg.family == ENCDEC:
        for i in range(cfg.n_layers):
            xs = remat_call(remat, _dec_layer, plan, sm, params, i, xs,
                            media)
    elif model.is_vlm:
        for g in range(model.n_groups):
            xs = remat_call(remat, _vlm_group, plan, sm, params, g, xs,
                            positions, media, remat)
    else:
        aux = [torch.zeros((), device=x.device) for x in xs]
        loads = []
        for i in range(len(model.blocks)):
            xs, a, ld = remat_call(remat, _layer, plan, sm, params, i, xs,
                                   positions, mode, hot_mask)
            if a is not None:
                aux = [x + y for x, y in zip(aux, a)]
                loads.append(ld[0].to(plan.mesh.lead))
        if plan.n_experts:
            return xs, aux, loads
    return xs, None, None


def _media(plan, sm, mb, axes, dtype) -> Optional[Ranks]:
    """Each device's rows of the microbatch's media in the compute dtype
    (cast on entry, as the unsharded models do), or None. whisper without
    media raises as its encoder does on one device."""
    media = mb.get("media")
    if plan.cfg.family == ENCDEC:
        check_frames(plan.cfg, media)
    if media is None:
        return None
    return [m.to(dtype) for m in L.shard_batch(sm, torch.as_tensor(media),
                                               axes)]


def sharded_loss(plan: MeshPlan, params: Dict[str, Ranks], mb, *,
                 remat: bool = True, mode: Optional[str] = None,
                 hot_mask: Optional[torch.Tensor] = None):
    """The loss of one microbatch ``mb`` (``tokens`` / ``labels`` /
    optional ``loss_mask``, and ``media`` for whisper and the VLM, whole)
    on the mesh: ``(losses, loads, sm)``, ``losses`` each device's copy of
    the whole microbatch's loss (the backward starts from 1 on each),
    ``loads`` the MoE's ``[L, E]`` on the lead device (None for the other
    families), ``sm`` the step's mesh."""
    from .transformer import compute_dtype

    cfg, model = plan.cfg, plan.model
    tokens = torch.as_tensor(mb["tokens"])
    axes = batch_axes(plan, tuple(tokens.shape))
    sm = StepMesh(plan.mesh, axes)
    tok = L.shard_batch(sm, tokens, axes)
    labels = L.shard_batch(sm, torch.as_tensor(mb["labels"]), axes)
    mask = mb.get("loss_mask")
    masks = None if mask is None else L.shard_batch(
        sm, torch.as_tensor(mask), axes)
    mode = mode or getattr(model, "dispatch_mode", "staged")
    dtype = compute_dtype(cfg)
    media = _media(plan, sm, mb, axes, dtype)
    if cfg.family == ENCDEC:
        media = _encode(plan, sm, params, media, remat)
    xs = embed(plan, sm, params, tok, dtype)
    b, s = tok[0].shape
    if cfg.family == ENCDEC:
        xs = [x + params["dec_pos"][r][:s].to(dtype)
              for r, x in enumerate(xs)]
    positions = [torch.arange(s, device=x.device).expand(b, s) for x in xs]
    xs, aux, loads = _trunk(plan, sm, params, xs, positions, media, remat,
                            mode, hot_mask)
    norm = _norm(params, "ln_f", sm.n)
    h = [L.apply_norm(cfg, norm[r], x) for r, x in enumerate(xs)]
    logits, first = vocab_logits(plan, sm, params, h)
    nll = L.vocab_parallel_nll(sm, logits, first, labels)
    if masks is None:
        total = psum(sm, [n.sum() for n in nll], axes, "loss_sum")
        losses = [t / (b * s * sm.size(axes)) for t in total]
    else:
        total = psum(sm, [(n * mk.to(n.dtype)).sum()
                          for n, mk in zip(nll, masks)], axes, "loss_sum")
        count = psum(sm, [mk.to(torch.float32).sum() for mk in masks],
                     axes, "loss_count")
        losses = [t / c.clamp(min=1) for t, c in zip(total, count)]
    if aux is not None:
        losses = [x + a for x, a in zip(losses, aux)]
        return losses, torch.stack(loads), sm
    return losses, None, sm


# ---------------------------------------------------------------------------
# serving under the training shardings (the dense family's dry-run cells)
# ---------------------------------------------------------------------------


class ServePlan(MeshPlan):
    """A :class:`MeshPlan` whose parameters are placed by the training
    rules (FSDP over ``data``, the Megatron split over ``model``), as the
    JAX package's serving cells place them: ``params`` holds each
    parameter's pieces, one a mesh device (the model keeps ``meta`` tensors
    of their shapes). The KV cache is split over the batch axes and, over
    ``model``, by the heads each rank's attention reads: its piece of the
    heads (``cache_pspec``'s split) where the scheme is ``heads``, else the
    kv heads its q heads read (``kv_heads``, a zero head for a padded q
    head), so K4 or K3 reads the rank's own heads and no merge across ranks
    is needed. (``cache_pspec`` splits such a cache's SEQUENCE over
    ``model``; a read of that layout needs a log-sum-exp merge across the
    ranks, the long_500k item of ROADMAP.md.)"""

    def __init__(self, model, mesh):
        super().__init__(model, mesh)
        if self.cfg.family != DENSE:
            raise NotImplementedError(
                f"sharded serving is built for the dense family, not "
                f"{self.cfg.family}")
        with torch.no_grad():
            self.params = {
                k: list(ShardedTensor.place(
                    p.detach(), NamedSharding(mesh, self.specs[k])).shards)
                for k, p in model.named_parameters()}
        release_masters(model)

    def rank_kv_heads(self, r: int) -> int:
        """How many kv heads device ``r``'s cache holds."""
        if self.scheme == "heads":
            return self.cfg.n_kv_heads // self.m
        return len(self.kv_heads[self.mesh.index(r, ("model",))])

    def place_cache(self, cache: Dict[str, torch.Tensor]):
        """``{"k": ranks, "v": ranks}``: each device's rows (over the dp
        axes ``cache_pspec`` splits them on) of its kv heads of the whole
        ``[L, B, S, Hkv, Dh]`` cache."""
        k = cache["k"]
        dp = batch_axes(self, (k.shape[1],))
        sm = StepMesh(self.mesh, dp)
        out = {}
        for name in ("k", "v"):
            rows = L.shard_batch(sm, cache[name].transpose(0, 1), dp)
            ranks = []
            for r, x in enumerate(rows):
                x = x.transpose(0, 1)
                if self.scheme == "heads":
                    n = x.shape[3] // self.m
                    mi = self.mesh.index(r, ("model",))
                    x = x.narrow(3, mi * n, n)
                else:
                    idx = torch.tensor(self.kv_heads[self.mesh.index(
                        r, ("model",))], device=x.device)
                    x = L.pad_axis(x, 3, x.shape[3] + 1).index_select(3, idx)
                ranks.append(x.contiguous())
            out[name] = ranks
        return out


def _serve_layer(plan: ServePlan, sm: StepMesh, i: int, xs: Ranks,
                 read) -> Ranks:
    """Dense layer ``i`` for serving: the attention (pre-norm, Megatron
    split: ``read(r, pa, hn)`` gives device ``r``'s projected output over
    its heads, summed over ``model``), then the MLP."""
    prefix = f"blocks.{i}."
    params = plan.params
    norm = _norm(params, prefix + "ln1", sm.n)
    w = attention_weights(plan, sm, params, prefix + "attn.")
    hn = copy_to(sm, [L.apply_norm(plan.cfg, norm[r], x)
                      for r, x in enumerate(xs)], "model", "attn_in")
    parts = [read(r, {k: v[r] for k, v in w.items()}, x)
             for r, x in enumerate(hn)]
    out = psum(sm, parts, "model", "attn_out")
    xs = [x + o for x, o in zip(xs, out)]
    return mlp(plan, sm, params, prefix, xs)


def _serve_logits(plan: ServePlan, sm: StepMesh, xs: Ranks) -> Ranks:
    """Each device's fp32 logits ``[B, V / m]`` of the last position."""
    norm = _norm(plan.params, "ln_f", sm.n)
    h = [L.apply_norm(plan.cfg, norm[r], x[:, -1:]) for r, x in enumerate(xs)]
    logits, _ = vocab_logits(plan, sm, plan.params, h)
    return [lg[:, 0] for lg in logits]


@torch.no_grad()
def sharded_decode_step(plan: ServePlan, cache, tokens: torch.Tensor,
                        pos: torch.Tensor):
    """One decode step (``DecoderLM.decode_step``'s direct path) on the
    mesh: tokens ``[B]``, pos ``[B]`` (whole) -> (each device's logits
    ``[B_local, V / m]``, the cache updated in place). Each device writes
    its rows' new K/V into its heads' lanes and reads them through K4
    (``flash_decode``)."""
    from .transformer import (cache_slots, compute_dtype, lane_write_plan,
                              valid_mask, write_lanes)

    cfg = plan.cfg
    axes = batch_axes(plan, tuple(tokens.shape))
    sm = StepMesh(plan.mesh, axes)
    tok = L.shard_batch(sm, tokens[:, None], axes)
    ps = L.shard_batch(sm, pos, axes)
    xs = embed(plan, sm, plan.params, tok, compute_dtype(cfg))
    clen = cache["k"][0].shape[2]
    writes = [lane_write_plan(cache_slots(cfg, p, clen), clen) for p in ps]
    masks = [valid_mask(cfg, p, clen) for p in ps]
    for i in range(cfg.n_layers):
        def read(r, pa, x, i=i):
            kc, vc = cache["k"][r][i], cache["v"][r][i]
            k_new, v_new = L.project_kv(cfg, pa, x, ps[r][:, None])
            write_lanes(kc, vc, k_new, v_new, writes[r])
            return L.decode_attention(cfg, pa, x, ps[r], kc, vc, masks[r])
        xs = _serve_layer(plan, sm, i, xs, read)
    return _serve_logits(plan, sm, xs), cache


@torch.no_grad()
def sharded_chunk_prefill(plan: ServePlan, cache, tokens: torch.Tensor,
                          start_pos: int):
    """One prompt chunk (``DecoderLM.chunk_prefill``) on the mesh: tokens
    ``[B, C]`` (whole) at positions ``start_pos ..`` -> (each device's
    last-token logits ``[B_local, V / m]``, the cache updated in place).
    Each device's queries read its heads' lanes before the chunk's write
    plus the chunk's own keys through K3 (``chunk_attention``), then the
    chunk is written."""
    from .transformer import compute_dtype

    cfg = plan.cfg
    axes = batch_axes(plan, tuple(tokens.shape))
    sm = StepMesh(plan.mesh, axes)
    tok = L.shard_batch(sm, tokens, axes)
    xs = embed(plan, sm, plan.params, tok, compute_dtype(cfg))
    b, c = tok[0].shape
    positions = [(start_pos + torch.arange(c, device=x.device)).expand(b, c)
                 for x in xs]
    for i in range(cfg.n_layers):
        def read(r, pa, x, i=i):
            kc, vc = cache["k"][r][i], cache["v"][r][i]
            k_new, v_new = L.project_kv(cfg, pa, x, positions[r])
            out = L.chunk_attention(cfg, pa, x, positions[r], kc, vc, k_new,
                                    v_new, start_pos)
            L.write_chunk(kc, k_new, start_pos)
            L.write_chunk(vc, v_new, start_pos)
            return out
        xs = _serve_layer(plan, sm, i, xs, read)
    return _serve_logits(plan, sm, xs), cache


# ---------------------------------------------------------------------------
# the bytes the specs give
# ---------------------------------------------------------------------------


def _attn_leaf(name: str) -> bool:
    parts = name.split(".")
    return len(parts) > 1 and parts[-2] in ("attn", "self_attn", "cross_attn")


def _part(plan: MeshPlan, name: str):
    """The trunk part whose parameters ``name`` is one of, and how many of
    the part's applications use it (all of them for an unstacked part,
    zamba2's ``shared.``; one for a layer of a stack); (None, 1) outside
    the trunk."""
    stack, _, rest = name.partition(".")
    for p in plan.parts:
        if p.stack == stack:
            return p, 1 if rest.split(".")[0].isdigit() else p.count
    return None, 1


def _runs(plan: MeshPlan, name: str, remat: bool):
    """How often a microbatch runs the layer that uses ``name`` forward
    (its gathers: once an application, plus each recompute of a checkpoint
    around it) and backward (its gathers' transposes: once an
    application); the embedding (tied: also the head) and the head
    once."""
    part, apps = _part(plan, name)
    if part is not None:
        return apps * (part.depth + 1 if remat else 1), apps
    if name == "embed.tok" and plan.head_name == name:
        return 2, 2                 # the lookup and the tied head
    return 1, 1


def _applications(plan: MeshPlan, seq: int, remat: bool):
    """A microbatch's attention applications ``(rows a query sequence,
    runs of its output's sum over model, source rows of a cross read whose
    source takes a gradient, else 0)`` and MLP applications ``(rows, runs
    of its output's sum)``, from the trunk's parts. Under remat a sum runs
    again in the recompute of each checkpoint around it, but a part's last
    ungated one not in its own: the recompute stops after the last tensor
    the backward saved (a gate's product saves its input)."""
    frames = plan.cfg.n_audio_frames
    attn, mlps = [], []
    for p in plan.parts:
        rows = frames if p.frames else seq
        for _, op in itertools.product(range(p.count), p.ops):
            runs = p.depth + 1 if remat else 1
            if remat and op == p.ops[-1] and not p.gated:
                runs -= 1
            if op in ("attn", "cross"):
                attn.append((rows, runs, frames if op == "cross" else 0))
            elif op == "mlp":
                mlps.append((rows, runs))
    return attn, mlps


def expected_collective_bytes(plan: MeshPlan, rows: int, seq: int,
                              microbatches: int, remat: bool = True,
                              masked: bool = False) -> Dict[str, int]:
    """The bytes a train step of ``microbatches`` microbatches of ``rows`` x
    ``seq`` tokens moves, by ``"op:axes"`` as ``collective_bytes`` counts
    them, worked out from the specs and shapes alone: the FSDP gathers of
    every leaf split over ``data`` (as often as its layer runs,
    ``_runs``) and their reduce-scatters, the ``model``-axis wholes and
    their scatters' gathers, the activations' sums over ``model`` (forward,
    as often as ``_applications`` counts) and their copies' gradient sums
    (backward, once an application: the residual entering a tensor-parallel
    region, whisper's encoder output entering a cross read), the loss's and
    the MoE routing's sums over the batch axes, and each leaf's gradient
    summed over the batch axes that do not split it."""
    from .transformer import compute_dtype

    cfg, mesh = plan.cfg, plan.mesh
    n, m = len(mesh.devices), plan.m
    axes = batch_axes(plan, (rows, seq))
    kb = axis_size(mesh, *axes)
    r_local = rows // kb
    cdt = torch.empty((), dtype=compute_dtype(cfg)).element_size()
    out: Dict[str, int] = {}
    fwd = 2 if remat else 1

    def add(op, ax, nbytes, times=1):
        ax = tuple(a for a in ax if mesh.shape.get(a, 1) > 1)
        k = axis_size(mesh, *ax)
        if k <= 1 or not times:
            return
        groups = n // k
        per = {"all_gather": (k - 1) * k * nbytes,      # nbytes: a piece
               "reduce_scatter": (k - 1) * k * nbytes,
               "all_reduce": 2 * (k - 1) * nbytes,       # a member's
               "all_reduce_max": 2 * (k - 1) * nbytes,
               "prefix": k * (k - 1) * nbytes}[op]
        key = f"{'all_gather' if op == 'prefix' else op}:{'+'.join(ax)}"
        out[key] = out.get(key, 0) + groups * per * times * microbatches

    names = list(plan.specs)
    shapes = {k: tuple(p.shape) for k, p in plan.model.named_parameters()}

    def piece(name, over=()):
        """fp32 bytes of ``name``'s piece, whole over ``over``."""
        size = 4
        for d, e in zip(shapes[name], plan.specs[name]):
            k = axis_size(mesh, *[a for a in entry_axes(e) if a not in over])
            size *= d // k
        return size

    def split(name):
        return {a for e in plan.specs[name] for a in entry_axes(e)}

    used = [k for k in names if _attn_leaf(k) or ".mlp." in k
            or ".moe." in k or k in ("embed.tok", plan.head_name)
            or k.split(".")[-1] in ("in_proj", "out_proj")]
    for k in used:
        if "data" in split(k):
            f, b = _runs(plan, k, remat)
            add("all_gather", ("data",), piece(k), f)
            if "data" in axes:
                add("reduce_scatter", ("data",), piece(k), b)
    # model-axis wholes of parameters, and the scatters that cut them
    d = cfg.d_model
    for k in used:
        leaf = k.split(".")[-1]
        f, b = _runs(plan, k, remat)
        split_model = "model" in split(k)
        whole = piece(k, over=("data", "model"))
        if _attn_leaf(k) and plan.scheme in ("headdim", "replicate"):
            if split_model:
                add("all_gather", ("model",), piece(k, ("data",)), f)
            if leaf in ("wq", "wo", "bq"):
                add("all_gather", ("model",), whole // cfg.n_heads
                    * plan.hp // m, b)
            else:
                add("all_reduce", ("model",), whole, b)
        elif _attn_leaf(k) and plan.scheme == "qheads_kvrepl" and \
                leaf in ("wk", "wv", "bk", "bv"):
            add("all_reduce", ("model",), whole, b)
        elif ".moe." in k and leaf != "router" and not plan.expert_split:
            if split_model:
                add("all_gather", ("model",), piece(k, ("data",)), f)
            add("all_gather", ("model",), whole // plan.n_experts * plan.ep
                // m, b)
        elif k == plan.head_name and not plan.vocab_split:
            if split_model:
                add("all_gather", ("model",), piece(k, ("data",)))
            add("all_gather", ("model",), whole // cfg.vocab * plan.vp // m)

    def act(s_):
        return r_local * s_ * d * cdt

    if plan.specs["embed.tok"][1] == "model":
        add("all_gather", ("model",), act(seq) // m)
    attn, mlps = _applications(plan, seq, remat)
    for s_, runs, src in attn:
        add("all_reduce", ("model",), act(s_), runs)     # attn_out
        add("all_reduce", ("model",), act(s_))           # attn_in grad
        if src:
            add("all_reduce", ("model",), act(src))      # cross_in grad
    if mlps and plan.specs[next(k for k in names if k.endswith(
            "mlp.wi"))][-1] == "model":
        for s_, runs in mlps:
            add("all_reduce", ("model",), act(s_), runs)  # mlp_out
            add("all_reduce", ("model",), act(s_))        # mlp_in grad
    if plan.n_experts:
        layers = len(plan.model.blocks)
        e, kk = plan.n_experts, cfg.top_k
        add("all_reduce", ("model",), act(seq), layers)     # moe_out
        add("all_reduce", ("model",), act(seq), layers)     # moe_in grad
        add("all_reduce", ("model",), r_local * seq * kk * cdt, layers)
        add("all_reduce", axes, 4 * e, 2 * layers * fwd)    # fractions
        add("all_reduce", axes, 8 * e, layers * fwd)        # loads
        add("prefix", axes, 8 * e, layers * fwd)            # slot prefix
    add("all_reduce", ("model",), act(seq), 1)              # head_in grad
    add("all_reduce_max", ("model",), r_local * seq * 4)
    add("all_reduce", ("model",), r_local * seq * 4, 2)     # sumexp, gold
    add("all_reduce", axes, 4, 2 if masked else 1)          # loss sums
    for k in names:
        add("all_reduce", tuple(a for a in axes if a not in split(k)),
            piece(k), 1 / microbatches)
    return {k: int(round(v)) for k, v in out.items()}


__all__ = [
    "MeshPlan", "ServePlan", "attention", "attention_weights", "batch_axes",
    "embed", "expected_collective_bytes", "expert_weights", "global_slots",
    "mamba_layer", "mlp", "moe_ffn", "release_masters", "route_whole",
    "sharded_chunk_prefill", "sharded_decode_step", "sharded_loss",
    "vocab_logits",
]
