"""Port of repro/models/sampling.py.

Per-request ``SamplingParams`` and the in-segment slot sampler. The
scheduler loads each request's fields into fixed-shape per-slot tensors and
every decode step samples each slot under its own parameters, temperature /
top-k / top-p / stop set, with a per-slot key chain.

The chain is JAX's threefry chain reproduced bit for bit
(``repro_torch.models.prng``), so a sampled stream is the JAX package's
wherever the float ``log`` of the Gumbel noise leaves the argmax alone. No
library sampler (``torch.multinomial``, ``torch.Generator``) is used: none
draws JAX's bits. Equivalence contract, as in the JAX package:

* ``temperature == 0`` -> greedy argmax (argmax never reads the key, so the
  always-split key chain is invisible).
* ``temperature == 1, top_k == 0, top_p == 1`` -> ``categorical`` on the
  unmodified logits (``x / 1.0`` is exact and the disabled filters are
  no-ops).
* filters compose in the standard order: temperature scale -> top-k mask ->
  top-p (nucleus) mask -> categorical.

``spec_verify`` is the speculative path's accept / reject pass over every
slot at once, on the same key chain (one split per slot per call in the
sampling modes, none in greedy).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.types import resolve_device
from . import prng

# Fixed width of the per-slot stop-token table (padded with -1, which no
# vocabulary token equals). cfg.eos_id takes one entry.
MAX_STOP_TOKENS = 4


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling parameters (the public request knobs).

    temperature   0 = greedy argmax; > 0 = categorical over logits/T.
                  ``None`` defers to the engine default (0.0 when greedy,
                  1.0 when sampled).
    top_k         keep only the k highest logits (0 = disabled).
    top_p         nucleus sampling: keep the smallest prefix of the sorted
                  distribution with cumulative mass >= top_p (1.0 =
                  disabled).
    max_tokens    generation budget, counting the prefill-emitted token.
    stop_token_ids  emitting any of these retires the request (the engine's
                  ``eos_id`` is always added on top).
    seed          per-request PRNG seed. ``None`` derives the slot key from
                  (engine sample_seed, request id); an explicit seed makes
                  the stream independent of the request id.
    """

    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 16
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1 (the prefill token counts)")
        if self.temperature is not None and self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if len(self.stop_token_ids) > MAX_STOP_TOKENS - 1:
            raise ValueError(
                f"at most {MAX_STOP_TOKENS - 1} stop_token_ids "
                f"(one slot is reserved for the engine eos_id)")


class SlotParams(NamedTuple):
    """``SamplingParams`` resolved into fixed-shape per-slot tensors.
    temperature: f32[S]; top_k: int[S]; top_p: f32[S];
    stop: int[S, MAX_STOP_TOKENS] (-1 padded)."""

    temperature: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    stop: torch.Tensor


def make_slot_params(n_slots: int, device="cuda") -> SlotParams:
    """Per-slot sampling parameters, on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    return SlotParams(
        temperature=torch.zeros((n_slots,), dtype=torch.float32, device=device),
        top_k=torch.zeros((n_slots,), dtype=torch.int64, device=device),
        top_p=torch.ones((n_slots,), dtype=torch.float32, device=device),
        stop=torch.full((n_slots, MAX_STOP_TOKENS), -1, dtype=torch.int64,
                        device=device),
    )


def stop_table(params: SamplingParams, eos_id: Optional[int]) -> list:
    """The request's -1-padded stop row: stop_token_ids + engine eos_id."""
    ids = list(params.stop_token_ids)
    if eos_id is not None and eos_id not in ids:
        ids.append(int(eos_id))
    if len(ids) > MAX_STOP_TOKENS:
        raise ValueError(f"stop set {ids} exceeds {MAX_STOP_TOKENS} entries")
    return ids + [-1] * (MAX_STOP_TOKENS - len(ids))


# Sampler variants (the scheduler picks one per segment from the LIVE
# slots' resolved params, so a pure-greedy workload pays the argmax alone):
#   greedy    every live slot has temperature == 0: argmax, no splits
#   sampled   temperatures only: split + categorical (no vocabulary sort)
#   filtered  some slot uses top-k / top-p: the mask from one sort
SAMPLE_MODES = ("greedy", "sampled", "filtered")


def filter_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Each row's top-k / top-p mask over temperature-scaled logits
    ``[S, V]`` (JAX ``_filter_logits``, one row per slot).

    Both filters keep a PREFIX of the descending sort, so they reduce to
    one logit threshold from ONE sort: rank < top_k, and the cumulative
    (post-top-k) mass strictly before the token < top_p. A disabled filter
    leaves the row untouched."""
    v = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    on_k = (top_k > 0) & (top_k < v)
    k_eff = torch.where(on_k, top_k, v)
    in_k = torch.arange(v, device=scaled.device)[None, :] < k_eff[:, None]
    masked = torch.where(in_k, desc, float("-inf"))
    e = torch.exp(masked - masked.max(dim=-1, keepdim=True).values)
    p_desc = e / e.sum(dim=-1, keepdim=True)
    csum = torch.cumsum(p_desc, dim=-1)
    # ranks past k_eff carry p_desc == 0 and csum == 1, so the top-p prefix
    # test also enforces top-k; the rank-0 token always survives
    keep = in_k & ((csum - p_desc) < torch.clamp(top_p, max=1.0)[:, None])
    n_keep = keep.sum(dim=-1)
    thr = desc.gather(1, (n_keep - 1).clamp(0, v - 1)[:, None])
    enabled = (top_p < 1.0) | on_k
    return torch.where(enabled[:, None] & (scaled < thr), float("-inf"),
                       scaled)


def sample_tokens(logits: torch.Tensor, key_data: torch.Tensor,
                  params: SlotParams, mode: str = "filtered",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample every slot under its own parameters.

    logits f32[S, V], key data int64[S, 2] (uint32 values) -> (tokens
    int64[S], new key data). ``mode`` (``SAMPLE_MODES``) must cover the live
    slots' params (the scheduler sees to it) and never changes a result,
    only how much work is done. In the sampling modes each slot's chain
    splits exactly once per call, the same schedule whether the slot's own
    temperature is zero or not, so batch composition never shifts a
    request's stream (greedy slots never read their subkey)."""
    assert mode in SAMPLE_MODES, mode
    greedy = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy, key_data
    pairs = prng.split(key_data)                      # [S, 2, 2]
    temp = params.temperature
    scaled = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    if mode == "filtered":
        scaled = filter_logits(scaled, params.top_k, params.top_p)
    sampled = prng.categorical(pairs[:, 0], scaled)
    return torch.where(temp > 0, sampled, greedy), pairs[:, 1]


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, written as JAX writes it."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def spec_verify(target_logits: torch.Tensor, draft_tokens: torch.Tensor,
                draft_logits: torch.Tensor, key_data: torch.Tensor,
                params: SlotParams, mode: str = "greedy",
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Draft-then-verify accept / reject and the bonus sample, every slot
    at once (JAX ``spec_verify`` over ``_verify_one``).

    target_logits f32[S, K+1, V] (``decode_chunk_paged(all_logits=True)``
    over the slab ``[t_cur, d_1..d_K]``; column j predicts position
    ``pos + j + 1``), draft_tokens int[S, K], draft_logits f32[S, K, V], key
    data int64[S, 2] -> (commit int64[S, K+1], n_commit int64[S],
    n_accepted int64[S], new key data). Per slot ``commit[:n_commit]`` is
    the committed run: the accepted draft prefix plus ONE target-chosen
    token (the fallback at the first rejection, or the bonus token when all
    K were accepted), so every round commits at least one token.

    Greedy slots accept a draft token iff it IS the target's argmax and
    fall back to the argmax: the stream is non-speculative greedy's by
    construction. Sampling slots run speculative rejection sampling: accept
    ``d_j`` with probability ``min(1, p(d_j) / q(d_j))`` (p / q the target /
    draft distributions under the slot's own temperature, top-k and top-p)
    and sample the first rejection from the residual ``max(p - q, 0)``
    (``p`` itself where that sums to 0). Key use is JAX's: greedy reads no
    key; the sampling modes split each slot's chain once per call and that
    subkey again into ``k_acc`` (the K uniforms) and ``k_res`` (the
    residual draw)."""
    assert mode in SAMPLE_MODES, mode
    s, k1, v = target_logits.shape
    k = k1 - 1
    dev = target_logits.device
    rows = torch.arange(s, device=dev)
    idx = torch.arange(k1, device=dev)[None, :]
    d_tokens = draft_tokens.long()
    g = torch.argmax(target_logits, dim=-1)                    # [S, K+1]
    acc = d_tokens == g[:, :k]
    if mode != "greedy":
        pairs = prng.split(key_data)                           # [S, 2, 2]
        sub = prng.split(pairs[:, 0])                          # k_acc, k_res
        temp = params.temperature
        t_eff = torch.where(temp > 0, temp, 1.0)[:, None, None]
        scaled_t = target_logits / t_eff
        scaled_d = draft_logits / t_eff
        if mode == "filtered":
            def filt(x):
                n = x.shape[1]
                return filter_logits(
                    x.reshape(s * n, v), params.top_k.repeat_interleave(n),
                    params.top_p.repeat_interleave(n)).view(s, n, v)
            scaled_t, scaled_d = filt(scaled_t), filt(scaled_d)
        p = _softmax(scaled_t)                                 # [S, K+1, V]
        q = _softmax(scaled_d)                                 # [S, K, V]
        u = prng.uniform(sub[:, 0], k)                         # [S, K]
        p_d = p[:, :k].gather(2, d_tokens[..., None])[..., 0]
        q_d = torch.clamp(q.gather(2, d_tokens[..., None])[..., 0],
                          min=1e-20)
        acc_samp = u < torch.clamp(p_d / q_d, max=1.0)
        acc = torch.where(temp[:, None] > 0, acc_samp, acc)
    a = torch.cumprod(acc.long(), dim=1).sum(dim=1)            # [S]
    fallback = g[rows, a]
    if mode != "greedy":
        # the residual at the commit column: max(p - q, 0) at a rejection,
        # p itself at the all-accepted bonus column (q's rows end at K)
        q_a = torch.where((a < k)[:, None], q[rows, a.clamp(max=k - 1)],
                          0.0)
        p_a = p[rows, a]
        resid = torch.clamp(p_a - q_a, min=0.0)
        resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_a)
        samp = prng.categorical(
            sub[:, 1], torch.log(torch.clamp(resid, min=1e-38)))
        fallback = torch.where(temp > 0, samp, fallback)
    dpad = torch.cat([d_tokens, torch.zeros_like(d_tokens[:, :1])], dim=1)
    commit = torch.where(idx < a[:, None], dpad, fallback[:, None])
    new_key = key_data if mode == "greedy" else pairs[:, 1]
    return commit, a + 1, a, new_key


def required_mode(params_list) -> str:
    """The cheapest sampler variant covering every given (resolved)
    SamplingParams."""
    mode = "greedy"
    for p in params_list:
        if p.temperature > 0:
            if p.top_k > 0 or p.top_p < 1.0:
                return "filtered"
            mode = "sampled"
    return mode


def hits_stop(tokens: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """bool[S]: does each slot's emitted token hit its stop set?"""
    return (tokens[:, None] == stop).any(dim=1)


def resolve(params: Optional[SamplingParams],
            default: Optional[SamplingParams],
            greedy_default: bool) -> SamplingParams:
    """Resolve a request's effective params: its own win wholesale; the one
    per-field backfill is a ``None`` temperature (request -> engine default
    -> 0.0 when greedy, 1.0 when sampled)."""
    p = params if params is not None else (default or SamplingParams())
    if p.temperature is None:
        fallback = (default.temperature
                    if default is not None and default.temperature is not None
                    else None)
        if fallback is None:
            fallback = 0.0 if greedy_default else 1.0
        p = dataclasses.replace(p, temperature=float(fallback))
    return p


def derive_key(base_key: torch.Tensor, req_id: int,
               seed: Optional[int]) -> torch.Tensor:
    """The slot key data for one request: an explicit per-request seed
    stands alone (the stream does not depend on the request id); otherwise
    the request id is folded into the engine's base key."""
    if seed is not None:
        return prng.key(seed, base_key.device)
    return prng.fold_in(base_key, int(req_id))
