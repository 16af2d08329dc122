"""Port of repro/models/sampling.py (greedy decoding only).

Per-request ``SamplingParams`` and the in-segment slot sampler. The
scheduler loads each request's fields into fixed-shape per-slot tensors and
every decode step samples each slot under its own parameters. Only the
``greedy`` mode is ported: the ``sampled`` and ``filtered`` modes draw from a
threefry key chain that must be reproduced bit for bit before their streams
can be compared with the JAX package's, so they raise
``NotImplementedError`` here, as do ``spec_verify`` and ``derive_key``'s
callers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.types import resolve_device

# Fixed width of the per-slot stop-token table (padded with -1, which no
# vocabulary token equals). cfg.eos_id takes one entry.
MAX_STOP_TOKENS = 4


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling parameters (the public request knobs).

    temperature   0 = greedy argmax; > 0 = categorical over logits/T (not
                  ported yet). ``None`` defers to the engine default.
    top_k / top_p filters for sampled decoding (not ported yet).
    max_tokens    generation budget, counting the prefill-emitted token.
    stop_token_ids  emitting any of these retires the request (the engine's
                  ``eos_id`` is always added on top).
    seed          per-request PRNG seed (unused by greedy decoding).
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


SAMPLE_MODES = ("greedy", "sampled", "filtered")


def sample_tokens(logits: torch.Tensor, key_data: torch.Tensor,
                  params: SlotParams, mode: str = "greedy",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample every slot under its own parameters. logits f32[S, V] ->
    (tokens int[S], key data unchanged). Greedy argmax reads no key."""
    assert mode in SAMPLE_MODES, mode
    if mode != "greedy":
        raise NotImplementedError(
            f"not ported yet: sample mode {mode!r} (needs the threefry key "
            f"chain); greedy only")
    return torch.argmax(logits, dim=-1), key_data


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
