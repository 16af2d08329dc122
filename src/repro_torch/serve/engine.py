"""Port of repro/serve/engine.py: the per-request serving engine, a batched
prefill then a decode loop over the dense lanes cache with the paper's
KV-write routing.

Write modes (per paper section 3):
  direct    every KV write scatters straight into the cache (offload path)
  staged    every write appends to the staging ring (``kvcache.staged``);
            a drain when the ring is full or a destination conflicts with
            a pending entry (unload path)
  adaptive  the decision module routes per sequence: sequences whose
            destination pages are HOT (frequency counters over page ids)
            write direct, cold ones are staged

Routing goes through ``core.decision.DecisionModule`` (built by
``core.paths.build_decision``, an exact monitor over pages), the decision
plane every write surface shares.

``decode`` is one loop whose every step stays on the device: the routing,
the gated drain (``staged.maybe_drain``: one ``staged_scatter`` launch a
step whose validity carries the drain decision), the model step and the
write counters, summed in a device tensor that is read back ONCE at the
end (the JAX package's one ``lax.scan``). ``decode_reference`` is the
per-step loop with its host reads of the counters (the parity oracle and
the benchmark's baseline). Staged and adaptive need the ring overlay,
which the dense ``DecoderLM`` family has (the VLM refuses it, as in the
JAX package).

``ServeEngine`` is built only internally (``_internal=True``), as in the
JAX package; the front door is ``serve.Engine.from_config``. Sampling:
``jax.random.categorical`` by the threefry chain of ``models.prng``, one
key split a step, so sampled streams are the JAX engine's for the same
key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.decision import DecisionModule
from ..core.paths import build_decision
from ..core.types import make_write_batch
from ..kvcache import staged as ST
from ..models import prng

# the write-mode strings: the built-in WritePath registry names
WRITE_MODES = ("direct", "staged", "adaptive")


def make_decision(write_mode: str, n_regions: int,
                  hot_threshold: int) -> DecisionModule:
    """The decision plane of a write mode: the same-named built-in path and
    its default policy (direct -> always-offload, staged -> always-unload,
    adaptive -> frequency) over an exact monitor of ``n_regions`` pages."""
    if write_mode not in WRITE_MODES:
        raise ValueError(f"write_mode {write_mode!r} not in {WRITE_MODES}")
    _, module = build_decision(write_mode, n_regions=n_regions,
                               hot_threshold=hot_threshold)
    return module


@dataclasses.dataclass
class ServeConfig:
    """The JAX package's fields but ``drain_kernel``: here the device
    decides (a CUDA cache drains through ``staged_scatter``, a CPU cache
    through its plain version)."""

    max_seq: int
    write_mode: str = "direct"
    ring_size: int = 8
    page_size: int = 64          # page granularity for hotness accounting
    hot_threshold: int = 4       # counts above -> page considered hot
    greedy: bool = True


class ServeEngine:
    """Prefill + decode over the dense lanes cache of ``model`` (any family
    with ``prefill`` / ``decode_step``; staged and adaptive need the ring
    overlay of the dense ``DecoderLM``), on the model's device."""

    def __init__(self, model, cfg: ServeConfig, *, _internal: bool = False):
        if not _internal:
            raise TypeError(
                "build engines through "
                "repro_torch.serve.Engine.from_config(...)")
        if cfg.write_mode not in WRITE_MODES:
            raise ValueError(
                f"write_mode {cfg.write_mode!r} not in {WRITE_MODES}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        n_pages = max(1, cfg.max_seq // cfg.page_size)
        self.decision = make_decision(cfg.write_mode, n_pages,
                                      cfg.hot_threshold)
        self.page_monitor = self.decision.monitor
        self.mon_state = self.decision.init_state(self.device)
        self.stats = {"direct_writes": 0, "staged_writes": 0, "drains": 0}

    @property
    def _ring(self) -> bool:
        return self.cfg.write_mode != "direct"

    # ------------------------------------------------------------------
    def prefill(self, tokens, media=None) -> Tuple[torch.Tensor, Any]:
        """tokens [B, S] -> (last-token logits [B, V], cache); the cache
        gets a staging ring in the staged and adaptive modes. Prefill writes
        are dense and contiguous, so they stay on the offload path (the
        paper unloads only small scattered writes); they heat the page
        counters."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        kw = {"media": media} if media is not None else {}
        logits, cache = self.model.prefill(tokens, self.cfg.max_seq, **kw)
        if self._ring:
            cache = ST.add_ring(cache, self.cfg.ring_size)
        pages = torch.arange(tokens.shape[1],
                             device=self.device) // self.cfg.page_size
        self.mon_state = self.page_monitor.update(self.mon_state, pages)
        return logits, cache

    # ------------------------------------------------------------------
    def _step_slots(self, pos: torch.Tensor) -> torch.Tensor:
        return torch.clamp(pos, max=self.cfg.max_seq - 1)

    def _step(self, cache, tokens, pos):
        """One step's routing and drain decision, then the model step.
        Returns (logits, cache, unload mask, drained: a device bool)."""
        slots = self._step_slots(pos)
        batch = make_write_batch(slots // self.cfg.page_size)
        unload, self.mon_state, _ = self.decision(self.mon_state, batch)
        if self._ring:
            # drain BEFORE the append when the ring is out of room or this
            # step's destinations collide with pending entries (keeps a
            # drain's rows unique: the staged_scatter precondition)
            cache, drained = ST.maybe_drain(cache, incoming_slots=slots)
            logits, cache = self.model.decode_step(cache, tokens, pos,
                                                   unload_mask=unload)
        else:
            drained = None
            logits, cache = self.model.decode_step(cache, tokens, pos)
        return logits, cache, unload, drained

    @staticmethod
    def _next(logits: torch.Tensor, greedy: bool, key):
        """The next tokens and key: the argmax, or ``categorical`` with a
        subkey of ``key`` over the whole ``[B, V]`` draw (JAX's ``split``
        then ``categorical(sub, logits)``)."""
        if greedy:
            return torch.argmax(logits, dim=-1), key
        key, sub = prng.split(key)
        g = prng.gumbel(sub, logits.numel()).reshape(logits.shape)
        return torch.argmax(g + logits, dim=-1), key

    def _finish(self, cache, out, b):
        if self._ring:
            cache = ST.drain_ring(cache)
        if out:
            return torch.stack(out, dim=1), cache
        return torch.zeros((b, 0), dtype=torch.int64,
                           device=self.device), cache

    def decode(self, cache: Any, first_tokens, start_pos, n_steps: int,
               sample_key: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Any]:
        """Greedy (or, with ``sample_key`` and ``cfg.greedy`` False,
        sampled) decode loop. Returns (tokens [B, n_steps], cache). Model
        steps, ring drains, routing and telemetry stay on the device; the
        one host transfer is the counters' readback at the end (the tokens
        stay on the device)."""
        greedy = self.cfg.greedy or sample_key is None
        tokens = torch.as_tensor(first_tokens, device=self.device).long()
        start = torch.as_tensor(start_pos, device=self.device).long()
        b = tokens.shape[0]
        # direct, staged, drains
        counts = torch.zeros((3,), dtype=torch.int64, device=self.device)
        out = []
        for t in range(int(n_steps)):
            logits, cache, unload, drained = self._step(cache, tokens,
                                                        start + t)
            n_u = unload.sum()
            counts[0] += b - n_u
            counts[1] += n_u
            if drained is not None:
                counts[2] += drained.long()
            tokens, sample_key = self._next(logits, greedy, sample_key)
            out.append(tokens)
        toks, cache = self._finish(cache, out, b)
        d, s, n = counts.tolist()    # ONE readback per call
        self.stats["direct_writes"] += d
        self.stats["staged_writes"] += s
        self.stats["drains"] += n
        return toks, cache

    # ------------------------------------------------------------------
    def decode_reference(self, cache: Any, first_tokens, start_pos,
                         n_steps: int,
                         sample_key: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, Any]:
        """The per-step loop with a host read of the counters each step:
        the parity oracle for :meth:`decode` and the benchmark's
        baseline."""
        greedy = self.cfg.greedy or sample_key is None
        tokens = torch.as_tensor(first_tokens, device=self.device).long()
        start = torch.as_tensor(start_pos, device=self.device).long()
        b = tokens.shape[0]
        out = []
        for t in range(int(n_steps)):
            logits, cache, unload, drained = self._step(cache, tokens,
                                                        start + t)
            if drained is not None:
                self.stats["drains"] += int(drained)        # host sync
                n_u = int(unload.sum())                     # host sync
                self.stats["staged_writes"] += n_u
                self.stats["direct_writes"] += b - n_u
            else:
                self.stats["direct_writes"] += b
            tokens, sample_key = self._next(logits, greedy, sample_key)
            out.append(tokens)
        return self._finish(cache, out, b)

    # ------------------------------------------------------------------
    def generate(self, prompt, n_steps: int, media=None,
                 sample_key: Optional[torch.Tensor] = None,
                 reference: bool = False) -> torch.Tensor:
        """Prefill + decode: prompt [B, S] -> tokens [B, n_steps] (the
        prefill's argmax first)."""
        prompt = torch.as_tensor(prompt, device=self.device).long()
        logits, cache = self.prefill(prompt, media)
        first = torch.argmax(logits, dim=-1)
        start = torch.full((first.shape[0],), prompt.shape[1],
                           dtype=torch.int64, device=self.device)
        step = self.decode_reference if reference else self.decode
        toks, cache = step(cache, first, start, n_steps - 1, sample_key)
        if self._ring:
            cache = ST.strip_ring(cache)
        return torch.cat([first[:, None], toks], dim=1)


__all__ = ["WRITE_MODES", "ServeConfig", "ServeEngine", "make_decision"]
