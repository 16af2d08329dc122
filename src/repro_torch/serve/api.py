"""Port of repro/serve/api.py: the serving front door.

``Engine.from_config(EngineConfig(...))``: cache layout, the write
path/policy pair and the read implementation are CONFIG, not class choice;
the offload/unload machinery stays pluggable behind one request/response
surface (the paper's two-path contract, served through the
``repro_torch.core.paths`` registry).

Requests are ``(prompt, SamplingParams)`` pairs; results are
:class:`Completion` objects carrying per-request telemetry: TTFT, finish
reason, and the write-path split (direct / staged / prefill counts) the
request's KV writes took. ``Engine.stream`` yields tokens as segments retire
them; ``Engine.generate`` drains to completion.

**Device rule.** ``EngineConfig.device`` defaults to ``"cuda"``: entry
points run on the GPU unless the caller passes ``device="cpu"``, and
``device="cuda"`` on a machine without CUDA raises.

>>> eng = Engine.from_config(EngineConfig(arch="stablelm-1.6b", max_seq=64))
>>> [c] = eng.generate([[1, 2, 3]], SamplingParams(max_tokens=8))
>>> c.tokens, c.ttft_s, c.path_counts
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..core.paths import (AttentionConfig, MemoryConfig, ParallelConfig,
                          SpecConfig, normalize_groups, resolve_device)
from ..models.sampling import SamplingParams
from .scheduler import BatchConfig, BatchedServeEngine

__all__ = [
    "AttentionConfig", "Completion", "Engine", "EngineConfig",
    "MemoryConfig", "ParallelConfig", "SpecConfig", "StreamEvent",
    "build_model_and_params",
]


def build_model_and_params(arch: str, max_seq: int = 0, *, seed: int = 0,
                           reduced: bool = True, device="cuda"):
    """(cfg, model) for a registered architecture, weights initialised from
    ``seed`` on ``device``. The parameters live in the model (an
    ``nn.Module``), so there is no separate params tree to return."""
    from ..configs import get_config
    from ..models import build_model

    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev).init(seed)
    return cfg, model


@dataclasses.dataclass
class EngineConfig:
    """Everything ``Engine.from_config`` needs: model choice, scheduler
    shape, write path/policy, sampling defaults and the device.

    ``path``/``policy`` name entries in the ``repro_torch.core.paths`` /
    ``repro_torch.core.policy`` registries. ``attention`` is an
    ``AttentionConfig`` or its ``impl`` string. ``device`` is where the
    engine runs: ``"cuda"`` (the default) raises when CUDA is unavailable,
    ``"cpu"`` is for tests. ``kv_layout="auto"`` picks ``paged`` for the
    linear-addressed dense decoders and ``lanes`` for a sliding-window one
    and for the MoE family (direct writes only). ``chunked`` prefills in ``chunk_size``-token
    pieces (inside the segments on paged, at admission on lanes).
    ``memory=MemoryConfig(prefix_cache=True)`` (paged, chunked) shares
    cached prompt pages; ``MemoryConfig(host_tier=True)`` (paged) parks
    whole slots in host memory when the pool runs short. ``sched`` names an
    admission policy (``fifo``, ``sched/priority``, ``sched/deadline``,
    ``sched/preempt``, the last with the host tier). ``default_params``
    applies to requests without their own, and its temperature backfills a
    request's unset one; ``sample_seed`` seeds the per-request key chains.
    ``parallel=ParallelConfig.tensor(tp)`` (paged layout) splits the block
    pool and the staging ring on the head axis across ``tp`` devices
    (DESIGN.md §9; ``REPRO_TORCH_VIRTUAL_DEVICES`` gives virtual ones on
    ``device``); the tokens and the telemetry are the unsharded engine's.
    ``spec=SpecConfig(enabled=True, k=...)`` (paged layout) turns the
    decode segments into draft-then-verify rounds (DESIGN.md §11): the
    draft (``draft_arch``, or the target itself when ``None``) proposes
    ``k`` tokens per slot and the target verifies them in one chunked
    step; greedy streams are the non-speculative engine's."""

    max_seq: int
    arch: Optional[str] = None        # None when a model is passed
    reduced: bool = True
    init_seed: int = 0
    # scheduler shape
    n_slots: int = 8
    segment_len: int = 16
    chunked: bool = False
    chunk_size: int = 8
    kv_layout: str = "auto"           # auto | paged | lanes
    # write path + decision plane (registry names)
    path: str = "direct"
    policy: Optional[str] = None
    sched: str = "fifo"
    page_size: int = 8
    n_blocks: int = 0
    ring_size: int = 8
    hot_threshold: int = 4
    attention: Any = None             # AttentionConfig (str = impl shorthand)
    # sampling
    default_params: Optional[SamplingParams] = None
    eos_id: Optional[int] = None
    sample_seed: int = 0
    # grouped sub-configs
    memory: Optional[MemoryConfig] = None
    parallel: Any = None
    spec: Optional[SpecConfig] = None
    # where the engine runs
    device: str = "cuda"

    def __post_init__(self):
        normalize_groups(self)
        resolve_device(self.device)  # "cuda" without CUDA raises here

    def batch_config(self) -> BatchConfig:
        d = self.default_params
        return BatchConfig(
            max_seq=self.max_seq, n_slots=self.n_slots,
            segment_len=self.segment_len, page_size=self.page_size,
            n_blocks=self.n_blocks, ring_size=self.ring_size,
            hot_threshold=self.hot_threshold,
            greedy=(d is None or d.temperature is None
                    or d.temperature == 0.0),
            eos_id=self.eos_id, attention=self.attention,
            kv_layout=self.kv_layout, sample_seed=self.sample_seed,
            chunked=self.chunked, chunk_size=self.chunk_size,
            path=self.path, policy=self.policy, sched=self.sched,
            memory=self.memory, parallel=self.parallel, spec=self.spec,
            default_params=d, device=self.device,
        )


@dataclasses.dataclass
class Completion:
    """One finished request, with its telemetry.

    tokens        the emitted stream (np.int32, includes the prefill token)
    params        the request's RESOLVED SamplingParams
    ttft_s        seconds from request ARRIVAL (queue-entry timestamp) to
                  the first emitted token
    ttft_serve_s  seconds from serve start to the first emitted token
    finish_reason ``"stop"`` (stop-token hit) or ``"length"`` (budget)
    path_counts   how this request's KV writes were routed:
                  {"direct", "staged", "prefill"}
    """

    req_id: int
    tokens: np.ndarray
    params: SamplingParams
    ttft_s: float
    ttft_serve_s: float
    finish_reason: str
    path_counts: Dict[str, int]

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class StreamEvent:
    """One streaming update: the tokens a request gained in the latest
    segment, plus its :class:`Completion` once it finishes."""

    req_id: int
    tokens: np.ndarray                 # the NEW tokens this event
    done: bool
    completion: Optional[Completion] = None


class Engine:
    """The one serving front door. Construct via :meth:`from_config`; the
    underlying scheduler is reachable at ``engine.scheduler``."""

    def __init__(self, model, cfg: EngineConfig):
        self.cfg = cfg
        self.model = model
        self.scheduler = BatchedServeEngine(
            model, cfg.batch_config(), _internal=True)

    @classmethod
    def from_config(cls, cfg: EngineConfig, model=None) -> "Engine":
        """Build the engine from config alone (``cfg.arch`` names a
        registered architecture; weights from ``cfg.init_seed``) or around
        an existing model that already lives on ``cfg.device``."""
        if model is None:
            if cfg.arch is None:
                raise ValueError(
                    "EngineConfig.arch is required when no model is passed")
            _, model = build_model_and_params(
                cfg.arch, cfg.max_seq, seed=cfg.init_seed,
                reduced=cfg.reduced, device=cfg.device)
        return cls(model, cfg)

    # ------------------------------------------------------------------
    @property
    def layout(self) -> str:
        return self.scheduler.layout

    @property
    def attention(self) -> str:
        """The resolved read implementation: ``fused`` or ``reference``."""
        return self.scheduler.attention

    @property
    def stats(self) -> Dict[str, int]:
        return self.scheduler.stats

    @property
    def ttft(self) -> Dict[int, float]:
        return self.scheduler.ttft

    def reset(self, keep_cache: bool = False) -> None:
        """Fresh serving state (cache, slots, pool, monitor, outputs).
        ``keep_cache=True`` keeps the block pool + device cache so
        registered prefix blocks stay reusable (warm re-serve)."""
        self.scheduler.reset(keep_cache=keep_cache)

    # ------------------------------------------------------------------
    def _make_queue(self, prompts: Sequence, params):
        from ..data.pipeline import RequestQueue

        n = len(prompts)
        if params is None or isinstance(params, SamplingParams):
            plist = [params] * n
        else:
            plist = list(params)
            if len(plist) != n:
                raise ValueError(
                    f"{len(plist)} SamplingParams for {n} prompts")
        q = RequestQueue()
        for prompt, p in zip(prompts, plist):
            q.submit(prompt,
                     params=p or self.cfg.default_params or SamplingParams())
        return q

    def _completion(self, rid: int) -> Completion:
        eng = self.scheduler
        tokens = np.asarray(eng.outputs[rid], np.int32)
        params = eng.req_params[rid]
        stop = set(params.stop_token_ids)
        if self.cfg.eos_id is not None:
            stop.add(self.cfg.eos_id)
        reason = ("stop" if len(tokens) and int(tokens[-1]) in stop
                  else "length")
        d, s, p = (int(x) for x in eng.req_writes[rid])
        ttft_serve = float(eng.ttft.get(rid, 0.0))
        if rid in eng.first_token_t and rid in eng.req_arrival:
            ttft = float(eng.first_token_t[rid] - eng.req_arrival[rid])
        else:
            ttft = ttft_serve
        return Completion(
            req_id=rid, tokens=tokens, params=params, ttft_s=ttft,
            ttft_serve_s=ttft_serve, finish_reason=reason,
            path_counts={"direct": d, "staged": s, "prefill": p},
        )

    # ------------------------------------------------------------------
    def stream(self, prompts: Sequence, params: Union[
            SamplingParams, Sequence[Optional[SamplingParams]], None] = None,
            max_segments: int = 100_000) -> Iterator[StreamEvent]:
        """Serve ``prompts`` and yield :class:`StreamEvent`s as segments
        emit tokens. The final event for a request has ``done=True`` and its
        :class:`Completion`."""
        queue = self._make_queue(prompts, params)
        yield from self.serve_stream(queue, max_segments=max_segments)

    def serve_stream(self, queue, max_segments: int = 100_000,
                     ) -> Iterator[StreamEvent]:
        """``stream`` over an explicit ``RequestQueue``."""
        eng = self.scheduler
        if eng.outputs:
            eng.reset()
        if eng._t_serve0 is None:
            eng._t_serve0 = eng._now()
        sent: Dict[int, int] = {}
        finished: set = set()

        def drain_events(done_flags):
            # report in request order for determinism; done-ness comes
            # from the slot state (retirement happens next loop turn)
            done_now = {eng._slot_req[s]
                        for s in range(eng.cfg.n_slots)
                        if eng._occupied[s] and bool(done_flags[s])}
            for rid in sorted(eng.outputs):
                if rid in finished:
                    continue
                new = eng.outputs[rid][sent.get(rid, 0):]
                is_done = rid in done_now
                if new or is_done:
                    sent[rid] = len(eng.outputs[rid])
                    completion = None
                    if is_done:
                        finished.add(rid)
                        completion = self._completion(rid)
                    yield StreamEvent(
                        req_id=rid, tokens=np.asarray(new, np.int32),
                        done=is_done, completion=completion)

        for _ in range(max_segments):
            eng.retire_done()
            eng.admit(queue)
            if not any(eng._occupied):
                if len(queue) == 0:
                    return
                raise RuntimeError(
                    "queue head unadmittable with an empty engine "
                    "(request larger than pool capacity?)")
            live = ~eng.done_flags() & np.asarray(eng._occupied)
            if live.any():
                eng.run_topped_up_segment(live)
            yield from drain_events(eng.done_flags())
        raise RuntimeError(f"stream() exceeded {max_segments} segments")

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence, params: Union[
            SamplingParams, Sequence[Optional[SamplingParams]], None] = None,
            ) -> List[Completion]:
        """Serve ``prompts`` to completion; returns one :class:`Completion`
        per prompt, in submission order."""
        done = {ev.req_id: ev.completion
                for ev in self.stream(prompts, params) if ev.done}
        return [done[rid] for rid in sorted(done)]

    def serve(self, queue, max_segments: int = 100_000,
              ) -> Dict[int, np.ndarray]:
        """Drain an explicit ``RequestQueue``; returns {req_id: tokens}."""
        return self.scheduler.serve(queue, max_segments=max_segments)

    def completions(self) -> Dict[int, Completion]:
        """Completions for every request served so far (post ``serve``)."""
        return {rid: self._completion(rid)
                for rid in self.scheduler.outputs}
