"""Port of repro/serve/traffic/workload.py: open-loop workload generation.

* **Clocks**: :class:`VirtualClock` makes the traffic stack wall-clock-free.
  The queue stamps arrivals from it, the scheduler stamps first tokens from
  it, and the loadtest harness advances it per segment from a
  :class:`SegmentCostModel` built on the paper's path latencies
  (``core.types.LatencyModel``). ``clock=None`` everywhere means wall
  ``time.perf_counter``. Virtual seconds are model time, not device time.
* **Request classes**: :class:`RequestClass` is a tenant contract, an SLO
  (TTFT and ITL targets), a priority, and prompt / output length
  distributions.
* **Arrival processes**: open-loop timestamp generators, Poisson,
  Markov-modulated Poisson (two rate states) and trace replay. Everything
  is a pure function of a numpy ``RandomState``, drawn in the JAX package's
  order, so the arrays equal the JAX package's exactly.

JSONL trace schema (one request per line)::

    {"arrival_s": 0.0012, "tenant": "interactive", "prompt_len": 8,
     "max_tokens": 8, "temperature": 0.0, "seed": null, "priority": 1,
     "ttft_slo_s": 0.004, "itl_slo_s": 0.002, "prompt": [1, 2, 3]}

``prompt`` is optional: without it a deterministic splitmix prompt of
``prompt_len`` tokens is made from the line index.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...core.types import LatencyModel
from ...data.pipeline import RequestQueue, _splitmix
from ...models.sampling import SamplingParams

__all__ = [
    "VirtualClock",
    "RequestClass",
    "TimedRequest",
    "ArrivalProcess",
    "PoissonArrivals",
    "MarkovModulatedArrivals",
    "TraceArrivals",
    "SegmentCostModel",
    "generate_workload",
    "load_trace",
    "save_trace",
    "make_queue",
]


class VirtualClock:
    """A manually-advanced clock with the same calling convention as
    ``time.perf_counter`` — plug it into ``RequestQueue(clock=...)`` and
    ``BatchedServeEngine.clock`` and the whole serving stack runs in
    virtual time. The loadtest harness advances it per segment by
    the :class:`SegmentCostModel`; ``advance_to`` fast-forwards idle
    gaps to the next arrival."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"VirtualClock.advance({dt}): time only "
                             f"moves forward")
        self.t += dt
        return self.t

    def advance_to(self, t: float) -> float:
        self.t = max(self.t, float(t))
        return self.t

    def __repr__(self) -> str:
        return f"VirtualClock(t={self.t:.6f})"


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One tenant's latency contract + workload shape.

    ``prompt_len`` / ``max_tokens`` may be an int (constant) or an
    ``(lo, hi)`` tuple (uniform-integer, inclusive). ``temperature`` /
    ``seed`` feed each request's ``SamplingParams`` (seed=None keeps the
    engine's per-request key derivation, which is what makes token
    streams independent of scheduling order). ``weight`` is the class's
    share of the arrival mix."""

    name: str
    ttft_slo_s: float
    itl_slo_s: float
    priority: int = 0
    prompt_len: Union[int, Tuple[int, int]] = 8
    max_tokens: Union[int, Tuple[int, int]] = 8
    temperature: Optional[float] = None
    seed: Optional[int] = None
    weight: float = 1.0

    def _draw(self, spec, rng: np.random.RandomState) -> int:
        if isinstance(spec, (tuple, list)):
            lo, hi = spec
            return int(rng.randint(int(lo), int(hi) + 1))
        return int(spec)

    def draw_prompt_len(self, rng: np.random.RandomState) -> int:
        return self._draw(self.prompt_len, rng)

    def draw_max_tokens(self, rng: np.random.RandomState) -> int:
        return self._draw(self.max_tokens, rng)


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """One generated arrival: everything ``RequestQueue.submit`` needs,
    plus the class handle for SLO accounting."""

    arrival_s: float
    prompt: np.ndarray
    params: SamplingParams
    tenant: str
    priority: int
    deadline_s: float
    ttft_slo_s: float
    itl_slo_s: float


class ArrivalProcess:
    """Base arrival-time generator: ``times(n, rng)`` returns ``n``
    sorted arrival instants (seconds from 0). Subclasses are pure
    functions of (their parameters, the rng state passed in)."""

    def times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Open-loop Poisson process: iid exponential inter-arrival gaps at
    ``rate_rps`` requests/second."""

    rate_rps: float

    def times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        gaps = rng.exponential(1.0 / self.rate_rps, size=n)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class MarkovModulatedArrivals(ArrivalProcess):
    """Bursty two-state Markov-modulated Poisson process: a calm state
    at ``calm_rps`` and a burst state at ``burst_rps``, with
    exponentially distributed dwell times (``mean_calm_s`` /
    ``mean_burst_s``). The burst state models the flash crowds that
    separate goodput-under-SLO from raw throughput."""

    calm_rps: float
    burst_rps: float
    mean_calm_s: float
    mean_burst_s: float

    def times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        for nm, v in (("calm_rps", self.calm_rps),
                      ("burst_rps", self.burst_rps),
                      ("mean_calm_s", self.mean_calm_s),
                      ("mean_burst_s", self.mean_burst_s)):
            if v <= 0:
                raise ValueError(f"{nm} must be > 0, got {v}")
        out = np.empty((n,), np.float64)
        t = 0.0
        burst = False
        # time left in the current modulating state
        dwell = rng.exponential(self.mean_calm_s)
        for i in range(n):
            while True:
                rate = self.burst_rps if burst else self.calm_rps
                gap = rng.exponential(1.0 / rate)
                if gap <= dwell:
                    dwell -= gap
                    t += gap
                    break
                # state flips before the next arrival would land: advance
                # to the boundary and redraw in the new state (the
                # memoryless property makes the redraw exact)
                t += dwell
                burst = not burst
                dwell = rng.exponential(
                    self.mean_burst_s if burst else self.mean_calm_s)
            out[i] = t
        return out


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Deterministic replay of explicit arrival instants."""

    arrival_s: Tuple[float, ...]

    def times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        if n > len(self.arrival_s):
            raise ValueError(
                f"trace holds {len(self.arrival_s)} arrivals, {n} asked")
        t = np.asarray(self.arrival_s[:n], np.float64)
        if np.any(np.diff(t) < 0):
            raise ValueError("trace arrival times must be sorted")
        return t


@dataclasses.dataclass(frozen=True)
class SegmentCostModel:
    """Virtual time one segment costs, from the engine's per-segment write
    telemetry: the paper's Fig. 3 latency model lifted to segment
    granularity. Every constant is a model constant (``LatencyModel``
    carries the paper's per-path microseconds), not a device measurement.

    Scattered direct (offload) writes pay a cost between the paper's MTT
    hit (~2.6 us) and its Zipf-mix miss average (~5.1 us), interpolated by
    the direct share of the scattered stream; staged (unload) writes pay
    the flat writeImm + copy cost (~3.4 us); each ring drain adds
    ``t_drain_us``; bulk prefill rows pay the hit cost; each COMMITTED
    token adds ``t_token_us`` of model compute; ``t_segment_us`` is the
    per-segment dispatch overhead.
    """

    lat: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    t_drain_us: float = 5.0
    t_segment_us: float = 50.0
    t_token_us: float = 0.5      # per committed token: model step compute

    def __call__(self, seg: dict) -> float:
        d = float(seg.get("direct", 0))
        s = float(seg.get("staged", 0))
        scattered = d + s
        pressure = d / scattered if scattered else 0.0
        c_direct = (self.lat.t_offload_hit
                    + (self.lat.t_offload_miss - self.lat.t_offload_hit)
                    * pressure)
        us = (d * c_direct
              + s * self.lat.t_unload_base
              + float(seg.get("drains", 0)) * self.t_drain_us
              + float(seg.get("prefill", 0)) * self.lat.t_offload_hit
              + float(seg.get("committed", 0)) * self.t_token_us
              + self.t_segment_us)
        return us * 1e-6


def _class_prompt(seed: int, index: int, plen: int, vocab: int) -> np.ndarray:
    """Deterministic splitmix prompt — same generator family as
    ``synthetic_requests`` so any (seed, index) pair reproduces the same
    prompt on any host."""
    idx = np.arange(plen, dtype=np.int64) + index * 65537
    return (_splitmix(idx + seed * 2654435761 + 97) % vocab).astype(np.int32)


def generate_workload(
    classes: Sequence[RequestClass],
    process: ArrivalProcess,
    n: int,
    *,
    vocab: int,
    seed: int = 0,
) -> List[TimedRequest]:
    """``n`` timestamped requests: arrival instants from ``process``,
    each arrival assigned a class by weight, prompt/output lengths drawn
    from the class distributions. Deterministic in ``seed``."""
    if not classes:
        raise ValueError("generate_workload needs at least one RequestClass")
    rng = np.random.RandomState(seed)
    times = process.times(n, rng)
    w = np.asarray([c.weight for c in classes], np.float64)
    if np.any(w <= 0):
        raise ValueError("RequestClass.weight must be > 0")
    picks = rng.choice(len(classes), size=n, p=w / w.sum())
    out: List[TimedRequest] = []
    for i in range(n):
        c = classes[int(picks[i])]
        plen = c.draw_prompt_len(rng)
        mt = c.draw_max_tokens(rng)
        params = SamplingParams(temperature=c.temperature, max_tokens=mt,
                                seed=c.seed)
        t = float(times[i])
        out.append(TimedRequest(
            arrival_s=t,
            prompt=_class_prompt(seed, i, plen, vocab),
            params=params,
            tenant=c.name,
            priority=c.priority,
            deadline_s=t + c.ttft_slo_s,
            ttft_slo_s=c.ttft_slo_s,
            itl_slo_s=c.itl_slo_s,
        ))
    return out


def save_trace(path: str, workload: Sequence[TimedRequest]) -> None:
    """Write a workload as a JSONL trace (the schema in the module
    docstring), prompts inlined so replay is bit-exact."""
    with open(path, "w") as f:
        for r in workload:
            f.write(json.dumps({
                "arrival_s": r.arrival_s,
                "tenant": r.tenant,
                "priority": r.priority,
                "ttft_slo_s": r.ttft_slo_s,
                "itl_slo_s": r.itl_slo_s,
                "max_tokens": r.params.max_tokens,
                "temperature": r.params.temperature,
                "seed": r.params.seed,
                "prompt": [int(t) for t in r.prompt],
            }) + "\n")


def load_trace(path: str, *, vocab: int) -> List[TimedRequest]:
    """Replay a JSONL trace into :class:`TimedRequest` objects. Lines
    without an explicit ``prompt`` synthesize a deterministic one of
    ``prompt_len`` tokens from the line index."""
    out: List[TimedRequest] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "arrival_s" not in doc:
                raise ValueError(
                    f"{path}:{i + 1}: trace line needs 'arrival_s'")
            if "prompt" in doc:
                prompt = np.asarray(doc["prompt"], np.int32)
            elif "prompt_len" in doc:
                prompt = _class_prompt(0, i, int(doc["prompt_len"]), vocab)
            else:
                raise ValueError(
                    f"{path}:{i + 1}: trace line needs 'prompt' or "
                    f"'prompt_len'")
            t = float(doc["arrival_s"])
            ttft_slo = float(doc.get("ttft_slo_s", math.inf))
            out.append(TimedRequest(
                arrival_s=t,
                prompt=prompt,
                params=SamplingParams(
                    temperature=doc.get("temperature"),
                    max_tokens=int(doc.get("max_tokens", 8)),
                    seed=doc.get("seed")),
                tenant=str(doc.get("tenant", "default")),
                priority=int(doc.get("priority", 0)),
                deadline_s=t + ttft_slo,
                ttft_slo_s=ttft_slo,
                itl_slo_s=float(doc.get("itl_slo_s", math.inf)),
            ))
    if any(b.arrival_s < a.arrival_s for a, b in zip(out, out[1:])):
        raise ValueError(f"{path}: trace arrival times must be sorted")
    return out


def make_queue(clock: Optional[Callable[[], float]] = None) -> RequestQueue:
    """A ``RequestQueue`` on the given clock (virtual or wall) — the
    queue the harness injects :class:`TimedRequest` arrivals into."""
    return RequestQueue(clock=clock)
