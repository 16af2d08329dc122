"""Port of repro/data/pipeline.py.

Serving: ``Request``, the FIFO ``RequestQueue`` that feeds the serve
scheduler's admissions, and ``synthetic_requests``, the deterministic
request workload (splitmix-hashed prompts: every (seed, i) pair reproduces
the same request on any host, and the same prompts as the JAX package's
generator).

Training: the sharded, deterministic, restartable token pipeline.
``SyntheticSource`` (token i = splitmix hash of its global index, so every
(step, host) pair gives the JAX package's batch bit for bit, with no files),
``MemmapSource`` (a flat int32 token file, rows drawn round-robin) and
``Pipeline``, a prefetching iterator over a source whose batches are a pure
function of the step: ``skip_to(step)`` resumes in O(1). Batches are numpy
(``tokens`` / ``labels`` int32 ``[host_batch, seq_len]``); the trainer moves
them to the device.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
import warnings
from typing import Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np

from ..models.sampling import SamplingParams


def _splitmix(x: np.ndarray) -> np.ndarray:
    """64-bit splitmix hash, vectorized (deterministic synthetic tokens)."""
    x = (x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return (x ^ (x >> np.uint64(31))).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    # sharding over hosts: this host handles [host_index, num_hosts)
    num_hosts: int = 1
    host_index: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


class SyntheticSource:
    """Deterministic token stream: token[i] = splitmix-style hash of i."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        # global token offsets for this host's rows at this step
        row0 = step * cfg.global_batch + cfg.host_index * b
        rows = row0 + np.arange(b, dtype=np.int64)[:, None]
        idx = rows * (s + 1) + np.arange(s + 1, dtype=np.int64)[None, :]
        toks = _splitmix(idx + cfg.seed) % cfg.vocab
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class MemmapSource:
    """Flat int32 token file; rows are drawn round-robin over the file."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.n_rows = (len(self.tokens) - 1) // cfg.seq_len
        if self.n_rows <= 0:
            raise ValueError(f"{path}: too few tokens for seq_len={cfg.seq_len}")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        row0 = step * cfg.global_batch + cfg.host_index * b
        out_t = np.empty((b, s), np.int32)
        out_l = np.empty((b, s), np.int32)
        for i in range(b):
            r = (row0 + i) % self.n_rows
            chunk = self.tokens[r * s: r * s + s + 1]
            out_t[i] = chunk[:-1]
            out_l[i] = chunk[1:]
        return {"tokens": out_t, "labels": out_l}


class Pipeline:
    """Prefetching iterator over a source, restartable at any step. Without
    ``start()`` it reads each batch when asked; started, a thread keeps up
    to ``prefetch`` batches ready."""

    def __init__(self, source, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _worker(self, stop: threading.Event, q: "queue.Queue"):
        # stop / q are bound at thread start: a worker that outlives its
        # epoch (join timeout in stop()) keeps seeing its own set event and
        # its own orphaned queue, and never publishes a stale batch into a
        # restarted pipeline
        s = self.step
        while not stop.is_set():
            batch = self.source.batch_at(s)
            while not stop.is_set():
                try:
                    q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def start(self) -> "Pipeline":
        self._thread = threading.Thread(
            target=self._worker, args=(self._stop, self._q), daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # unblock a put() stuck on a full queue
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2)
            self._thread = None
            # retire this epoch's queue: the worker may still complete one
            # put() on its way out; a restart must never serve it
            self._q = queue.Queue(maxsize=self._q.maxsize)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.source.batch_at(self.step)
            self.step += 1
            return batch
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def skip_to(self, step: int):
        """O(1) resume: the source is a pure function of step."""
        was_running = self._thread is not None
        if was_running:
            self.stop()
            self._stop = threading.Event()
        self.step = step
        if was_running:
            self.start()


@dataclasses.dataclass
class Request:
    """One serving request: a prompt plus its per-request
    ``SamplingParams`` (temperature / top-k / top-p / max_tokens / stop
    set / seed — ``repro_torch.models.sampling``).

    ``params.max_tokens`` counts EVERY emitted token, including the one
    the prefill produces; the scheduler retires the request after
    ``max_tokens`` tokens or on a stop token, whichever comes first.

    Open-loop traffic fields (the open-loop traffic layer): ``arrival_s`` is
    the queue-entry timestamp on the queue's clock (wall perf_counter by
    default, a virtual clock under the loadtest harness) — TTFT-from-
    arrival and deadline scheduling are measured against it. ``tenant``
    names the request class (its SLO lives on the class, not here),
    ``priority`` orders ``sched/priority`` admission (higher first) and
    selects preemption victims, ``deadline_s`` is the absolute deadline
    ``sched/deadline`` EDF-orders on (default: no deadline).
    """

    req_id: int
    prompt: np.ndarray               # int32 [plen]
    params: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    media: Optional[np.ndarray] = None
    arrival_s: float = 0.0
    tenant: str = "default"
    priority: int = 0
    deadline_s: float = math.inf

    def __post_init__(self):
        if isinstance(self.params, int):
            # deprecation shim: older code constructed
            # Request(rid, prompt, max_new) with a bare budget in the
            # third slot; coerce it so those scripts keep running
            warnings.warn(
                "Request(..., max_new) is deprecated; pass "
                "params=SamplingParams(max_tokens=...) instead",
                DeprecationWarning, stacklevel=3)
            self.params = SamplingParams(max_tokens=self.params)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])

    @property
    def max_new(self) -> int:
        """Legacy alias for ``params.max_tokens``."""
        return self.params.max_tokens


class RequestQueue:
    """FIFO request queue feeding the serve scheduler's admissions.

    Arrival order is authoritative: the scheduler scans from the head and
    admits the FIRST request that fits, skipping (``at``/``pop_at``) past
    ones whose resources can't be covered right now — a skipped request
    keeps its queue position and is admitted as soon as it fits, so
    relative order among admissible requests is preserved without
    head-of-line blocking. Host-side and unsynchronized by design —
    admission happens between scan segments on one thread.

    Every ``submit`` stamps ``Request.arrival_s`` from the queue's
    ``clock`` (``time.perf_counter`` by default; pass a
    a virtual clock for wall-clock-free tests and
    the loadtest harness's virtual-time mode) unless the caller supplies
    an explicit ``arrival_s`` — trace replay injects requests after their
    nominal arrival instant and must keep the trace's timestamp.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._q: "collections.deque[Request]" = collections.deque()
        self._next_id = 0
        self.clock: Callable[[], float] = (
            clock if clock is not None else time.perf_counter)

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, prompt, max_new: Optional[int] = None, media=None,
               params: Optional[SamplingParams] = None, *,
               arrival_s: Optional[float] = None, tenant: str = "default",
               priority: int = 0, deadline_s: float = math.inf) -> int:
        """Enqueue one request; returns its id (submission order).

        ``params`` carries the per-request sampling knobs; the legacy
        ``max_new`` argument overrides ``params.max_tokens`` when given
        (``submit(prompt, 8)`` keeps meaning what it always did).
        ``tenant``/``priority``/``deadline_s`` are the open-loop traffic
        fields (see :class:`Request`); ``arrival_s`` overrides the
        clock-stamped queue-entry time (trace replay).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if params is None:
            if max_new is None:
                raise ValueError("submit needs max_new or params")
            params = SamplingParams(max_tokens=int(max_new))
        elif max_new is not None:
            params = dataclasses.replace(params, max_tokens=int(max_new))
        rid = self._next_id
        self._next_id += 1
        self._q.append(Request(
            rid, prompt, params, media,
            arrival_s=(self.clock() if arrival_s is None
                       else float(arrival_s)),
            tenant=tenant, priority=int(priority),
            deadline_s=float(deadline_s)))
        return rid

    def peek(self) -> Request:
        return self._q[0]

    def pop(self) -> Request:
        return self._q.popleft()

    def at(self, i: int) -> Request:
        """The i-th waiting request (0 = head), submission order."""
        return self._q[i]

    def pop_at(self, i: int) -> Request:
        """Remove and return the i-th waiting request; later requests keep
        their relative order (the scheduler's skip-ahead admission)."""
        if i == 0:
            return self._q.popleft()
        self._q.rotate(-i)
        req = self._q.popleft()
        self._q.rotate(i)
        return req

    def requeue(self, req: Request) -> None:
        """Push an already-issued request back at the HEAD of the queue —
        the preempt-and-requeue re-entry point (``sched/preempt``). The
        request keeps its id, arrival stamp, and traffic fields, so its
        TTFT/deadline accounting is unbroken by the round trip."""
        self._q.appendleft(req)


def synthetic_requests(
    n: int,
    prompt_len,
    vocab: int,
    max_new: int,
    seed: int = 0,
    media_shape=None,
    params: Union[SamplingParams, Sequence[SamplingParams], None] = None,
    shared_prefix: int = 0,
) -> RequestQueue:
    """Deterministic request workload (splitmix-hashed prompts — the same
    generator the synthetic training source uses, so every (seed, i) pair
    reproduces the same request on any host).

    ``prompt_len`` may be a sequence: request ``i`` gets length
    ``prompt_len[i % len(prompt_len)]`` — the mixed long/short-prompt
    workload the chunked-prefill scheduler and its benchmark exercise
    (request ``i``'s prompt is the same for any surrounding mix).

    ``params`` threads per-request SamplingParams through the queue: one
    object applies to every request, a sequence assigns request ``i``
    ``params[i % len(params)]`` (cycled like ``prompt_len``), and each
    request's own ``max_tokens`` is honored; ``max_new`` applies only
    when ``params`` is None. Prompt generation is independent of the
    sampling mix either way.

    ``shared_prefix > 0`` makes every request open with the SAME
    ``shared_prefix`` leading tokens (a system prompt), each followed by
    its usual per-request tail — the shared-prefix workload the
    prefix-cache path and its benchmark exercise. The prefix stream is a
    function of ``seed`` only, so warm and cold engines see identical
    prompts.
    """
    plens = (list(prompt_len) if hasattr(prompt_len, "__len__")
             else [int(prompt_len)])
    plist = (None if params is None
             else (list(params) if hasattr(params, "__len__")
                   else [params]))
    pfx = None
    if shared_prefix:
        pidx = np.arange(int(shared_prefix), dtype=np.int64)
        pfx = (_splitmix(pidx + seed * 7919 + 104729) % vocab).astype(
            np.int32)
    q = RequestQueue()
    for i in range(n):
        plen = int(plens[i % len(plens)])
        idx = np.arange(plen, dtype=np.int64) + i * plen
        prompt = (_splitmix(idx + seed) % vocab).astype(np.int32)
        if pfx is not None:
            keep = min(len(pfx), plen)
            prompt = np.concatenate([pfx[:keep], prompt[: plen - keep]])
        media = None
        if media_shape is not None:
            flat = _splitmix(
                np.arange(int(np.prod(media_shape)), dtype=np.int64)
                + (seed + 1) * (i + 1)
            )
            media = (flat % 1024).astype(np.float32).reshape(media_shape) / 512.0 - 1.0
        if plist is None:
            q.submit(prompt, max_new, media=media)
        else:
            q.submit(prompt, media=media, params=plist[i % len(plist)])
    return q
