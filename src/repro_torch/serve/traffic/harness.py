"""Port of repro/serve/traffic/harness.py: the open-loop loadtest runner
and its SLO / goodput accounting.

Requests enter the queue when the clock passes their arrival instant, never
when the server is ready for them (open loop: queue depth is an output).
Two clock modes:

* **virtual** (default): a :class:`~.workload.VirtualClock` shared by the
  queue and the scheduler; ``run_segment`` advances it through a
  :class:`~.workload.SegmentCostModel` and idle gaps fast-forward to the
  next arrival. Deterministic: the same timeline on any machine. Its
  seconds are model time, not device time.
* **wall**: ``time.perf_counter`` everywhere; idle gaps ``sleep``. For
  measuring a real device.

Metrics, per tenant class and overall: TTFT (first token minus ARRIVAL,
queueing included); ITL, a request's mean inter-token gap
``(t_done - t_first) / (n_tokens - 1)`` (tokens are read back a segment at
a time, so per-gap percentiles would measure the readback); SLO met (TTFT
and mean ITL within the class's targets); goodput, SLO-meeting requests per
second of makespan (first arrival -> last completion).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...data.pipeline import RequestQueue
from .workload import SegmentCostModel, TimedRequest, VirtualClock

__all__ = ["ClassReport", "LoadtestResult", "run_loadtest"]

_EPS = 1e-9  # deadline comparisons: absorb float accumulation noise


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


@dataclasses.dataclass
class ClassReport:
    """Latency/SLO accounting for one tenant class."""

    name: str
    n: int
    n_slo_met: int
    ttft_p50_s: float
    ttft_p95_s: float
    ttft_p99_s: float
    itl_p50_s: float
    itl_p95_s: float
    itl_p99_s: float


@dataclasses.dataclass
class LoadtestResult:
    """One loadtest run: per-request outputs (the bit-identity surface),
    per-class latency reports, and the headline goodput."""

    outputs: Dict[int, np.ndarray]     # req_id -> emitted tokens
    per_class: Dict[str, ClassReport]
    n_requests: int
    n_slo_met: int
    goodput_rps: float                 # SLO-met requests / makespan
    throughput_rps: float              # all completions / makespan
    makespan_s: float
    stats: Dict[str, int]              # engine counters (writes, drains,
                                       # preemptions, ...)


def run_loadtest(engine, workload: Sequence[TimedRequest], *,
                 virtual: bool = True,
                 cost_model: Optional[SegmentCostModel] = None,
                 max_segments: int = 200_000) -> LoadtestResult:
    """Serve ``workload`` open-loop through ``engine`` and account SLOs.

    ``engine`` is a fresh ``repro_torch.serve.Engine`` (its scheduler's clock
    and ``time_model`` are installed here in virtual mode). The workload
    must be arrival-sorted (``generate_workload``/``load_trace`` output).
    """
    eng = engine.scheduler
    if virtual:
        clock = VirtualClock()
        eng.clock = clock
        eng.time_model = cost_model or SegmentCostModel()
    else:
        clock = None
        eng.clock = time.perf_counter
        eng.time_model = None
    queue = RequestQueue(clock=eng.clock)

    info: Dict[int, TimedRequest] = {}
    done_t: Dict[int, float] = {}
    t0 = eng._now()
    next_i = 0

    def inject(now: float) -> None:
        nonlocal next_i
        while (next_i < len(workload)
               and t0 + workload[next_i].arrival_s <= now + _EPS):
            r = workload[next_i]
            rid = queue.submit(r.prompt, params=r.params,
                               arrival_s=t0 + r.arrival_s,
                               tenant=r.tenant, priority=r.priority,
                               deadline_s=t0 + r.deadline_s)
            info[rid] = r
            next_i += 1

    for _ in range(max_segments):
        now = eng._now()
        inject(now)
        eng.retire_done()
        eng.admit(queue)
        live = ~eng.done_flags() & np.asarray(eng._occupied)
        if not live.any():
            if len(queue) == 0:
                if next_i >= len(workload):
                    break
                # idle: fast-forward (virtual) or sleep (wall) to the
                # next arrival — open loop, the generator never blocks
                nxt = t0 + workload[next_i].arrival_s
                if virtual:
                    clock.advance_to(nxt)
                else:
                    time.sleep(max(0.0, nxt - eng._now()))
                continue
            raise RuntimeError(
                "waiting requests unadmittable with an idle engine "
                "(request larger than pool capacity?)")
        enabled = eng._topup_blocks()
        if not (live & enabled).any():
            raise RuntimeError(
                "every live slot stalled on block top-up: the pool is "
                "too small for the admitted working set")
        eng.run_segment(enabled)
        seg_end = eng._now()
        flags = eng.done_flags()
        for s in range(eng.cfg.n_slots):
            if eng._occupied[s] and bool(flags[s]):
                done_t.setdefault(eng._slot_req[s], seg_end)
    else:
        raise RuntimeError(f"loadtest exceeded {max_segments} segments")

    # ---- accounting ---------------------------------------------------
    by_class: Dict[str, List[int]] = {}
    ttft: Dict[int, float] = {}
    itl: Dict[int, float] = {}
    met: Dict[int, bool] = {}
    for rid, r in info.items():
        by_class.setdefault(r.tenant, []).append(rid)
        arr = t0 + r.arrival_s
        ttft[rid] = eng.first_token_t[rid] - arr
        n = len(eng.outputs[rid])
        itl[rid] = ((done_t[rid] - eng.first_token_t[rid]) / (n - 1)
                    if n > 1 else 0.0)
        met[rid] = (ttft[rid] <= r.ttft_slo_s + _EPS
                    and itl[rid] <= r.itl_slo_s + _EPS)

    per_class: Dict[str, ClassReport] = {}
    for name, rids in sorted(by_class.items()):
        ts = [ttft[r] for r in rids]
        is_ = [itl[r] for r in rids]
        per_class[name] = ClassReport(
            name=name, n=len(rids),
            n_slo_met=sum(met[r] for r in rids),
            ttft_p50_s=_pct(ts, 50), ttft_p95_s=_pct(ts, 95),
            ttft_p99_s=_pct(ts, 99),
            itl_p50_s=_pct(is_, 50), itl_p95_s=_pct(is_, 95),
            itl_p99_s=_pct(is_, 99),
        )

    t_first_arr = t0 + (workload[0].arrival_s if workload else 0.0)
    makespan = max(done_t.values()) - t_first_arr if done_t else 0.0
    n_met = sum(met.values())
    return LoadtestResult(
        outputs={rid: np.asarray(t, np.int32)
                 for rid, t in eng.outputs.items()},
        per_class=per_class,
        n_requests=len(info),
        n_slo_met=n_met,
        goodput_rps=(n_met / makespan if makespan > 0 else 0.0),
        throughput_rps=(len(done_t) / makespan if makespan > 0 else 0.0),
        makespan_s=makespan,
        stats=dict(eng.stats),
    )
