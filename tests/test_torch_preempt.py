"""Preempt-and-requeue in the port against the JAX package: the twins of
``tests/test_preempt.py``.

Parking a RUNNING slot's KV in the host tier, requeueing its request and
resuming it later must not show in the output: the same tokens and the
same per-request write counts as an unpreempted run, for blocking and
chunked prefill, the direct and staged paths and SAMPLED requests (the key
is saved and loaded back, never derived again). Every run is also held to
the JAX engine's on the same queue: streams, write counts and counters, on
the reduced stablelm-1.6b, fp32 on the CPU, with the JAX package's weights
carried across as numpy. ``sched/preempt`` evicts a lower-priority slot for
a strictly higher-priority arrival, which gets its first token earlier on
the virtual clock, at the JAX engine's virtual instants."""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import RequestQueue as JaxQueue
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import MemoryConfig as JaxMemoryConfig
from repro.serve import build_model_and_params as jax_model
from repro.serve.traffic import SegmentCostModel as JaxCostModel
from repro.serve.traffic import VirtualClock as JaxClock
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import RequestQueue
from repro_torch.models import build_model
from repro_torch.models.sampling import SamplingParams
from repro_torch.serve import Engine, EngineConfig, MemoryConfig
from repro_torch.serve.traffic import SegmentCostModel, VirtualClock

torch.set_num_threads(1)
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "segments", "admitted", "retired", "host_unloads", "host_pageins",
         "preemptions", "preempt_resumes")
_MODEL = {}


def _models():
    """JAX's ``build_model_and_params`` at max_seq 64 (what its
    ``Engine.from_config(arch=...)`` builds) and the port's twin."""
    if not _MODEL:
        _, jmodel, jparams = jax_model("stablelm-1.6b", 64)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config("stablelm-1.6b").reduced(), device="cpu"))
        _MODEL.update(j=(jmodel, jparams), t=tmodel)
    return _MODEL


def _shape(chunked, path, sched, n_slots):
    return dict(max_seq=64, n_slots=n_slots, segment_len=4, chunked=chunked,
                chunk_size=4, path=path, sched=sched)


def _build(chunked, path="direct", temp=0.0, sched="fifo", n_slots=2):
    return Engine.from_config(EngineConfig(
        **_shape(chunked, path, sched, n_slots), device="cpu",
        memory=MemoryConfig(host_tier=True),
        default_params=SamplingParams(temperature=temp, max_tokens=10,
                                      seed=3)), _models()["t"])


def _jbuild(chunked, path="direct", temp=0.0, sched="fifo", n_slots=2):
    return JaxEngine.from_config(JaxConfig(
        **_shape(chunked, path, sched, n_slots),
        memory=JaxMemoryConfig(host_tier=True),
        default_params=JaxParams(temperature=temp, max_tokens=10, seed=3)),
        *_models()["j"])


def _mkq(make=RequestQueue, sp=SamplingParams):
    q = make()
    for i in range(3):
        q.submit(np.arange(1, 5 + i, dtype=np.int32),
                 params=sp(max_tokens=10))
    return q


def _writes(eng, out):
    return {r: tuple(int(x) for x in eng.req_writes[r]) for r in out}


def _same(a, b):
    assert set(a) == set(b)
    assert all(np.array_equal(np.asarray(a[r]), np.asarray(b[r])) for r in a)


def _preempted_run(eng, q):
    """Admit, run one segment, park a mid-flight slot (KV -> host, request
    requeued), then serve to completion."""
    eng.admit(q)
    eng.run_segment(eng._topup_blocks())
    done = np.asarray(eng.slots.done)
    victim = next(s for s in range(eng.cfg.n_slots)
                  if eng._occupied[s] and not done[s])
    eng.preempt_slot(victim, q)
    return eng.serve(q)


@pytest.mark.parametrize("chunked,path,temp", [
    (False, "direct", 0.0),        # blocking prefill, greedy
    (True, "staged", 0.0),         # chunked + ring writes
    (True, "direct", 0.8),         # SAMPLED: the key replays
])
def test_preempt_resume_roundtrip_is_bit_identical(chunked, path, temp):
    e1 = _build(chunked, path, temp)
    base = e1.scheduler.serve(_mkq())
    eng = _build(chunked, path, temp).scheduler
    out = _preempted_run(eng, _mkq())
    jeng = _jbuild(chunked, path, temp).scheduler
    jout = _preempted_run(jeng, _mkq(JaxQueue, JaxParams))

    assert eng.stats["preemptions"] == eng.stats["preempt_resumes"] == 1
    _same(out, base)
    assert _writes(eng, out) == _writes(e1.scheduler, base)
    eng.pool.audit()
    _same(out, jout)
    assert _writes(eng, out) == _writes(jeng, jout)
    for k in STATS:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)


def _serve_with_late_high_priority(build, make, sp, clock, cost, sched):
    """Two low-priority long requests fill both slots; a high-priority
    request lands after the first segment. Virtual clock."""
    eng = build(chunked=True, sched=sched).scheduler
    eng.clock = clock()
    eng.time_model = cost()
    q = make(clock=eng.clock)
    for _ in range(2):
        q.submit(np.arange(1, 9, dtype=np.int32),
                 params=sp(max_tokens=24), priority=0)
    eng.admit(q)
    eng.run_segment(eng._topup_blocks())
    hi = q.submit(np.arange(1, 5, dtype=np.int32),
                  params=sp(max_tokens=10), priority=5)
    return eng, eng.serve(q), hi


def test_sched_preempt_evicts_for_higher_priority():
    port = (_build, RequestQueue, SamplingParams, VirtualClock,
            SegmentCostModel)
    eng_p, out_p, hi = _serve_with_late_high_priority(*port,
                                                      "sched/preempt")
    eng_f, out_f, hi_f = _serve_with_late_high_priority(*port, "fifo")
    jeng, jout, jhi = _serve_with_late_high_priority(
        _jbuild, JaxQueue, JaxParams, JaxClock, JaxCostModel,
        "sched/preempt")
    assert hi == hi_f == jhi
    assert eng_p.stats["preemptions"] >= 1
    assert eng_p.stats["preempt_resumes"] == eng_p.stats["preemptions"]
    assert eng_f.stats["preemptions"] == 0
    assert eng_p.first_token_t[hi] < eng_f.first_token_t[hi]
    _same(out_p, out_f)
    eng_p.pool.audit()
    _same(out_p, jout)
    assert eng_p.first_token_t == jeng.first_token_t
    for k in STATS:
        assert eng_p.stats[k] == jeng.stats[k], (k, eng_p.stats, jeng.stats)


def test_preempt_without_host_tier_is_rejected_at_validate():
    with pytest.raises(ValueError, match="host_tier"):
        Engine.from_config(EngineConfig(
            max_seq=32, n_slots=2, sched="sched/preempt", device="cpu"),
            _models()["t"])


def test_preempt_slot_requires_host_tier_at_runtime():
    e = Engine.from_config(EngineConfig(max_seq=32, n_slots=2, device="cpu"),
                           _models()["t"])
    with pytest.raises(RuntimeError, match="host_tier"):
        e.scheduler.preempt_slot(0, RequestQueue())


def test_preempting_a_free_slot_is_refused():
    eng = _build(False).scheduler
    with pytest.raises(ValueError, match="not a preemptible"):
        eng.preempt_slot(0, RequestQueue())


def test_parked_sampled_slots_follow_jax():
    """The host tier's park / unpark (a pool short of the working set) with
    sampled requests: the port's streams and counters equal the JAX
    engine's. Park and unpark leave a slot's key alone, but a decode step
    splits EVERY slot's chain, a stalled (parked) one too, as JAX's does
    (its mixed-phase step splits only decoding slots), so in both packages
    a sampled stream on a tight pool parts from the ample pool's where its
    slot was stalled; the same requests part in both. Greedy streams equal
    the ample pool's."""
    shape = dict(max_seq=32, n_slots=4, segment_len=4, page_size=4,
                 chunked=False, path="direct")
    jmodel, jparams = _models()["j"]

    def run(temp, n_blocks):
        mem = dict(host_tier=True) if n_blocks else {}
        eng = Engine.from_config(EngineConfig(
            **shape, n_blocks=n_blocks, device="cpu",
            memory=MemoryConfig(**mem)), _models()["t"]).scheduler
        jeng = JaxEngine.from_config(JaxConfig(
            **shape, n_blocks=n_blocks, memory=JaxMemoryConfig(**mem)),
            jmodel, jparams).scheduler
        outs = []
        for e, make, sp in ((eng, RequestQueue, SamplingParams),
                            (jeng, JaxQueue, JaxParams)):
            q = make()
            for i in range(8):
                q.submit(np.arange(3, 11, dtype=np.int32) + i,
                         params=sp(max_tokens=9, temperature=temp))
            outs.append(e.serve(q))
        _same(*outs)
        for k in STATS:
            assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
        return outs, eng.stats

    (tight, jtight), st = run(0.9, 5)
    assert st["host_unloads"] > 0 and st["host_pageins"] > 0
    (ample, jample), _ = run(0.9, 0)
    parted = [r for r in tight if not np.array_equal(tight[r], ample[r])]
    assert parted and parted == [r for r in jtight
                      if not np.array_equal(jtight[r], jample[r])]
    (greedy_tight, _), _ = run(0.0, 5)
    (greedy_ample, _), _ = run(0.0, 0)
    _same(greedy_tight, greedy_ample)
