"""The open-loop traffic stack in the port against the JAX package: the
twins of ``tests/test_traffic.py`` and the loadtest row of
``BENCH_serve.json``.

Arrival processes, workloads and traces are numpy ``RandomState`` draws in
the JAX package's order: their arrays must EQUAL the JAX package's. The
admission policies must return the JAX policies' permutations on the same
queues. The engines run the reduced stablelm-1.6b, fp32 on the CPU, with
the JAX package's weights carried across as numpy, on the virtual clock:
every timestamp is model time, so first-token instants, makespans and
goodputs compare exactly. ``benchmarks/loadtest.py``'s three arms
reproduce its committed row number for number."""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import RequestQueue as JaxQueue
from repro.models import build_model as jbuild
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatchedEngine
from repro.serve import MemoryConfig as JaxMemoryConfig
from repro.serve import traffic as JT
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import RequestQueue
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, MemoryConfig
from repro_torch.serve import traffic as TT
from repro_torch.serve.scheduler import BatchConfig, BatchedServeEngine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDS = ["fifo", "sched/priority", "sched/deadline", "sched/preempt"]


# ---------------------------------------------------------------------------
# virtual clock + arrival processes
# ---------------------------------------------------------------------------


def test_virtual_clock_advances_monotonically():
    for mod in (TT, JT):
        clk = mod.VirtualClock()
        assert clk() == 0.0
        clk.advance(1.5)
        clk.advance_to(1.0)
        assert clk() == 1.5
        clk.advance_to(2.0)
        assert clk() == 2.0
        with pytest.raises(ValueError):
            clk.advance(-0.1)


def _process(mod, kind, **kw):
    if kind == "poisson":
        return mod.PoissonArrivals(rate_rps=kw.get("rate", 100.0))
    return mod.MarkovModulatedArrivals(
        calm_rps=kw.get("calm", 10.0), burst_rps=kw.get("burst", 1000.0),
        mean_calm_s=kw.get("mc", 0.1), mean_burst_s=kw.get("mb", 0.02))


@pytest.mark.parametrize("kind", ["poisson", "mmpp"])
def test_arrival_processes_equal_jax_deterministic_and_monotone(kind):
    a = _process(TT, kind).times(200, np.random.RandomState(3))
    np.testing.assert_array_equal(
        a, _process(JT, kind).times(200, np.random.RandomState(3)))
    assert np.array_equal(
        a, _process(TT, kind).times(200, np.random.RandomState(3)))
    assert len(a) == 200 and np.all(np.diff(a) >= 0) and a[0] >= 0
    assert not np.array_equal(
        a, _process(TT, kind).times(200, np.random.RandomState(4)))


def test_poisson_rate_is_roughly_right():
    t = TT.PoissonArrivals(rate_rps=1000.0).times(4000,
                                                  np.random.RandomState(0))
    np.testing.assert_array_equal(t, JT.PoissonArrivals(1000.0).times(
        4000, np.random.RandomState(0)))
    assert 900.0 < len(t) / t[-1] < 1100.0


def test_mmpp_bursts_are_denser_than_calm():
    kw = dict(calm=50.0, burst=5000.0, mc=0.5, mb=0.5)
    t = _process(TT, "mmpp", **kw).times(2000, np.random.RandomState(1))
    np.testing.assert_array_equal(t, _process(JT, "mmpp", **kw).times(
        2000, np.random.RandomState(1)))
    gaps = np.diff(t)
    assert (gaps < 1e-3).mean() > 0.9 and (gaps > 5e-3).sum() >= 5


def test_trace_arrivals_replay_verbatim():
    t = TT.TraceArrivals(arrival_s=(0.0, 0.5, 0.5, 2.0))
    rng = np.random.RandomState(9)
    assert np.allclose(t.times(3, rng), [0.0, 0.5, 0.5])
    with pytest.raises(ValueError):
        t.times(5, rng)
    with pytest.raises(ValueError):
        TT.TraceArrivals(arrival_s=(1.0, 0.5)).times(2, rng)


# ---------------------------------------------------------------------------
# workload generation + JSONL traces
# ---------------------------------------------------------------------------


def _classes(mod):
    return [
        mod.RequestClass("interactive", ttft_slo_s=1e-3, itl_slo_s=1e-3,
                         priority=1, prompt_len=(2, 6), max_tokens=4,
                         weight=3.0),
        mod.RequestClass("batch", ttft_slo_s=1e-2, itl_slo_s=5e-3,
                         priority=0, prompt_len=12, max_tokens=(4, 8),
                         weight=1.0),
    ]


def _same_workload(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.arrival_s, x.tenant, x.priority, x.deadline_s,
                x.ttft_slo_s, x.itl_slo_s) == (
            y.arrival_s, y.tenant, y.priority, y.deadline_s, y.ttft_slo_s,
            y.itl_slo_s)
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.prompt.dtype == y.prompt.dtype
        assert (x.params.temperature, x.params.max_tokens, x.params.seed) \
            == (y.params.temperature, y.params.max_tokens, y.params.seed)


def test_generate_workload_equals_jax():
    wl = TT.generate_workload(_classes(TT), TT.PoissonArrivals(100.0), 64,
                              vocab=97, seed=5)
    _same_workload(wl, JT.generate_workload(
        _classes(JT), JT.PoissonArrivals(100.0), 64, vocab=97, seed=5))
    assert {r.tenant for r in wl} == {"interactive", "batch"}
    assert sum(r.tenant == "interactive" for r in wl) > 32
    for r in wl:
        assert np.all(r.prompt < 97)
        assert r.deadline_s == pytest.approx(
            r.arrival_s + (1e-3 if r.tenant == "interactive" else 1e-2))


def test_trace_roundtrip_jsonl_both_ways(tmp_path):
    wl = TT.generate_workload(_classes(TT), TT.PoissonArrivals(500.0), 16,
                              vocab=97, seed=2)
    p = tmp_path / "trace.jsonl"
    TT.save_trace(p, wl)
    back = TT.load_trace(p, vocab=97)
    _same_workload(back, JT.load_trace(p, vocab=97))
    q = tmp_path / "jax_trace.jsonl"
    JT.save_trace(q, JT.generate_workload(
        _classes(JT), JT.PoissonArrivals(500.0), 16, vocab=97, seed=2))
    assert p.read_text() == q.read_text()
    for a, b in zip(wl, back):
        assert a.arrival_s == pytest.approx(b.arrival_s)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    # lines without a prompt synthesize JAX's
    r = tmp_path / "lens.jsonl"
    r.write_text("\n".join(json.dumps({"arrival_s": 0.1 * i,
                                       "prompt_len": 3 + i})
                           for i in range(4)) + "\n")
    _same_workload(TT.load_trace(r, vocab=97), JT.load_trace(r, vocab=97))


SEGS = [
    {"direct": 10, "staged": 0, "drains": 0, "prefill": 0},
    {"direct": 0, "staged": 10, "drains": 0, "prefill": 0},
    {"direct": 0, "staged": 0, "drains": 0, "prefill": 0},
    {"direct": 0, "staged": 0, "drains": 2, "prefill": 0},
    {"direct": 7, "staged": 3, "drains": 1, "prefill": 40, "committed": 12},
]


def test_segment_cost_model_equals_jax_and_orders_paths():
    m, jm = TT.SegmentCostModel(), JT.SegmentCostModel()
    assert [m(s) for s in SEGS] == [jm(s) for s in SEGS]
    direct_cold, staged, empty, drains = (m(s) for s in SEGS[:4])
    assert direct_cold > staged > empty > 0 and drains > empty


def test_latency_model_equals_jax():
    """The paper's per-path microseconds, model constants on both sides."""
    from repro.core.types import LatencyModel as JaxLatency
    from repro_torch.core import LatencyModel
    lat, jlat = LatencyModel(), JaxLatency()
    assert vars(lat) == vars(jlat)
    sizes = np.array([0, 16, 64, 4096], np.int32)
    np.testing.assert_allclose(
        lat.unload_copy_us(torch.as_tensor(sizes)).numpy(),
        np.asarray(jlat.unload_copy_us(jax.numpy.asarray(sizes))),
        rtol=0, atol=0)


def test_segment_cost_model_charges_per_committed_token():
    m = TT.SegmentCostModel()
    base = {"direct": 4, "staged": 0, "drains": 0, "prefill": 0}
    one, spec = m({**base, "committed": 4}), m({**base, "committed": 12})
    assert spec > one > m(base)
    assert spec - one == pytest.approx(8 * m.t_token_us * 1e-6)


# ---------------------------------------------------------------------------
# admission policies: the JAX permutations on the same queues
# ---------------------------------------------------------------------------


def _queues(entries):
    qs = (RequestQueue(clock=TT.VirtualClock()),
          JaxQueue(clock=JT.VirtualClock()))
    for q in qs:
        for kw in entries:
            q.submit(np.arange(3, dtype=np.int32), 4, **kw)
    return qs


def _orders(name, entries):
    q, jq = _queues(entries)
    got = TT.build_sched(name).order(q)
    assert got == JT.build_sched(name).order(jq)
    return got


def test_sched_registry_lists_and_rejects():
    assert set(SCHEDS) <= set(TT.available_scheds())
    assert TT.build_sched("sched/preempt").preempts
    with pytest.raises(ValueError, match="unknown sched"):
        TT.build_sched("sched/lifo")
    with pytest.raises(ValueError, match="already registered"):
        TT.register_sched("fifo", TT.FifoAdmission)


@pytest.mark.parametrize("name", SCHEDS)
def test_equal_requests_stay_strictly_fifo(name):
    assert _orders(name, [dict(priority=1, deadline_s=2.0)] * 6) \
        == list(range(6))


def test_priority_orders_high_first_then_fifo():
    assert _orders("sched/priority", [dict(priority=p)
                                      for p in (0, 2, 1, 2)]) == [1, 3, 2, 0]


def test_deadline_orders_edf_then_fifo():
    q, _ = _queues([dict(deadline_s=3.0), dict(deadline_s=1.0), dict(),
                    dict(deadline_s=1.0)])
    assert q.at(2).deadline_s == math.inf
    assert _orders("sched/deadline", [
        dict(deadline_s=3.0), dict(deadline_s=1.0), dict(),
        dict(deadline_s=1.0)]) == [1, 3, 0, 2]


@pytest.mark.parametrize("name", SCHEDS)
def test_order_is_a_permutation(name):
    rng = np.random.RandomState(0)
    entries = [dict(priority=int(rng.randint(0, 4)),
                    deadline_s=float(rng.rand())) for _ in range(17)]
    assert sorted(_orders(name, entries)) == list(range(17))


# ---------------------------------------------------------------------------
# engines: the reduced stablelm-1.6b with JAX's weights, virtual clock
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(max_seq):
    if max_seq not in _MODELS:
        jmodel = jbuild(jget("stablelm-1.6b").reduced())
        jparams = jmodel.init(jax.random.key(0), max_seq)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config("stablelm-1.6b").reduced(), device="cpu"))
        _MODELS[max_seq] = (jmodel, jparams, tmodel)
    return _MODELS[max_seq]


def _pair(max_seq=32, memory=None, **kw):
    """The port's and the JAX package's engine, both on a virtual clock
    advanced by the segment cost model."""
    jmodel, jparams, tmodel = _models(max_seq)
    eng = BatchedServeEngine(tmodel, BatchConfig(
        max_seq=max_seq, device="cpu", memory=MemoryConfig(**(memory or {})),
        **kw), _internal=True)
    jeng = JaxBatchedEngine(jmodel, jparams, JaxBatchConfig(
        max_seq=max_seq, memory=JaxMemoryConfig(**(memory or {})), **kw),
        _internal=True)
    for e, mod in ((eng, TT), (jeng, JT)):
        e.clock = mod.VirtualClock()
        e.time_model = mod.SegmentCostModel()
    return eng, jeng


def _starvation_queue(q, vocab=256):
    """The EDF starvation stream of ``tests/test_traffic.py``: two leading
    smalls with the earliest deadlines, then a BIG request that needs the
    whole 4-block pool, then a tail of smalls with later deadlines."""
    rng = np.random.RandomState(0)

    def small(mn, dl):
        return q.submit(rng.randint(0, vocab, 2).astype(np.int32), mn,
                        deadline_s=dl)

    small(2, 0.5)
    small(3, 0.5)
    big = q.submit(rng.randint(0, vocab, 8).astype(np.int32), 9,
                   deadline_s=1.0)
    for i in range(6):
        small(3, 10.0 + i)
    return big


def _serve_starvation(skip_limit):
    eng, jeng = _pair(n_slots=2, segment_len=1, page_size=4, n_blocks=4,
                      sched="sched/deadline",
                      memory=dict(skip_ahead_limit=skip_limit))
    q, jq = RequestQueue(clock=eng.clock), JaxQueue(clock=jeng.clock)
    big = _starvation_queue(q)
    assert _starvation_queue(jq) == big
    last = len(q) - 1
    out, jout = eng.serve(q), jeng.serve(jq)
    assert set(out) == set(jout)
    for r in out:
        np.testing.assert_array_equal(out[r], jout[r])
    assert eng.ttft == jeng.ttft and eng.stats["segments"] == \
        jeng.stats["segments"]
    assert len(out) == 9 and len(out[big]) == 9
    return eng, big, last


def test_bounded_skip_ahead_protects_the_edf_head():
    eng, big, last = _serve_starvation(2)
    assert eng.ttft[big] < eng.ttft[last]


def test_unbounded_skip_ahead_starves_the_edf_head():
    eng, big, last = _serve_starvation(10_000)
    assert eng.ttft[big] > eng.ttft[last]


# ---------------------------------------------------------------------------
# the loadtest harness
# ---------------------------------------------------------------------------


class _Wrap:
    """The harness takes ``engine.scheduler``."""

    def __init__(self, scheduler):
        self.scheduler = scheduler


def _loadtest_pair(sched):
    eng, jeng = _pair(n_slots=2, segment_len=2, page_size=4, chunked=True,
                      chunk_size=4, sched=sched)
    wl = TT.generate_workload(_classes(TT), TT.PoissonArrivals(2000.0), 10,
                              vocab=256, seed=11)
    jwl = JT.generate_workload(_classes(JT), JT.PoissonArrivals(2000.0), 10,
                               vocab=256, seed=11)
    return (TT.run_loadtest(_Wrap(eng), wl, virtual=True),
            JT.run_loadtest(_Wrap(jeng), jwl, virtual=True))


def _same_result(a, b):
    assert (a.n_requests, a.n_slo_met, a.makespan_s, a.goodput_rps,
            a.throughput_rps) == (b.n_requests, b.n_slo_met, b.makespan_s,
                                  b.goodput_rps, b.throughput_rps)
    assert a.per_class == {k: type(a.per_class[k])(**vars(v))
                           for k, v in b.per_class.items()}
    assert set(a.outputs) == set(b.outputs)
    assert all(np.array_equal(a.outputs[r], b.outputs[r]) for r in a.outputs)


@pytest.mark.parametrize("sched", ["fifo", "sched/deadline"])
def test_virtual_loadtest_is_deterministic(sched):
    a, ja = _loadtest_pair(sched)
    b, _ = _loadtest_pair(sched)
    _same_result(a, ja)
    _same_result(a, b)
    assert a.n_requests == 10 and a.makespan_s > 0
    assert set(a.per_class) == {"interactive", "batch"}


def test_loadtest_scheds_agree_on_tokens():
    a, _ = _loadtest_pair("fifo")
    b, _ = _loadtest_pair("sched/deadline")
    assert set(a.outputs) == set(b.outputs)
    assert all(np.array_equal(a.outputs[r], b.outputs[r]) for r in a.outputs)


def test_loadtest_reproduces_the_bench_serve_row():
    """``benchmarks/loadtest.py`` (``build_workload``, ``ARMS`` and the
    engine shape of ``bench_loadtest``), run by the port on the reduced
    stablelm-1.6b with the weights JAX's ``build_model_and_params`` makes
    (seed 0, ``max_seq`` 96), in virtual time: the committed row of
    ``BENCH_serve.json``, number for number, and the same tokens on every
    arm."""
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        want = json.load(f)["loadtest"]
    tmodel = _models(96)[2]
    classes = [
        TT.RequestClass("interactive", ttft_slo_s=1.0e-3, itl_slo_s=1.0e-3,
                        priority=1, prompt_len=(4, 12), max_tokens=6,
                        weight=3.0),
        TT.RequestClass("batch", ttft_slo_s=20.0e-3, itl_slo_s=5.0e-3,
                        priority=0, prompt_len=(24, 48), max_tokens=12,
                        weight=1.0),
    ]
    process = TT.MarkovModulatedArrivals(calm_rps=400.0, burst_rps=60000.0,
                                         mean_calm_s=2.0e-3,
                                         mean_burst_s=8.0e-3)
    wl = TT.generate_workload(classes, process, want["n_requests"],
                              vocab=tmodel.cfg.vocab, seed=want["seed"])
    res = {}
    for label, path, sched in (("direct_fifo", "direct", "fifo"),
                               ("staged_fifo", "staged", "fifo"),
                               ("adaptive", "adaptive", "sched/deadline")):
        eng = Engine.from_config(EngineConfig(
            max_seq=96, n_slots=8, segment_len=8, chunked=True,
            chunk_size=16, page_size=8, path=path, sched=sched,
            device="cpu"), tmodel)
        res[label] = TT.run_loadtest(eng, wl, virtual=True)
    ada = res["adaptive"]
    got = {"n_requests": ada.n_requests,
           "n_interactive": ada.per_class["interactive"].n,
           "n_batch": ada.per_class["batch"].n}
    for label, r in res.items():
        got[f"{label}_goodput_rps"] = round(r.goodput_rps, 1)
        got[f"{label}_slo_met"] = r.n_slo_met
    got["adaptive_interactive_ttft_p95_ms"] = round(
        ada.per_class["interactive"].ttft_p95_s * 1e3, 4)
    best = max(res["direct_fifo"].goodput_rps, res["staged_fifo"].goodput_rps)
    got["goodput_ratio"] = round(ada.goodput_rps / best, 3)
    ref = res["direct_fifo"].outputs
    got["bit_identical"] = all(
        sorted(r.outputs) == sorted(ref)
        and all(np.array_equal(r.outputs[k], ref[k]) for k in ref)
        for r in res.values())
    assert got == {k: want[k] for k in got}
    assert (got["direct_fifo_slo_met"], got["staged_fifo_slo_met"],
            got["adaptive_slo_met"]) == (26, 26, 35)
    assert got["goodput_ratio"] == 1.218
    assert got["adaptive_interactive_ttft_p95_ms"] == 1.628
