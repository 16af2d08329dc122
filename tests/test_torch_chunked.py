"""Chunked prefill in the port against the JAX package: the twins of
``tests/test_chunked_prefill.py`` plus write-path telemetry parity.

Reduced stablelm-1.6b, fp32, on the CPU, with the JAX package's weights
carried across as numpy. Every comparison is EXACT: chunking changes when
tokens appear (admission is immediate, prefill interleaves with decode in
mixed-phase segments), never which. For direct, staged and adaptive at chunk
sizes 1, 3 and 8 the port's chunked engine gives the JAX chunked engine's
greedy streams, engine stats and per-request write counts (direct / staged
/ prefill), and the port's blocking engine's streams; a pool small enough
that ``_topup_blocks`` stalls a slot for a segment does too. On the lanes
layout ``chunked=True`` prefills chunk by chunk at admission. Sampled
decoding under ``chunked=True`` gives the JAX chunked engine's streams."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatchedEngine
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.models import build_model
from repro_torch.serve.scheduler import BatchConfig, BatchedServeEngine

torch.set_num_threads(1)

N_REQ, MAX_NEW = 5, 8
PLENS = [20, 6, 11]  # mixed long/short, ragged against every chunk size
PATHS = ("direct", "staged", "adaptive")
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "segments", "admitted", "retired")
SHAPE = dict(max_seq=40, n_slots=2, page_size=4, segment_len=4, ring_size=4,
             hot_threshold=3, chunk_size=3)
# ring 2 < segment_len: drains inside the segments; 10 blocks: the top-up
# stalls a slot for a segment (9 would stall every live slot)
TIGHT = dict(ring_size=2, n_blocks=10)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("stablelm-1.6b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), 64)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config("stablelm-1.6b")
                                           .reduced(), device="cpu"))
    return jcfg, jmodel, jparams, tmodel


def _queue(plens=PLENS, max_new=MAX_NEW, n=N_REQ):
    return synthetic_requests(n, plens, 256, max_new, seed=3)


def _engine(model, chunked, **kw):
    shape = dict(SHAPE)
    shape.update(kw)
    return BatchedServeEngine(model, BatchConfig(chunked=chunked,
                                                 device="cpu", **shape),
                              _internal=True)


def _jax_engine(jmodel, jparams, chunked, **kw):
    shape = dict(SHAPE)
    shape.update(kw)
    return JaxBatchedEngine(jmodel, jparams,
                            JaxBatchConfig(chunked=chunked, **shape),
                            _internal=True)


def _assert_same(out_a, out_b):
    assert set(out_a) == set(out_b)
    for r in out_a:
        np.testing.assert_array_equal(np.asarray(out_a[r]),
                                      np.asarray(out_b[r]))


def _assert_same_telemetry(eng, jeng):
    for k in STATS:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
    assert set(eng.req_writes) == set(jeng.req_writes)
    for rid, w in eng.req_writes.items():
        np.testing.assert_array_equal(w, np.asarray(jeng.req_writes[rid]))


@pytest.mark.parametrize("chunk_size", [1, 3, 8])
@pytest.mark.parametrize("path", PATHS)
def test_chunked_matches_jax_chunked(setup, path, chunk_size):
    """Streams, engine stats and per-request [direct, staged, prefill]
    write counts equal the JAX chunked engine's. The monitor sees the bulk
    prefill rows too, so adaptive routing here differs from the blocking
    engine's and must match JAX's chunked telemetry."""
    jcfg, jmodel, jparams, tmodel = setup
    jeng = _jax_engine(jmodel, jparams, True, write_mode=path,
                       chunk_size=chunk_size)
    jout = jeng.serve(jax_requests(N_REQ, PLENS, jcfg.vocab, MAX_NEW,
                                   seed=3))
    eng = _engine(tmodel, True, write_mode=path, chunk_size=chunk_size)
    _assert_same(eng.serve(_queue()), jout)
    _assert_same_telemetry(eng, jeng)
    assert eng.stats["prefill_writes"] == sum(
        PLENS[i % len(PLENS)] for i in range(N_REQ))


@pytest.mark.parametrize("path", PATHS)
def test_chunked_equals_blocking_every_write_mode(setup, path):
    _, _, _, tmodel = setup
    out_c = _engine(tmodel, True, write_mode=path).serve(_queue())
    out_b = _engine(tmodel, False, write_mode=path).serve(_queue())
    _assert_same(out_c, out_b)
    # and against one slot decoding alone (sequential decode)
    eng1 = BatchedServeEngine(tmodel, BatchConfig(
        max_seq=40, n_slots=1, page_size=4, segment_len=4, ring_size=4,
        hot_threshold=3, write_mode=path, device="cpu"), _internal=True)
    _assert_same(out_c, eng1.serve(_queue()))


@pytest.mark.parametrize("chunk_size", [1, 3, 8])
def test_chunk_size_is_invisible(setup, chunk_size):
    """Any chunking of the prompt gives the same stream (chunk_size 1 is
    token-at-a-time prefill)."""
    _, _, _, tmodel = setup
    out_c = _engine(tmodel, True, chunk_size=chunk_size).serve(_queue())
    out_b = _engine(tmodel, False).serve(_queue())
    _assert_same(out_c, out_b)


def test_sampled_decoding_under_chunked_is_not_ported(setup):
    """Once refused, now ported: ``greedy=False`` (temperature 1 for every
    request) under ``chunked=True`` gives the JAX chunked engine's sampled
    streams and stats, and the port's blocking engine's streams (prefill
    steps consume no key)."""
    _, jmodel, jparams, tmodel = setup
    out = _engine(tmodel, True, greedy=False).serve(_queue())
    jeng = _jax_engine(jmodel, jparams, True, greedy=False)
    _assert_same(out, jeng.serve(jax_requests(N_REQ, PLENS, 256, MAX_NEW,
                                              seed=3)))
    _assert_same(out, _engine(tmodel, False, greedy=False).serve(_queue()))


def test_eos_and_budget_retirement_through_chunked(setup):
    _, _, _, tmodel = setup
    base = _engine(tmodel, False).serve(_queue())
    eos = int(base[0][3])  # a token the greedy stream emits mid-sequence
    out_c = _engine(tmodel, True, eos_id=eos).serve(_queue())
    out_b = _engine(tmodel, False, eos_id=eos).serve(_queue())
    _assert_same(out_c, out_b)
    assert len(out_c[0]) <= 4 and out_c[0][-1] == eos


def test_max_new_one_emits_in_segment(setup):
    """max_new=1: the only emitted token is the prefill flip's argmax; the
    slot retires without a single decode write."""
    _, _, _, tmodel = setup
    eng = _engine(tmodel, True)
    out = eng.serve(_queue(max_new=1))
    _assert_same(out, _engine(tmodel, False).serve(_queue(max_new=1)))
    assert all(out[r].shape == (1,) for r in out)
    assert eng.stats["direct_writes"] == 0
    assert eng.stats["prefill_writes"] == sum(
        PLENS[i % len(PLENS)] for i in range(N_REQ))


def test_per_phase_write_split(setup):
    """Decode writes tally direct/staged by routing; prefill chunk rows
    tally separately (the bulk/offload path): phase-tagged WriteBatch."""
    _, _, _, tmodel = setup
    eng = _engine(tmodel, True, write_mode="staged")
    eng.serve(_queue())
    n_prompt = sum(PLENS[i % len(PLENS)] for i in range(N_REQ))
    assert eng.stats["prefill_writes"] == n_prompt
    # staged stages every SCATTERED write; bulk prefill never stages
    assert eng.stats["staged_writes"] == N_REQ * (MAX_NEW - 1)
    assert eng.stats["direct_writes"] == 0
    for rid, (d, s, p) in eng.req_writes.items():
        assert (d, s, p) == (0, MAX_NEW - 1, PLENS[rid % len(PLENS)])


def test_ttft_is_recorded_for_every_request(setup):
    _, _, _, tmodel = setup
    for chunked in (False, True):
        eng = _engine(tmodel, chunked)
        out = eng.serve(_queue())
        assert set(eng.ttft) == set(out)
        assert all(t >= 0.0 for t in eng.ttft.values())


def test_pool_tight_topup_stalls_and_matches_jax(setup):
    """10 blocks of 4 rows for two slots: a slot's top-up fails and it
    stalls for a segment, in-segment drains happen (ring 2), and streams
    and telemetry still equal the JAX chunked engine's."""
    jcfg, jmodel, jparams, tmodel = setup
    jeng = _jax_engine(jmodel, jparams, True, write_mode="adaptive", **TIGHT)
    jout = jeng.serve(jax_requests(N_REQ, PLENS, jcfg.vocab, MAX_NEW,
                                   seed=3))
    eng = _engine(tmodel, True, write_mode="adaptive", **TIGHT)
    stalled = []
    topup = eng._topup_blocks

    def counting_topup():
        enabled = topup()
        stalled.append(int((~enabled).sum()))
        return enabled

    eng._topup_blocks = counting_topup
    _assert_same(eng.serve(_queue()), jout)
    _assert_same_telemetry(eng, jeng)
    assert sum(stalled) > 0
    assert eng.stats["drains"] > 0
    eng.pool.audit()
    assert eng.pool.n_free == 10
    _assert_same(jout, _engine(tmodel, False).serve(_queue()))


def test_pool_too_small_for_the_working_set_raises_as_jax(setup):
    jcfg, jmodel, jparams, tmodel = setup
    jeng = _jax_engine(jmodel, jparams, True, n_blocks=9)
    with pytest.raises(RuntimeError, match="stalled on block top-up"):
        jeng.serve(jax_requests(N_REQ, PLENS, jcfg.vocab, MAX_NEW, seed=3))
    with pytest.raises(RuntimeError, match="stalled on block top-up"):
        _engine(tmodel, True, n_blocks=9).serve(_queue())


def test_mixed_segment_prefills_in_the_segment(setup):
    """Admission prefills nothing: the slots enter PREFILL at cursor 0 with
    only the first segment's pages, and the mixed segment flips them."""
    _, _, _, tmodel = setup
    eng = _engine(tmodel, True)
    eng.admit(_queue())
    assert eng.slots.phase.tolist() == [0, 0]          # PHASE_PREFILL
    assert eng.slots.pos.tolist() == [0, 0]
    # the first segment's rows: 4 steps x 3 = 12 of 20 + 8 - 1, and of
    # 6 + 8 - 1 = 13
    assert eng._slot_pages == [3, 3]
    assert eng._mixed_phase_pending()
    assert all(not v for v in eng.outputs.values())
    eng.run_topped_up_segment(np.ones(2, bool))
    # the 6-token prompt flipped after 2 steps and decoded 2 more; the
    # 20-token one has 12 rows in and keeps prefilling
    assert eng.slots.phase.tolist() == [0, 1]          # PHASE_DECODE = 1
    assert eng.slots.pos.tolist() == [12, 8]
    assert [len(eng.outputs[r]) for r in (0, 1)] == [0, 3]
    eng.run_topped_up_segment(np.ones(2, bool))
    assert eng.slots.phase.tolist() == [1, 1]
    assert eng._slot_pages == [6, 3]   # rows 12 + 12 of 27; 8 + 4 of 13
    assert len(eng.outputs[0]) == 2


def test_lanes_layout_chunk_prefills_at_admission(setup):
    """The sliding-window arch serves from lanes: chunked=True runs
    model.chunk_prefill at admission, with the same streams as the
    whole-prompt prefill and as the JAX chunked lanes engine."""
    jcfg = jget("h2o-danube-3-4b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), 32)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config("h2o-danube-3-4b")
                                           .reduced(), device="cpu"))
    shape = dict(max_seq=32, n_slots=2, segment_len=2, page_size=4)

    def mk():
        return synthetic_requests(3, [11, 5], 256, 5, seed=7)

    eng_c = BatchedServeEngine(tmodel, BatchConfig(
        chunked=True, chunk_size=4, device="cpu", **shape), _internal=True)
    assert eng_c.layout == "lanes" and eng_c.prompts is None
    out_c = eng_c.serve(mk())
    eng_b = BatchedServeEngine(tmodel, BatchConfig(device="cpu", **shape),
                               _internal=True)
    _assert_same(out_c, eng_b.serve(mk()))
    jeng = JaxBatchedEngine(jmodel, jparams, JaxBatchConfig(
        chunked=True, chunk_size=4, **shape), _internal=True)
    _assert_same(out_c, jeng.serve(jax_requests(3, [11, 5], jcfg.vocab, 5,
                                                seed=7)))
    _assert_same_telemetry(eng_c, jeng)


def test_launcher_serves_chunked_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "stablelm-1.6b", "--batched", "--chunked",
          "--chunk-size", "3", "--device", "cpu", "--requests", "4",
          "--slots", "2", "--prompt-len", "10", "--gen-len", "5",
          "--max-seq", "32", "--segment-len", "4", "--ring-size", "2",
          "--page-size", "4"])
    out = capsys.readouterr().out
    assert "[paged, chunked, reference, cpu] served 4 requests / 20 tokens" \
        in out
    assert "'prefill_writes': 40" in out
