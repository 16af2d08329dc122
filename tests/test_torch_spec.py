"""Speculative decoding in the port's engine against the JAX package: the
twins of ``tests/test_spec_decode.py`` (all but its SSM-draft case, whose
family is not ported; a dense cross-arch draft stands in for it).

On the reduced stablelm-1.6b, fp32 on the CPU, with the JAX package's
weights carried across as numpy (and, for a draft of its own, the JAX
engine's draft weights too), the port's spec engine must emit the JAX spec
engine's token streams, per-request path counts and every counter in
``stats`` (``spec_proposed`` / ``spec_accepted`` / ``spec_committed`` /
``spec_rounds`` among them), and greedy spec must emit the non-speculative
engine's streams: across the write paths, chunked prefill, the prefix cache,
the host tier, preemption (greedy, and sampled where the key chains
replay), a cross-arch draft and a virtual tp-2 mesh. ``validate`` refuses
what the JAX package refuses, with its messages, and raises ``not ported
yet`` for a draft it does not have."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import paths as JP
from repro.core.paths import SpecConfig as JaxSpec
from repro.data import RequestQueue as JaxQueue
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatched
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import MemoryConfig as JaxMemory
from repro.serve import build_model_and_params as jax_build
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import paths as TP
from repro_torch.data import RequestQueue, synthetic_requests
from repro_torch.distributed import VIRTUAL_DEVICES_ENV, ParallelConfig
from repro_torch.models import build_model
from repro_torch.serve import (BatchConfig, BatchedServeEngine, Engine,
                               EngineConfig, MemoryConfig, SamplingParams,
                               SpecConfig)

torch.set_num_threads(1)

K = 3
SPEC, JSPEC = SpecConfig(enabled=True, k=K), JaxSpec(enabled=True, k=K)
SPEC_STATS = ("spec_proposed", "spec_accepted", "spec_committed",
              "spec_rounds")
_MODELS, _JAX = {}, {}


def _models():
    """(JAX model, JAX params, the port's model with the same weights): the
    reduced stablelm-1.6b from ``jax.random.key(0)``, as the JAX twins."""
    if not _MODELS:
        jmodel = jbuild(jget("stablelm-1.6b").reduced())
        jparams = jmodel.init(jax.random.key(0), 64)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config("stablelm-1.6b").reduced(), device="cpu"))
        _MODELS.update(j=(jmodel, jparams), t=tmodel)
    return _MODELS


def _kw(n_slots=2, **kw):
    kw.setdefault("max_seq", 48)
    kw.setdefault("segment_len", 4)
    kw.setdefault("page_size", 4)
    return dict(n_slots=n_slots, **kw)


def _engine(spec=None, memory=None, **kw):
    return BatchedServeEngine(_models()["t"], BatchConfig(
        device="cpu", spec=spec, memory=memory, **_kw(**kw)), _internal=True)


def _jengine(spec=None, memory=None, **kw):
    jmodel, jparams = _models()["j"]
    jmem = None if memory is None else JaxMemory(
        prefix_cache=memory.prefix_cache, host_tier=memory.host_tier)
    return JaxBatched(jmodel, jparams, JaxBatchConfig(
        spec=spec, memory=jmem, **_kw(**kw)), _internal=True)


def _queue(n=4, plens=(9, 7, 12, 5), max_new=12, seed=3, make=None):
    return (make or synthetic_requests)(n, list(plens), 256, max_new,
                                        seed=seed)


def _same(a, b):
    assert set(a) == set(b)
    for r in a:
        assert np.array_equal(np.asarray(a[r]), np.asarray(b[r])), r


def _writes(eng, out):
    return {r: tuple(int(x) for x in np.asarray(eng.req_writes[r]))
            for r in out}


def _held_to_jax(eng, out, jeng, jout):
    """Streams, per-request path counts and every counter the port keeps
    equal to the JAX engine's."""
    _same(out, jout)
    assert _writes(eng, out) == _writes(jeng, jout)
    for k in eng.stats:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)


def _jax_run(key, build, queue):
    """The JAX engine's (engine, streams) for ``key``, served once."""
    if key not in _JAX:
        jeng = build()
        _JAX[key] = (jeng, jeng.serve(queue()))
    return _JAX[key]


# ---------------------------------------------------------------------------
# the parity contract: greedy spec == greedy non-spec == the JAX spec engine
# ---------------------------------------------------------------------------

MODES = {
    "direct": {},
    "staged": {"write_mode": "staged", "ring_size": 3},
    "adaptive": {"write_mode": "adaptive", "ring_size": 3,
                 "hot_threshold": 2},
    "chunked": {"chunked": True, "chunk_size": 3},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_spec_equals_nonspec_and_jax(mode):
    kw = MODES[mode]
    base = _engine(**kw).serve(_queue())
    eng = _engine(spec=SPEC, **kw)
    out = eng.serve(_queue())
    _same(out, base)
    assert eng.stats["spec_rounds"] > 0
    jeng, jout = _jax_run(("mode", mode),
                          lambda: _jengine(spec=JSPEC, **kw),
                          lambda: _queue(make=jax_requests))
    _held_to_jax(eng, out, jeng, jout)
    eng.pool.audit()


@pytest.mark.parametrize("plen", [9, 8])
def test_greedy_spec_with_prefix_cache(plen):
    """Prompts opening with the same 8 tokens through the prefix cache and
    chunked prefill: hits start slots mid-prompt (plen 9), or a fully
    cached prompt re-runs its last row in a private copy of its last block
    (plen 8, copy-on-write); spec still gives the plain engine's streams,
    and the JAX spec engine's streams and counters (hit rows, copies)."""
    def q(make=synthetic_requests):
        return make(4, plen, 256, 12, seed=3, shared_prefix=8)
    mem = MemoryConfig(prefix_cache=True)
    base = _engine().serve(q())
    eng = _engine(chunked=True, chunk_size=3, memory=mem, spec=SPEC)
    out = eng.serve(q())
    _same(out, base)
    assert eng.stats["prefix_hit_rows"] > 0
    assert (eng.stats["cow_copies"] > 0) == (plen == 8)
    jeng, jout = _jax_run(
        ("prefix", plen), lambda: _jengine(chunked=True, chunk_size=3,
                                           memory=mem, spec=JSPEC),
        lambda: q(jax_requests))
    _held_to_jax(eng, out, jeng, jout)
    eng.pool.audit()


def test_greedy_spec_over_capacity_host_tier():
    """8 requests x 4 pages over a 5-block pool: parking and restoring
    whole slots interleaves with spec rounds; streams equal an ample
    non-spec engine's and the JAX spec engine's, every unload pages back
    in."""
    def q(make=None):
        return (make or synthetic_requests)(8, 8, 256, 9, seed=2)
    shape = dict(n_slots=4, max_seq=32)
    base = _engine(**shape).serve(q())
    tight = dict(shape, segment_len=1, n_blocks=5,
                 memory=MemoryConfig(host_tier=True))
    eng = _engine(spec=SPEC, **tight)
    out = eng.serve(q())
    _same(out, base)
    assert eng.stats["host_unloads"] > 0
    assert eng.stats["host_pageins"] == eng.stats["host_unloads"]
    eng.pool.audit()
    jeng, jout = _jax_run(("host",), lambda: _jengine(spec=JSPEC, **tight),
                          lambda: q(jax_requests))
    _held_to_jax(eng, out, jeng, jout)


def test_chunked_ring_spec_equals_jax_but_its_empty_drains():
    """Chunked prefill on the staged path: streams, path counts and every
    counter but ``drains`` equal the JAX spec engine's. The JAX spec segment
    never drains at its boundary, so its verify steps (which stage nothing)
    leave the ring cursor past the ring, and the next mixed segment's first
    step counts a drain of the empty ring; the port drains at the spec
    boundary as at every other, so exactly those drains are missing."""
    kw = dict(chunked=True, chunk_size=3, write_mode="staged", ring_size=3)
    base = _engine(**kw).serve(_queue())
    eng = _engine(spec=SPEC, **kw)
    kinds = []
    for name in ("_mixed_segment", "_spec_segment"):
        seg = getattr(eng, name)

        def wrapped(*a, _seg=seg, _name=name):
            kinds.append(_name)
            return _seg(*a)
        setattr(eng, name, wrapped)
    out = eng.serve(_queue())
    _same(out, base)
    jeng, jout = _jax_run(("chunked-staged",),
                          lambda: _jengine(spec=JSPEC, **kw),
                          lambda: _queue(make=jax_requests))
    _same(out, jout)
    assert _writes(eng, out) == _writes(jeng, jout)
    for k in eng.stats:
        if k != "drains":
            assert eng.stats[k] == jeng.stats[k], k
    # segment_len 4 >= ring 3: every spec segment fills the JAX ring cursor
    spec_then_mixed = sum(a == "_spec_segment" and b == "_mixed_segment"
                          for a, b in zip(kinds, kinds[1:]))
    assert spec_then_mixed > 0
    assert jeng.stats["drains"] - eng.stats["drains"] == spec_then_mixed


# ---------------------------------------------------------------------------
# acceptance telemetry
# ---------------------------------------------------------------------------

def test_spec_telemetry_sums_match_committed_tokens():
    """``spec_committed`` counts exactly the tokens spec segments emitted
    (every token but the prefill one); each active round proposes k;
    self-draft (the same model on the same tokens) accepts every proposal,
    so each request takes ceil((tokens - 1) / (k + 1)) rounds."""
    eng = _engine(spec=SPEC)
    out = eng.serve(_queue())
    st = eng.stats
    emitted = sum(len(v) for v in out.values())
    assert st["spec_committed"] == emitted - len(out)
    assert st["spec_proposed"] == K * st["spec_rounds"]
    assert st["spec_accepted"] == st["spec_proposed"]
    assert st["spec_rounds"] == sum(-(-(len(v) - 1) // (K + 1))
                                    for v in out.values())
    assert st["spec_committed"] / st["spec_rounds"] >= 1.5


def test_spec_virtual_clock_counts_committed_tokens():
    """``time_model`` sees a spec segment's committed tokens, not its
    emitting rounds."""
    seen = []
    eng = _engine(spec=SPEC)
    eng.clock = type("Clock", (), {"advance": lambda self, dt: None,
                                   "__call__": lambda self: 0.0})()
    eng.time_model = lambda t: seen.append(t["committed"]) or 0.0
    out = eng.serve(_queue())
    assert sum(seen) == eng.stats["spec_committed"]
    assert sum(seen) == sum(len(v) for v in out.values()) - len(out)


# ---------------------------------------------------------------------------
# a dense cross-arch draft (in place of the JAX twin's SSM draft)
# ---------------------------------------------------------------------------

def _cross_engines():
    """The port's engine with a reduced qwen2-7b draft for the reduced
    stablelm-1.6b target, and the JAX one; the port's draft takes the JAX
    draft's weights."""
    spec = SpecConfig(draft_arch="qwen2-7b", enabled=True, k=K)
    jspec = JaxSpec(draft_arch="qwen2-7b", enabled=True, k=K)
    eng, jeng = _engine(spec=spec), _jengine(spec=jspec)
    assert eng.draft_model is not eng.model
    assert eng.draft_model.cfg.name == "qwen2-7b-smoke"
    params_from_numpy(jax.tree.map(np.asarray, jeng.draft_params),
                      eng.draft_model)
    return eng, jeng


def test_cross_arch_dense_draft_equals_nonspec_and_jax():
    """A random qwen2-7b draft proposes junk: acceptance stays low, nearly
    every round commits the target's own token, and the draft's lanes are
    rewound by cursor every round; streams equal non-spec's and the JAX
    spec engine's, counters too."""
    base = _engine().serve(_queue())
    eng, jeng = _cross_engines()
    out = eng.serve(_queue())
    _same(out, base)
    st = eng.stats
    assert st["spec_committed"] == sum(len(v) for v in out.values()) - len(out)
    assert st["spec_accepted"] < st["spec_proposed"] // 4
    jout = jeng.serve(_queue(make=jax_requests))
    _held_to_jax(eng, out, jeng, jout)


def test_cross_arch_draft_keeps_its_own_lanes():
    """The draft cache is the draft's own dense lanes (qwen2-7b reduced: 2
    KV heads of 16, GQA 4 / 2), separate from the target's paged pool."""
    eng, _ = _cross_engines()
    dcfg = eng.draft_model.cfg
    assert eng.draft_cache["k"].shape == (dcfg.n_layers, 2, 48,
                                          dcfg.n_kv_heads, 16)
    assert dcfg.n_kv_heads != eng.model.cfg.n_kv_heads
    assert "pages_k" in eng.cache


# ---------------------------------------------------------------------------
# preemption: the draft lane is derived data, both key chains restore
# ---------------------------------------------------------------------------

def _preempt_engine(temp, spec):
    return Engine.from_config(EngineConfig(
        max_seq=64, n_slots=2, segment_len=1, device="cpu",
        memory=MemoryConfig(host_tier=True), spec=spec,
        default_params=SamplingParams(temperature=temp, max_tokens=10,
                                      seed=3)), _preempt_model())


def _jpreempt_engine(temp, spec):
    _, jmodel, jparams = _preempt_jax()
    return JaxEngine.from_config(JaxConfig(
        max_seq=64, n_slots=2, segment_len=1,
        memory=JaxMemory(host_tier=True), spec=spec,
        default_params=JaxParams(temperature=temp, max_tokens=10, seed=3)),
        jmodel, jparams)


def _preempt_jax():
    if "pj" not in _MODELS:
        _MODELS["pj"] = jax_build("stablelm-1.6b", 64)
    return _MODELS["pj"]


def _preempt_model():
    """The port's twin of JAX's ``build_model_and_params`` at max_seq 64."""
    if "pt" not in _MODELS:
        _, _, jparams = _preempt_jax()
        _MODELS["pt"] = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config("stablelm-1.6b").reduced(), device="cpu"))
    return _MODELS["pt"]


def _preempt_queue(make=RequestQueue, sp=SamplingParams):
    q = make()
    for i in range(3):
        q.submit(np.arange(1, 5 + i, dtype=np.int32),
                 params=sp(max_tokens=10))
    return q


def _serve_with_one_preemption(eng, q):
    eng.admit(q)
    eng.run_segment(eng._topup_blocks())
    done = np.asarray(eng.slots.done)
    victim = next(s for s in range(eng.cfg.n_slots)
                  if eng._occupied[s] and not done[s])
    eng.preempt_slot(victim, q)
    return eng.serve(q)


def test_greedy_spec_survives_preemption():
    """Preempt a mid-flight slot (KV parked, draft lane stale), resume,
    finish: the stream equals the non-spec unpreempted run and the JAX
    engine's preempted spec run, counters too."""
    base = _preempt_engine(0.0, None).scheduler.serve(_preempt_queue())
    eng = _preempt_engine(0.0, SPEC).scheduler
    out = _serve_with_one_preemption(eng, _preempt_queue())
    assert eng.stats["preemptions"] == eng.stats["preempt_resumes"] == 1
    _same(base, out)
    eng.pool.audit()
    jeng = _jpreempt_engine(0.0, JSPEC).scheduler
    jout = _serve_with_one_preemption(jeng, _preempt_queue(JaxQueue,
                                                           JaxParams))
    _held_to_jax(eng, out, jeng, jout)


def test_sampled_spec_preemption_replays_the_keys():
    """temperature 0.8: the spec stream is a function of the request's
    params and keys. Preempting and resuming replays the uninterrupted spec
    engine's stream (both chains, the target's and the draft's, restore
    from the snapshot), and both equal the JAX spec engine's."""
    base = _preempt_engine(0.8, SPEC).scheduler.serve(_preempt_queue())
    eng = _preempt_engine(0.8, SPEC).scheduler
    out = _serve_with_one_preemption(eng, _preempt_queue())
    assert eng.stats["preemptions"] == 1
    _same(base, out)
    assert eng.stats["spec_accepted"] > 0
    jeng = _jpreempt_engine(0.8, JSPEC).scheduler
    jout = _serve_with_one_preemption(jeng, _preempt_queue(JaxQueue,
                                                           JaxParams))
    _held_to_jax(eng, out, jeng, jout)


def test_preemption_snapshot_keeps_the_draft_key():
    eng = _preempt_engine(0.8, SPEC).scheduler
    q = _preempt_queue()
    eng.admit(q)
    eng.run_segment(eng._topup_blocks())
    victim = 0
    dkey = eng.slots.dkey[victim].clone()
    rid = eng._slot_req[victim]
    assert bool((dkey != 0).any())
    eng.preempt_slot(victim, q)
    assert torch.equal(eng._preempted[rid]["dkey"], dkey)
    eng.admit(q)
    slot = eng._slot_req.index(rid)
    assert torch.equal(eng.slots.dkey[slot], dkey)
    assert eng._draft_pos[slot] == -1


# ---------------------------------------------------------------------------
# a virtual tp-2 mesh: the verify goes through the sharded read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["reference", "fused"])
def test_spec_on_a_tp2_mesh_equals_jax_unsharded(attention, monkeypatch):
    """The pool split on the head axis over two virtual devices, the draft
    lanes whole on the lead: streams, path counts and counters equal the
    port's unsharded spec engine and the JAX unsharded spec engine."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    kw = MODES["adaptive"]
    got = {}
    for tp in (1, 2):
        eng = BatchedServeEngine(_models()["t"], BatchConfig(
            device="cpu", spec=SPEC, attention=attention,
            parallel=ParallelConfig.tensor(tp) if tp > 1 else None,
            **_kw(**kw)), _internal=True)
        got[tp] = (eng, eng.serve(_queue()))
    eng, out = got[2]
    assert eng.mesh is not None and eng.draft_cache["k"].device == \
        eng.device
    _same(out, got[1][1])
    assert dict(eng.stats) == dict(got[1][0].stats)
    jeng, jout = _jax_run(("mode", "adaptive"),
                          lambda: _jengine(spec=JSPEC, **kw),
                          lambda: _queue(make=jax_requests))
    _held_to_jax(eng, out, jeng, jout)


# ---------------------------------------------------------------------------
# validate(): the rejection matrix
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return "ok", None


def test_lanes_layout_rejects_spec():
    """The verify IS decode_chunk_paged: the lanes layout (a sliding-window
    arch, or forced) refuses spec with the JAX package's message."""
    cfg = get_config("h2o-danube-3-4b").reduced()
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="no chunk verifier"):
        BatchedServeEngine(model, BatchConfig(max_seq=32, n_slots=2,
                                              spec=SPEC, device="cpu"),
                           _internal=True)
    with pytest.raises(ValueError, match="no chunk verifier"):
        _engine(kv_layout="lanes", spec=SPEC)
    got = _outcome(lambda: TP.validate(BatchConfig(
        max_seq=32, kv_layout="lanes", spec=SPEC, device="cpu")))
    want = _outcome(lambda: JaxBatched(*_models()["j"], JaxBatchConfig(
        max_seq=32, kv_layout="lanes", spec=JSPEC), _internal=True))
    assert got == want


def test_k_zero_is_rejected():
    with pytest.raises(ValueError, match="k must be >= 1"):
        _engine(spec=SpecConfig(enabled=True, k=0))
    got = _outcome(lambda: _engine(spec=SpecConfig(enabled=True, k=0)))
    want = _outcome(lambda: _jengine(spec=JaxSpec(enabled=True, k=0)))
    assert got == want


def test_vocab_mismatched_draft_is_rejected():
    """The full stablelm-1.6b (vocab 100352) with a qwen2-7b draft (152064
    full, 256 reduced): no vocabulary in common, both sizes named."""
    cfg = get_config("stablelm-1.6b")
    spec = SpecConfig(draft_arch="qwen2-7b", enabled=True)
    with pytest.raises(ValueError, match="no vocabulary"):
        TP.validate(BatchConfig(max_seq=64, spec=spec, device="cpu"),
                    arch_name=cfg.name, vocab=cfg.vocab)
    got = _outcome(lambda: TP.resolve_draft(spec, vocab=cfg.vocab,
                                            arch_name=cfg.name))
    want = _outcome(lambda: JP.resolve_draft(
        JaxSpec(draft_arch="qwen2-7b", enabled=True), vocab=cfg.vocab,
        arch_name=cfg.name))
    assert got[0] == "ValueError" and "152064" in got[1] and got == want


def test_unported_draft_arch_raises_not_ported():
    """The mamba2-130m draft engine builds (a recurrent draft: snapshot
    rollback) and serves the non-speculative engine's greedy streams."""
    eng = _engine(spec=SpecConfig(draft_arch="mamba2-130m", enabled=True))
    assert eng._draft_positional is False
    assert type(eng.draft_model).__name__ == "MambaLM"
    assert set(eng.draft_cache) == {"ssm", "conv"}
    _same(eng.serve(_queue()), _engine().serve(_queue()))


def test_disabled_spec_is_inert():
    """``SpecConfig(enabled=False)`` and ``spec=None`` give the plain
    engine: no draft, no spec telemetry, the same streams."""
    eng = _engine(spec=SpecConfig(enabled=False))
    assert eng.draft_model is None and eng.draft_cache is None
    out = eng.serve(_queue())
    assert all(eng.stats[k] == 0 for k in SPEC_STATS)
    _same(out, _engine().serve(_queue()))
    assert not bool(eng.slots.dkey.any())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b",
                                  "nemotron-4-15b", "h2o-danube-3-4b"])
def test_validate_accepts_spec_on_the_paged_layout(arch):
    """Every ported dense arch resolves a self-draft on the paged layout
    (full and reduced), as the JAX package resolves it."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        plan = TP.validate(BatchConfig(max_seq=64, kv_layout="paged",
                                       spec=SPEC, device="cpu"),
                           arch_name=cfg.name, vocab=cfg.vocab)
        assert plan.spec == SPEC and plan.draft_cfg == cfg
        assert plan.layout == "paged"
