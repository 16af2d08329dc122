"""The host tier in the port against the JAX package: the twins of
``tests/test_host_tier.py`` plus parity with the JAX engine.

When the block pool runs short, whole slots strictly younger than the
requester are parked (their blocks copied to host memory, page-table rows
cleared, the slots stalled) and paged back in oldest first. On the reduced
stablelm-1.6b and qwen2-7b, fp32 on the CPU with the JAX package's weights
carried across as numpy, blocking and chunked serving on a tight pool, and
the prefix cache with the host tier together (cold and warm), give the JAX
engine's greedy streams, per-request write counts and every write-path and
memory-tier counter on the direct, staged and adaptive paths, and the
streams of an ample pool. ``unload_blocks`` -> ``load_blocks`` is
bit-exact and returns copies, never views of the pool; ``copy_block``
equals JAX's on the same numpy pool. Every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import synthetic_requests as jax_requests
from repro.kvcache import copy_block as jax_copy_block
from repro.kvcache import load_blocks as jax_load_blocks
from repro.kvcache import make_paged_kv as jax_make_paged_kv
from repro.kvcache import unload_blocks as jax_unload_blocks
from repro.models import build_model as jbuild
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatchedEngine
from repro.serve import MemoryConfig as JaxMemoryConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.paths import MemoryConfig
from repro_torch.data import RequestQueue, synthetic_requests
from repro_torch.kvcache import (copy_block, load_blocks, make_paged_kv,
                                 unload_blocks)
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.scheduler import BatchConfig, BatchedServeEngine

torch.set_num_threads(1)

PATHS = ("direct", "staged", "adaptive")
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "segments", "admitted", "retired", "prefix_hit_rows", "cow_copies",
         "host_unloads", "host_pageins")
MAX_SEQ = 32
SHAPE = dict(max_seq=MAX_SEQ, page_size=4, ring_size=3, hot_threshold=2)
# the JAX twins' three tight pools: (engine shape, memory, request spec)
TIGHT = {
    "blocking": (dict(n_slots=4, segment_len=4, n_blocks=5),
                 dict(host_tier=True), dict(n=8, plens=8, new=9, seed=2)),
    "chunked": (dict(n_slots=4, segment_len=4, n_blocks=6, chunked=True,
                     chunk_size=3),
                dict(host_tier=True), dict(n=8, plens=[12, 4], new=7,
                                           seed=5)),
    "both": (dict(n_slots=3, segment_len=4, n_blocks=6, chunked=True,
                  chunk_size=3),
             dict(host_tier=True, prefix_cache=True),
             dict(n=6, plens=8, new=7, seed=4, shared=4)),
}
_MODELS = {}


def _models(arch):
    """(JAX model, JAX params, port model with the same weights)."""
    if arch not in _MODELS:
        jmodel = jbuild(jget(arch).reduced())
        jparams = jmodel.init(jax.random.key(0), MAX_SEQ)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config(arch).reduced(), device="cpu"))
        _MODELS[arch] = (jmodel, jparams, tmodel)
    return _MODELS[arch]


def _engine(arch="stablelm-1.6b", **kw):
    return BatchedServeEngine(_models(arch)[2], BatchConfig(
        device="cpu", **dict(SHAPE, **kw)), _internal=True)


def _tight(case, arch="stablelm-1.6b", mode="direct", ample=False):
    shape, mem, _ = TIGHT[case]
    shape = dict(shape)
    if ample:
        shape.pop("n_blocks")
        mem = {}
    return _engine(arch, write_mode=mode, memory=MemoryConfig(**mem),
                   **shape)


def _jax_tight(case, arch, mode):
    shape, mem, _ = TIGHT[case]
    jmodel, jparams, _ = _models(arch)
    return JaxBatchedEngine(jmodel, jparams, JaxBatchConfig(
        write_mode=mode, memory=JaxMemoryConfig(**mem),
        **dict(SHAPE, **shape)), _internal=True)


def _requests(case, make=synthetic_requests, vocab=256):
    r = TIGHT[case][2]
    return make(r["n"], r["plens"], vocab, r["new"], seed=r["seed"],
                shared_prefix=r.get("shared", 0))


def _same(a, b):
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[r]),
                                                   np.asarray(b[r]))
                                    for r in a)


# ---------------------------------------------------------------------------
# bulk device <-> host block transfers
# ---------------------------------------------------------------------------


def test_unload_load_roundtrip_is_bit_exact():
    rng = np.random.RandomState(0)
    cache = make_paged_kv(2, 6, 4, 2, 3, 2, 8, ring_size=0, device="cpu")
    k = rng.randn(*cache["pages_k"].shape).astype(np.float32)
    v = rng.randn(*cache["pages_v"].shape).astype(np.float32)
    cache["pages_k"].copy_(torch.as_tensor(k))
    cache["pages_v"].copy_(torch.as_tensor(v))
    blocks = [4, 1, 3]
    host_k, host_v = unload_blocks(cache, blocks)
    assert tuple(host_k.shape) == (2, 3, 4, 2, 8)
    # the host copies equal JAX's on the same pool (the port's planes carry
    # one sink block more: JAX's pool is the first 6)
    jcache = jax_make_paged_kv(2, 6, 4, 2, 3, 2, 8, ring_size=0)
    jcache["pages_k"], jcache["pages_v"] = (jnp.asarray(k[:, :6]),
                                            jnp.asarray(v[:, :6]))
    jk, jv = jax_unload_blocks(jcache, blocks)
    assert np.array_equal(host_k.numpy(), jk)
    assert np.array_equal(host_v.numpy(), jv)
    # scramble the unloaded blocks, then restore (from JAX's numpy copy too)
    for plane in (cache["pages_k"], cache["pages_v"]):
        plane[:, blocks] = 0.0
    load_blocks(cache, blocks, host_k, host_v)
    assert np.array_equal(cache["pages_k"].numpy(), k)
    assert np.array_equal(cache["pages_v"].numpy(), v)
    cache["pages_k"][:, blocks] = 0.0
    load_blocks(cache, blocks, jk, jv)
    assert np.array_equal(cache["pages_k"].numpy(), k)
    jcache = jax_load_blocks(jcache, [0, 5, 2], jk, jv)
    load_blocks(cache, [0, 5, 2], host_k, host_v)
    assert np.array_equal(cache["pages_k"].numpy()[:, :6],
                          np.asarray(jcache["pages_k"]))


def test_unload_blocks_returns_copies_not_views():
    """The host store must survive the blocks being freed and rewritten."""
    cache = make_paged_kv(1, 4, 2, 1, 2, 1, 4, ring_size=0, device="cpu")
    cache["pages_k"].fill_(1.0)
    host_k, host_v = unload_blocks(cache, [2, 0])
    cache["pages_k"].fill_(7.0)
    cache["pages_v"].fill_(7.0)
    assert (host_k == 1.0).all() and (host_v == 0.0).all()


def test_copy_block_duplicates_one_block():
    k = np.random.RandomState(1).randn(2, 5, 4, 2, 8).astype(np.float32)
    cache = make_paged_kv(2, 4, 4, 1, 2, 2, 8, ring_size=0, device="cpu")
    cache["pages_k"].copy_(torch.as_tensor(k))
    copy_block(cache, 2, 0)
    got = cache["pages_k"].numpy()
    assert np.array_equal(got[:, 0], k[:, 2])
    assert np.array_equal(got[:, 1:], k[:, 1:])  # others untouched
    jcache = jax_make_paged_kv(2, 4, 4, 1, 2, 2, 8, ring_size=0)
    jcache["pages_k"] = jnp.asarray(k[:, :4])
    jcache = jax_copy_block(jcache, 2, 0)
    assert np.array_equal(got[:, :4], np.asarray(jcache["pages_k"]))


# ---------------------------------------------------------------------------
# over-capacity serving (twins)
# ---------------------------------------------------------------------------


def test_overcapacity_blocking_serving_is_bit_identical():
    """8 requests x 4 pages over a 5-block pool (4 slots): the host tier
    absorbs the overflow and the streams match an ample pool exactly."""
    eng_o = _tight("blocking")
    out_o = eng_o.serve(_requests("blocking"))
    out_a = _tight("blocking", ample=True).serve(_requests("blocking"))
    assert eng_o.stats["host_unloads"] > 0
    assert eng_o.stats["host_pageins"] == eng_o.stats["host_unloads"]
    assert _same(out_o, out_a)
    eng_o.pool.audit()


def test_overcapacity_chunked_serving_is_bit_identical():
    eng_o = _tight("chunked")
    out_o = eng_o.serve(_requests("chunked"))
    out_a = _tight("chunked", ample=True).serve(_requests("chunked"))
    assert eng_o.stats["host_unloads"] > 0
    assert _same(out_o, out_a)
    eng_o.pool.audit()


def test_overcapacity_with_prefix_cache_and_staged_writes():
    eng_o = _tight("both", mode="staged")
    out_o = eng_o.serve(_requests("both"))
    out_a = _tight("both", ample=True).serve(_requests("both"))
    assert _same(out_o, out_a)
    eng_o.pool.audit()


def test_host_tier_requires_paged_layout():
    with pytest.raises(ValueError, match="host_tier"):
        _engine(n_slots=2, kv_layout="lanes",
                memory=MemoryConfig(host_tier=True))


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------


def _assert_parity(eng, jeng):
    for k in STATS:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
    assert set(eng.req_writes) == set(jeng.req_writes)
    for rid, w in eng.req_writes.items():
        np.testing.assert_array_equal(w, np.asarray(jeng.req_writes[rid]))
    assert eng.pool.owner.tolist() == jeng.pool.owner.tolist()
    assert list(eng.pool._free) == list(jeng.pool._free)
    assert list(eng.pool._evictable) == list(jeng.pool._evictable)


@pytest.mark.parametrize("case", ["blocking", "chunked"])
@pytest.mark.parametrize("mode", PATHS)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
def test_host_tier_matches_jax(arch, mode, case):
    """Tight pool: the same parks and restores (``host_unloads``,
    ``host_pageins``), streams, write counters and per-request writes as
    the JAX engine, the streams of an ample pool, and no slot left
    parked."""
    jeng, eng = _jax_tight(case, arch, mode), _tight(case, arch, mode)
    jout = jeng.serve(_requests(case, jax_requests))
    out = eng.serve(_requests(case))
    assert _same(out, jout)
    _assert_parity(eng, jeng)
    assert eng.stats["host_unloads"] > 0
    assert not any(eng._parked) and not eng._host_store
    eng.pool.audit()
    assert _same(out, _tight(case, arch, mode, ample=True).serve(
        _requests(case)))


@pytest.mark.parametrize("mode", PATHS)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
def test_prefix_cache_with_host_tier_matches_jax(arch, mode):
    """Both together on a tight pool, a cold pass and then a warm one after
    ``reset(keep_cache=True)``: parity with the JAX engine after each."""
    jeng, eng = _jax_tight("both", arch, mode), _tight("both", arch, mode)
    for warm in (False, True):
        if warm:
            jeng.reset(keep_cache=True)
            eng.reset(keep_cache=True)
        jout = jeng.serve(_requests("both", jax_requests))
        out = eng.serve(_requests("both"))
        assert _same(out, jout), warm
        _assert_parity(eng, jeng)
        eng.pool.audit()
    assert eng.stats["prefix_hit_rows"] > 0
    assert _same(out, _tight("both", arch, mode, ample=True).serve(
        _requests("both")))


# ---------------------------------------------------------------------------
# the park itself
# ---------------------------------------------------------------------------


def _parked_engine(mode="staged"):
    """A chunked engine on a tight pool, stepped until a slot is parked."""
    eng = _tight("chunked", mode=mode)
    queue = _requests("chunked")
    for _ in range(20):
        eng.retire_done()
        eng.admit(queue)
        live = ~eng.done_flags() & np.asarray(eng._occupied)
        enabled = eng._topup_blocks()
        if any(eng._parked):
            return eng, enabled, queue
        eng.run_segment(enabled & live)
    raise AssertionError("no slot was parked")


def test_park_clears_the_row_disables_the_slot_and_copies_its_blocks():
    eng, enabled, queue = _parked_engine()
    s = eng._parked.index(True)
    assert not enabled[s]
    assert (eng.cache["page_table"][s] == -1).all()
    assert eng.pool.held(s) == () and eng._slot_pages[s] == 0
    n, host_k, host_v = eng._host_store[s]
    assert host_k.shape[1] == n and host_v.shape[1] == n
    # the freed blocks are rewritten: the host copy must not move
    before = host_k.clone()
    eng.cache["pages_k"].fill_(123.0)
    assert torch.equal(host_k, before)
    assert eng.stats["host_unloads"] >= n


def test_park_refuses_staged_rows_in_flight():
    eng, _, _ = _parked_engine()
    victim = next(s for s in range(eng.cfg.n_slots)
                  if eng._occupied[s] and not eng._parked[s])
    eng.cache["ring_pos"][victim, 0] = 3
    with pytest.raises(RuntimeError, match="staged rows"):
        eng._park(victim)


def test_reset_keep_cache_needs_a_drained_engine():
    eng, _, _ = _parked_engine()
    with pytest.raises(RuntimeError, match="drained engine"):
        eng.reset(keep_cache=True)
    eng.reset()
    eng.reset(keep_cache=True)


def test_engine_reset_keep_cache_serves_warm():
    """``Engine.reset(keep_cache=True)`` passes through to the scheduler:
    the second pass hits the prefix cache and repeats the first's
    streams."""
    model = _models("stablelm-1.6b")[2]
    eng = Engine.from_config(EngineConfig(
        max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
        chunked=True, chunk_size=3, device="cpu",
        memory=MemoryConfig(prefix_cache=True)), model)
    prompts = [np.arange(12, dtype=np.int32) % 256,
               np.arange(9, dtype=np.int32) % 256]
    cold = eng.generate(prompts)
    hits = eng.stats["prefix_hit_rows"]
    eng.reset(keep_cache=True)
    warm = eng.generate(prompts)
    assert eng.stats["prefix_hit_rows"] > hits
    assert [c.tokens.tolist() for c in warm] == \
        [c.tokens.tolist() for c in cold]


# ---------------------------------------------------------------------------
# bounded skip-ahead (twins)
# ---------------------------------------------------------------------------


def _starvation_queue():
    """Two staggered smalls, one BIG (needs the whole 4-block pool), then a
    tail of smalls whose lifetimes overlap."""
    q = RequestQueue()
    rng = np.random.RandomState(0)
    small = lambda mn: q.submit(  # noqa: E731
        rng.randint(0, 256, 2).astype(np.int32), mn)
    small(2)
    small(3)
    big_id = q.submit(rng.randint(0, 256, 8).astype(np.int32), 9)
    for _ in range(6):
        small(3)
    return q, big_id


def test_bounded_skip_ahead_prevents_starvation():
    eng = _engine(n_slots=2, n_blocks=4, segment_len=1,
                  memory=MemoryConfig(skip_ahead_limit=2))
    q, big_id = _starvation_queue()
    last_id = len(q) - 1
    out = eng.serve(q)
    assert len(out) == 9 and len(out[big_id]) == 9
    assert eng.ttft[big_id] < eng.ttft[last_id]


def test_unbounded_skip_ahead_documents_the_starvation():
    eng = _engine(n_slots=2, n_blocks=4, segment_len=1,
                  memory=MemoryConfig(skip_ahead_limit=10_000))
    q, big_id = _starvation_queue()
    last_id = len(q) - 1
    out = eng.serve(q)
    assert len(out) == 9 and len(out[big_id]) == 9
    assert eng.ttft[big_id] > eng.ttft[last_id]
