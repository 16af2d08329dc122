"""The prefix cache in the port against the JAX package: the twins of
``tests/test_prefix_cache.py`` plus parity with the JAX pool and engine.

The refcounted ``BlockPool`` (lifecycle errors, LIFO free order, share /
register / evict / copy-on-write) is held to the JAX pool state for state
under seeded random churn; ``prefix_page_hashes`` equals JAX's value for
value. On the reduced paged archs (stablelm-1.6b, qwen2-7b, nemotron-4-15b),
fp32 on the CPU with the JAX package's weights carried across as numpy, a
cold pass and a warm pass (``reset(keep_cache=True)``) give the JAX engine's
greedy streams, per-request write counts and every write-path and
memory-tier counter, for the direct, staged and adaptive paths; warm streams
equal cold ones and those of an engine without the cache. No direct scatter
and no drain ever writes into a shared or registered block. K2's plain
version matches the JAX oracle on page tables whose leading blocks several
slots share. Every comparison is exact except K2's (atol 2e-6, rtol 1e-4,
the kernel tests' bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import seeds
from repro.configs import get_config as jget
from repro.core.paths import SpecConfig as JaxSpecConfig
from repro.core.paths import negotiate_memory as jax_negotiate_memory
from repro.core.paths import validate as jax_validate
from repro.distributed import ParallelConfig as JaxParallelConfig
from repro.data import synthetic_requests as jax_requests
from repro.kernels import ref as jref
from repro.kvcache import BlockPool as JaxBlockPool
from repro.kvcache import prefix_page_hashes as jax_page_hashes
from repro.models import build_model as jbuild
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatchedEngine
from repro.serve import MemoryConfig as JaxMemoryConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ring as R
from repro_torch.core.paths import (MemoryConfig, SpecConfig,
                                    negotiate_memory, validate)
from repro_torch.data import synthetic_requests
from repro_torch.distributed import VIRTUAL_DEVICES_ENV, ParallelConfig
from repro_torch.kernels import flash_decode_paged
from repro_torch.kvcache import BlockPool, paged as PG
from repro_torch.kvcache import prefix_page_hashes, unload_blocks
from repro_torch.models import build_model
from repro_torch.serve.scheduler import BatchConfig, BatchedServeEngine

torch.set_num_threads(1)

PATHS = ("direct", "staged", "adaptive")
PAGED_ARCHS = ("stablelm-1.6b", "qwen2-7b", "nemotron-4-15b")
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "segments", "admitted", "retired", "prefix_hit_rows", "cow_copies",
         "host_unloads", "host_pageins")


# ---------------------------------------------------------------------------
# lifecycle (twins)
# ---------------------------------------------------------------------------


def test_double_free_raises():
    pool = BlockPool(4)
    got = pool.alloc(0, 2)
    pool.release_block(0, int(got[1]))
    with pytest.raises(ValueError, match="double free|unowned"):
        pool.release_block(0, int(got[1]))


def test_free_unowned_block_raises():
    pool = BlockPool(4)
    pool.alloc(0, 1)
    pool.alloc(1, 1)
    with pytest.raises(ValueError, match="unowned|double free"):
        pool.release_block(0, 1)  # slot 0 never held block 1


def test_alloc_zero_is_noop():
    pool = BlockPool(4)
    got = pool.alloc(3, 0)
    assert got is not None and got.shape == (0,)
    assert pool.n_free == 4 and pool.held(3) == ()
    assert (pool.owner == -1).all()
    pool.audit()


def test_free_slot_reverse_allocation_order():
    pool = BlockPool(4)
    pool.alloc(0, 1)                      # block 0
    pool.alloc(1, 1)                      # block 1
    pool.free_slot(0)                     # 0 back on top of the stack
    pool.alloc(1, 1)                      # block 0 again
    pool.alloc(1, 1)                      # block 2
    assert pool.held(1) == (1, 0, 2)      # allocation order, not id order
    freed = pool.free_slot(1)
    assert freed.tolist() == [2, 0, 1]    # reverse allocation
    assert pool.alloc(2, 3).tolist() == [1, 0, 2]
    pool.audit()


def test_share_keeps_block_live_until_last_holder():
    pool = BlockPool(4)
    b = int(pool.alloc(0, 1)[0])
    pool.share(1, b)
    assert pool.refcount[b] == 2
    pool.free_slot(0)
    assert pool.refcount[b] == 1 and pool.n_free == 3
    pool.free_slot(1)
    assert pool.refcount[b] == 0 and pool.n_free == 4
    pool.audit()


def test_register_first_wins_and_eviction_deregisters():
    pool = BlockPool(2)
    a, b = (int(x) for x in pool.alloc(0, 2))
    assert pool.register(0, a, 77)
    assert not pool.register(0, b, 77)     # hash taken: first wins
    pool.free_slot(0)
    assert pool.lookup(77) == a            # evictable, still hittable
    assert pool.n_free == 1 and pool.n_available == 2
    got = pool.alloc(1, 2)                 # must evict the registered block
    assert sorted(int(x) for x in got) == sorted([a, b])
    assert pool.lookup(77) is None         # eviction de-registers
    pool.audit()


def test_cow_swaps_in_private_block_and_keeps_the_shared_one():
    pool = BlockPool(4)
    src = int(pool.alloc(0, 1)[0])
    pool.register(0, src, 5)
    pool.share(1, src)
    new = pool.cow(1, src)
    assert new is not None and new != src
    assert pool.held(1) == (new,)          # in-place page-index swap
    assert pool.held(0) == (src,)          # other holder untouched
    assert pool.refcount[src] == 1 and pool.refcount[new] == 1
    assert pool.lookup(5) == src           # registration follows the original
    pool.audit()


def test_pool_conservation_under_random_churn():
    for seed in seeds():
        rng = np.random.RandomState(seed)
        pool = BlockPool(16)
        next_hash = iter(range(10_000))
        for _ in range(300):
            slot = int(rng.randint(0, 5))
            op = rng.rand()
            held = pool.held(slot)
            if op < 0.35:
                pool.alloc(slot, int(rng.randint(0, 4)))
            elif op < 0.55 and held:
                pool.free_slot(slot)
            elif op < 0.7:
                other = pool.held(int(rng.randint(0, 5)))
                if other:
                    pool.share(slot, int(rng.choice(other)))
            elif op < 0.85 and held:
                pool.register(slot, int(rng.choice(held)), next(next_hash))
            elif held:
                pool.cow(slot, int(rng.choice(held)))
            pool.audit()
            assert pool.refcount.sum() == sum(
                len(pool.held(s)) for s in range(5))


# ---------------------------------------------------------------------------
# the pool and the hashes, state for state against the JAX package
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (pool.owner.tolist(), pool.refcount.tolist(), list(pool._free),
            {k: list(v) for k, v in pool._held.items()},
            dict(pool._hash_block), dict(pool._block_hash),
            list(pool._evictable))


def _both(pools, op, *args):
    """Apply ``op`` to both pools: the same result or the same error."""
    out = []
    for pool in pools:
        try:
            r = getattr(pool, op)(*args)
            out.append(("ok", None if r is None else np.asarray(r).tolist()))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1], (op, args, out)
    return out[0]


@pytest.mark.parametrize("seed", seeds())
def test_pool_churn_matches_jax_state_for_state(seed):
    """alloc / share (of live and of evictable blocks, found by hash) /
    register (hash collisions included) / cow / release_block / free_slot,
    and invalid releases and shares, on both pools: the same results and
    errors, and the same owner, refcount, free list, held lists, hash index
    and evictable order after every operation."""
    rng = np.random.RandomState(seed)
    pools = (BlockPool(12), JaxBlockPool(12))
    mine = pools[0]
    ops = {k: 0 for k in ("alloc", "free_slot", "share", "register", "cow",
                          "release_block", "invalid")}
    for _ in range(400):
        slot = int(rng.randint(0, 5))
        held = mine.held(slot)
        op = rng.rand()
        if op < 0.25:
            ops["alloc"] += 1
            _both(pools, "alloc", slot, int(rng.randint(0, 5)))
        elif op < 0.37 and held:
            ops["free_slot"] += 1
            _both(pools, "free_slot", slot)
        elif op < 0.52:
            h = int(rng.randint(0, 24))
            b = mine.lookup(h)
            if b is None:
                other = mine.held(int(rng.randint(0, 5)))
                b = int(rng.choice(other)) if other else None
            if b is not None:
                ops["share"] += 1
                _both(pools, "share", slot, b)
        elif op < 0.67 and held:
            ops["register"] += 1
            _both(pools, "register", slot, int(rng.choice(held)),
                  int(rng.randint(0, 24)))
        elif op < 0.8 and held:
            ops["cow"] += 1
            _both(pools, "cow", slot, int(rng.choice(held)))
        elif op < 0.93 and held:
            ops["release_block"] += 1
            _both(pools, "release_block", slot, int(rng.choice(held)))
        else:
            ops["invalid"] += 1
            b = int(rng.randint(0, 12))
            if b not in held:   # a block the slot does not hold
                assert _both(pools, "release_block", slot, b)[0] \
                    == "ValueError"
            if mine.refcount[b] == 0 and b not in mine._evictable:
                assert _both(pools, "share", slot, b)[0] == "ValueError"
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        pools[0].audit()
        pools[1].audit()
    assert all(n > 0 for n in ops.values()), ops


@pytest.mark.parametrize("page_size", [1, 3, 4, 16])
def test_prefix_page_hashes_equal_jax(page_size):
    """Value for value, whatever holds the tokens (int32 / int64 numpy, a
    tensor, a list): the tokens are hashed as Python ints."""
    rng = np.random.RandomState(page_size)
    for n in (0, 2, 17, 64, 100):
        p32 = rng.randint(0, 100352, n).astype(np.int32)
        want = jax_page_hashes(p32, page_size)
        assert len(want) == n // page_size
        for prompt in (p32, p32.astype(np.int64), torch.as_tensor(p32),
                       torch.as_tensor(p32).long(), p32.tolist()):
            assert prefix_page_hashes(prompt, page_size) == want


def test_prefix_page_hashes_chain_properties():
    ps = 4
    a = np.arange(10, dtype=np.int32)
    b = a.copy()
    b[5] = 99                               # differ inside page 1
    ha, hb = prefix_page_hashes(a, ps), prefix_page_hashes(b, ps)
    assert len(ha) == 2                     # full pages only (10 // 4)
    assert ha[0] == hb[0]                   # shared first page
    assert ha[1] != hb[1]                   # divergence poisons the chain
    c = a.copy()
    c[0] = 98                               # differ inside page 0
    hc = prefix_page_hashes(c, ps)
    assert hc[0] != ha[0] and hc[1] != ha[1]
    assert prefix_page_hashes(a, 2)[0] != ha[0]
    assert prefix_page_hashes(np.arange(3, dtype=np.int32), ps) == []


def test_negotiate_memory_rejects_unsupported_combos():
    negotiate_memory(layout="paged", chunked=True, prefix_cache=True,
                     host_tier=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        negotiate_memory(layout="lanes", chunked=True, prefix_cache=True)
    with pytest.raises(ValueError, match="chunked"):
        negotiate_memory(layout="paged", chunked=False, prefix_cache=True)
    with pytest.raises(ValueError, match="host_tier"):
        negotiate_memory(layout="lanes", host_tier=True)


def _validate_outcome(fn):
    try:
        fn()
        return "ok"
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("layout", ["paged", "lanes"])
@pytest.mark.parametrize("chunked", [False, True])
def test_validate_accepts_what_jax_accepts(layout, chunked):
    """Every (prefix_cache, host_tier) pair: the port's ``validate``
    accepts exactly the configs JAX's accepts and raises the same
    ``ValueError`` message otherwise; ``negotiate_memory`` likewise. The
    flat ``prefix_cache`` / ``host_tier`` attributes of a duck-typed config
    mean what ``memory`` means."""
    for pc in (False, True):
        for ht in (False, True):
            kw = dict(max_seq=32, n_slots=2, page_size=4, kv_layout=layout,
                      chunked=chunked)
            want = _validate_outcome(lambda: jax_validate(
                JaxBatchConfig(memory=JaxMemoryConfig(
                    prefix_cache=pc, host_tier=ht), **kw)))
            got = _validate_outcome(lambda: validate(
                BatchConfig(memory=MemoryConfig(prefix_cache=pc,
                                                host_tier=ht),
                            device="cpu", **kw)))
            assert got == want, (pc, ht, got, want)

            class Flat:
                device = "cpu"
                prefix_cache, host_tier = pc, ht
            for k, v in kw.items():
                setattr(Flat, k, v)
            assert _validate_outcome(lambda: validate(Flat())) == want
            assert _validate_outcome(lambda: negotiate_memory(
                layout=layout, chunked=chunked, prefix_cache=pc,
                host_tier=ht)) == _validate_outcome(
                lambda: jax_negotiate_memory(
                    layout=layout, chunked=chunked, prefix_cache=pc,
                    host_tier=ht))


@pytest.mark.parametrize("what,kw", [
    ("parallel", dict(parallel=ParallelConfig.tensor(2))),
    ("spec", dict(spec=SpecConfig(enabled=True))),
    ("sched", dict(sched="sched/preempt")), ("sampled", dict(greedy=False))])
def test_other_features_still_not_ported_with_the_memory_tier(what, kw,
                                                              monkeypatch):
    """Speculative decoding, preemption, sampled decoding and the mesh,
    once refused, now validate with the memory tier as in the JAX package
    (a 2-device mesh: on one device both packages refuse it alike, over
    virtual devices the port resolves it, the prefix cache and the host
    tier with it; spec resolves its self-draft from the target's arch)."""
    mem = MemoryConfig(prefix_cache=True, host_tier=True)
    cfg = BatchConfig(max_seq=32, chunked=True, memory=mem, device="cpu",
                      **kw)
    if what == "spec":
        jcfg = JaxBatchConfig(max_seq=32, chunked=True, memory=JaxMemoryConfig(
            prefix_cache=True, host_tier=True), spec=JaxSpecConfig(
                enabled=True))
        plan = validate(cfg, arch_name="stablelm-1.6b", vocab=256)
        jplan = jax_validate(jcfg, arch_name="stablelm-1.6b", vocab=256)
        assert plan.spec.enabled and jplan.spec.enabled
        assert plan.draft_cfg.name == jplan.draft_cfg.name
        assert (plan.memory.prefix_cache, plan.memory.host_tier) == (
            jplan.memory.prefix_cache, jplan.memory.host_tier)
        return
    if what == "parallel":
        jmem = JaxMemoryConfig(prefix_cache=True, host_tier=True)
        monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
        got = _validate_outcome(lambda: validate(cfg))
        want = _validate_outcome(lambda: jax_validate(JaxBatchConfig(
            max_seq=32, chunked=True, memory=jmem,
            parallel=JaxParallelConfig.tensor(2))))
        assert "needs 2 devices" in got and "needs 2 devices" in want
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
        plan = validate(cfg)
        assert plan.mesh is not None and plan.parallel.tp == 2
        assert (plan.memory.prefix_cache, plan.memory.host_tier) == (
            True, True)
        return
    plan = validate(cfg)
    jplan = jax_validate(JaxBatchConfig(
        max_seq=32, chunked=True, **kw,
        memory=JaxMemoryConfig(prefix_cache=True, host_tier=True)))
    assert (plan.sched.name, plan.sched.preempts) == (
        jplan.sched.name, jplan.sched.preempts)
    assert (plan.memory.prefix_cache, plan.memory.host_tier) == (True, True)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

MAX_SEQ, PLEN, MAX_NEW = 32, 8, 5
SHAPE = dict(max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
             chunked=True, chunk_size=3, ring_size=3, hot_threshold=2)
# a richer mix for parity: 2 shared pages, one prompt fully cached (CoW),
# one with a partial page past the prefix, one with a page of its own
MIX = dict(n=5, plens=[10, 8, 13], shared=8)
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


def _mk(arch="stablelm-1.6b", prefix_cache=True, mode="direct", **kw):
    kw.setdefault("memory", MemoryConfig(prefix_cache=prefix_cache))
    return BatchedServeEngine(_models(arch)[2], BatchConfig(
        write_mode=mode, device="cpu", **dict(SHAPE, **kw)), _internal=True)


def _jax_mk(arch, mode, **kw):
    jmodel, jparams, _ = _models(arch)
    return JaxBatchedEngine(jmodel, jparams, JaxBatchConfig(
        write_mode=mode, memory=JaxMemoryConfig(prefix_cache=True),
        **dict(SHAPE, **kw)), _internal=True)


def _queue(n=3, plens=PLEN, shared=PLEN):
    return synthetic_requests(n, plens, 256, MAX_NEW, seed=3,
                              shared_prefix=shared)


def _same(a, b):
    return set(a) == set(b) and all(np.array_equal(np.asarray(a[r]),
                                                   np.asarray(b[r]))
                                    for r in a)


def _assert_parity(eng, jeng):
    for k in STATS:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
    assert set(eng.req_writes) == set(jeng.req_writes)
    for rid, w in eng.req_writes.items():
        np.testing.assert_array_equal(w, np.asarray(jeng.req_writes[rid]))


@pytest.mark.parametrize("mode", PATHS)
def test_warm_prefix_serving_is_bit_identical(mode):
    eng = _mk(mode=mode)
    cold_out = eng.serve(_queue())
    eng.reset(keep_cache=True)
    warm_out = eng.serve(_queue())
    assert eng.stats["prefix_hit_rows"] > 0
    assert _same(warm_out, cold_out)
    eng.pool.audit()
    assert _same(warm_out, _mk(prefix_cache=False, mode=mode).serve(_queue()))


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_warm_prefix_bit_identical_across_paged_archs(arch):
    eng = _mk(arch=arch, mode="adaptive")
    cold_out = eng.serve(_queue())
    eng.reset(keep_cache=True)
    warm_out = eng.serve(_queue())
    assert eng.stats["prefix_hit_rows"] > 0
    assert _same(warm_out, cold_out)
    eng.pool.audit()


def test_cow_never_mutates_a_registered_block():
    eng = _mk()
    eng.serve(_queue())
    prompt = _queue().at(0).prompt
    blocks = [eng.pool.lookup(h) for h in prefix_page_hashes(prompt, 4)]
    assert all(b is not None for b in blocks)
    before = unload_blocks(eng.cache, blocks)
    eng.reset(keep_cache=True)
    warm_out = eng.serve(_queue())
    assert eng.stats["cow_copies"] >= 1
    assert eng.stats["prefix_hit_rows"] > 0
    after = unload_blocks(eng.cache, blocks)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
    assert _same(warm_out, _mk(prefix_cache=False).serve(_queue()))


@pytest.mark.parametrize("traffic", ["twin", "mix"])
@pytest.mark.parametrize("mode", PATHS)
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
def test_prefix_cache_matches_jax_cold_and_warm(arch, mode, traffic):
    """Cold pass, then warm pass after ``reset(keep_cache=True)``: after
    each, the streams, every counter (``prefix_hit_rows`` and
    ``cow_copies`` included: a hash that differed from JAX's would only show
    as fewer hits) and the per-request [direct, staged, prefill] writes
    equal the JAX engine's."""
    spec = (dict(n=3, plens=PLEN, shared=PLEN) if traffic == "twin"
            else dict(n=MIX["n"], plens=MIX["plens"], shared=MIX["shared"]))
    jeng, eng = _jax_mk(arch, mode), _mk(arch=arch, mode=mode)
    outs = []
    for warm in (False, True):
        if warm:
            jeng.reset(keep_cache=True)
            eng.reset(keep_cache=True)
        jout = jeng.serve(jax_requests(spec["n"], spec["plens"], 256,
                                       MAX_NEW, seed=3,
                                       shared_prefix=spec["shared"]))
        out = eng.serve(_queue(**spec))
        assert _same(out, jout), warm
        _assert_parity(eng, jeng)
        eng.pool.audit()
        assert _pool_state(eng.pool) == _pool_state(jeng.pool)
        outs.append(out)
    assert eng.stats["prefix_hit_rows"] > 0 and eng.stats["cow_copies"] > 0
    assert _same(outs[0], outs[1])


def _guard_writes(monkeypatch, eng, seen):
    """Fail on any direct scatter or drain row that lands in a block with
    refcount > 1 or a registered hash (the sink block is never shared)."""
    ps = eng.cfg.page_size

    def check(rows):
        rows = rows.reshape(-1)
        blocks = (rows[rows < PG.pool_rows(eng.cache)] // ps).tolist()
        seen.append(len(blocks))
        for b in blocks:
            assert eng.pool.refcount[b] <= 1, f"write into shared block {b}"
            assert not eng.pool.is_registered(b), \
                f"write into registered block {b}"

    scatter_token, scatter_chunk = PG.scatter_token, PG.scatter_chunk
    rows_layers = R.scatter_rows_layers

    def token(pages_l, dest, tile):
        check(dest)
        return scatter_token(pages_l, dest, tile)

    def chunk(pages_l, dest, tiles):
        check(dest)
        return scatter_chunk(pages_l, dest, tiles)

    def drain(planes, rows, ok):
        check(rows[ok.bool()])
        return rows_layers(planes, rows, ok)

    monkeypatch.setattr(PG, "scatter_token", token)
    monkeypatch.setattr(PG, "scatter_chunk", chunk)
    monkeypatch.setattr(R, "scatter_rows_layers", drain)


@pytest.mark.parametrize("mode", PATHS)
def test_no_write_lands_in_a_shared_or_registered_block(monkeypatch, mode):
    """Warm passes (shared prefix blocks, one CoW'd block a fully cached
    prompt), and again with the host tier parking slots on a tight pool:
    every direct row and every drained row goes to a private, unregistered
    block."""
    seen = []
    def mix():
        return _queue(n=6, plens=MIX["plens"], shared=MIX["shared"])

    def tight():
        return synthetic_requests(6, 8, 256, 7, seed=4, shared_prefix=4)

    both = MemoryConfig(prefix_cache=True, host_tier=True)
    for kw, queue in ((dict(), mix), (dict(n_slots=3, segment_len=4,
                                           n_blocks=6, memory=both), tight)):
        eng = _mk(mode=mode, **kw)
        _guard_writes(monkeypatch, eng, seen)
        eng.serve(queue())
        eng.reset(keep_cache=True)
        eng.serve(queue())
        assert eng.stats["prefix_hit_rows"] > 0
        assert eng.stats["host_unloads"] > 0 or "n_blocks" not in kw
        monkeypatch.undo()
    assert sum(seen) > 0


def _aliased_k2_inputs(seed):
    """K2's operands as a prefix hit makes them: 4 slots whose 4 leading
    pages are the same physical blocks; slot 0 prefills a chunk of 4 at
    ``cached_rows`` 16 (a page multiple), slot 1 runs the 1-row chunk of a
    fully cached 24-token prompt at row 23 (its last block a private CoW
    copy), slots 2-3 decode with 2 staged rows in the ring. Columns past a
    slot's valid rows read what the engine's view mask gives them."""
    b, c, hq, hkv, d, nb, ps, p, r = 4, 4, 4, 2, 16, 30, 4, 8, 3
    rng = np.random.RandomState(seed)
    q = rng.randn(b, c, hq, d).astype(np.float32)
    pk = rng.randn(nb, ps, hkv, d).astype(np.float32)
    pv = rng.randn(nb, ps, hkv, d).astype(np.float32)
    ids = rng.permutation(nb)
    blocks = np.zeros((b, p), np.int32)
    blocks[:, :4] = ids[:4]                        # the shared prefix
    blocks[:, 4:] = ids[4:4 + b * 4].reshape(b, 4)
    start = np.array([16, 23, 27, 21])
    reach = np.minimum(start + 2 * c, p * ps)
    live_page = np.arange(p)[None] < -(-reach // ps)[:, None]
    blocks = np.where(live_page, blocks, 0).astype(np.int32)
    rows = np.arange(p * ps)
    positions = start[:, None] + np.arange(c)[None]
    view_ok = (rows[None, None] <= positions[..., None]) \
        & np.repeat(live_page, ps, axis=1)[:, None]
    decode = np.arange(b) >= 2
    staged = decode[:, None] & (rows[None] > start[:, None] - 2) \
        & (rows[None] <= start[:, None])
    view_ok &= ~staged[:, None]
    rk = rng.randn(b, r, hkv, d).astype(np.float32)
    rv = rng.randn(b, r, hkv, d).astype(np.float32)
    rok = decode[:, None] & (np.arange(r)[None] < 2)
    return q, pk, pv, blocks, view_ok, rk, rv, rok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_plain_matches_jax_on_aliased_page_tables(seed):
    args = _aliased_k2_inputs(seed)
    assert (args[3][:, :4] == args[3][0, :4]).all()
    want = np.asarray(jref.flash_decode_paged_ref(
        *[jnp.asarray(a) for a in args]))
    got = flash_decode_paged(*[torch.as_tensor(a) for a in args])
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-4)
