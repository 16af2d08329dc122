"""The lanes layout and the sliding-window decoder against the JAX package.

Reduced h2o-danube-3-4b (window 32, head_dim 16, GQA group 4) with the SAME
weights (initialised by the JAX package, carried across as numpy), fp32 on
the CPU:

* ``prefill`` logits and the lane cache, for a prompt shorter than the window
  and two longer ones (the cache keeps the last ``cache_len`` positions at
  slot ``pos % cache_len``);
* then 44 ``decode_step``s that cross the ring wrap: the same logits (atol
  2e-5) and the same argmax at every step;
* the engine on the lanes layout: identical greedy streams, ``stats`` and
  per-request ``path_counts`` to the JAX ``Engine``; stablelm's paged and
  lanes engines agree; staged/adaptive paths are refused on lanes; a retired
  slot's lane is never written again.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.configs import get_config as jget
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from repro_torch.serve import Engine, EngineConfig, SamplingParams

torch.set_num_threads(1)

ARCH = "h2o-danube-3-4b"
TOL = dict(atol=2e-5, rtol=1e-4)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(11), 64)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config(ARCH).reduced(),
                                           device="cpu"))
    return jcfg, jmodel, jparams, tmodel


def test_reduced_config_keeps_the_window_and_gqa(pair):
    jcfg, _, _, tmodel = pair
    cfg = tmodel.cfg
    assert cfg.sliding_window == jcfg.sliding_window == 32
    assert cfg.n_heads // cfg.n_kv_heads == 4
    assert tmodel.cache_len(64) == 32 and tmodel.cache_len(20) == 20


@pytest.mark.parametrize("max_seq,pos", [(64, [0, 5, 31, 32, 70]),
                                         (20, [0, 19, 7, 3, 12])])
def test_cache_addressing_matches_jax(pair, max_seq, pos):
    from repro.models import transformer as JT
    jcfg, _, _, tmodel = pair
    clen = tmodel.cache_len(max_seq)
    p = np.asarray(pos)
    np.testing.assert_array_equal(
        TT.cache_slots(tmodel.cfg, T(p), clen).numpy(),
        np.asarray(JT.cache_slots(jcfg, jnp.asarray(p), clen)))
    np.testing.assert_array_equal(
        TT.valid_mask(tmodel.cfg, T(p), clen).numpy(),
        np.asarray(JT.valid_mask(jcfg, jnp.asarray(p), clen)))


def test_direct_kv_write_drops_out_of_range_rows():
    from repro.models import transformer as JT
    rng = np.random.RandomState(0)
    kc = rng.randn(3, 6, 2, 4).astype(np.float32)
    vc = rng.randn(3, 6, 2, 4).astype(np.float32)
    kn = rng.randn(3, 1, 2, 4).astype(np.float32)
    vn = rng.randn(3, 1, 2, 4).astype(np.float32)
    slots = np.array([2, 6, 5], np.int64)          # 6: out of range, dropped
    jk, jv = JT.direct_kv_write(*[jnp.asarray(a) for a in (kc, vc, kn, vn)],
                                jnp.asarray(slots))
    tk, tv = T(kc), T(vc)
    TT.direct_kv_write(tk, tv, T(kn), T(vn), T(slots))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[1], kc[1])


@pytest.mark.parametrize("plen", [20, 45, 64])
def test_prefill_and_ring_decode_match_jax(pair, plen):
    """Prompts shorter and longer than the window; 44 decode steps move the
    write slot across the ring's wrap (and past the cache's end)."""
    jcfg, jmodel, jparams, tmodel = pair
    max_seq, b = 128, 2
    tokens = np.random.RandomState(plen).randint(0, jcfg.vocab, (b, plen))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32), max_seq)
    tl, tc = tmodel.prefill(T(tokens), max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    assert tc["k"].shape[2] == 32
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda c, t, p: jmodel.decode_step(jparams, c, t, p))
    for step in range(44):
        pos = np.full((b,), plen + step, np.int32)
        jl, jc = jstep(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tc, T(tok).long(), T(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_decode_step_write_mask_drops_masked_slots(pair):
    """``write_mask`` False sends a slot's rows to the drop row: its lane
    stays as it was in every layer, the other slots' logits and lanes are
    those of the unmasked step."""
    jcfg, jmodel, jparams, tmodel = pair
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab, (3, 40))
    _, cache = tmodel.prefill(T(tokens), 64)
    tok, pos = torch.tensor([3, 4, 5]), torch.tensor([40, 40, 40])
    free = {k: v.clone() for k, v in cache.items()}
    want, _ = tmodel.decode_step(free, tok, pos)
    got, cache = tmodel.decode_step(cache, tok, pos,
                                    write_mask=torch.tensor([True, False, True]))
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name][:, 1].numpy(),
                                      tmodel.prefill(T(tokens), 64)[1][name][:, 1]
                                      .numpy())
        np.testing.assert_array_equal(cache[name][:, [0, 2]].numpy(),
                                      free[name][:, [0, 2]].numpy())
    np.testing.assert_array_equal(got[[0, 2]].numpy(), want[[0, 2]].numpy())


def test_decode_step_refuses_a_staging_ring(pair):
    tmodel = pair[3]
    cache = tmodel.init_cache(2, 40)
    cache["ring_k"] = torch.zeros(1)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tmodel.decode_step(cache, torch.zeros(2, dtype=torch.long),
                           torch.zeros(2, dtype=torch.long))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

MAX_SEQ = 80
PLENS = [9, 40, 16, 5, 45, 33, 7]      # two prompts longer than the window
MAX_NEW = [14, 30, 9, 1, 17, 20, 11]   # 40 + 30 > 64: the ring wraps twice
SHAPES = {"slots3-seg8": dict(max_seq=MAX_SEQ, n_slots=3, segment_len=8,
                              page_size=8),
          "slots2-seg5": dict(max_seq=MAX_SEQ, n_slots=2, segment_len=5,
                              page_size=4)}
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "admitted", "retired", "segments")


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n in PLENS]


@pytest.fixture(scope="module")
def jax_lanes():
    """(numpy params, {shape: (completions, stats, layout)}) from JAX."""
    from repro.serve import build_model_and_params as jax_build
    _, model, params = jax_build(ARCH, MAX_SEQ, seed=3)
    runs = {}
    for name, shape in SHAPES.items():
        eng = JaxEngine.from_config(JaxConfig(path="direct", **shape),
                                    model, params)
        comps = eng.generate(_prompts(),
                             [JaxParams(max_tokens=m) for m in MAX_NEW])
        runs[name] = (comps, dict(eng.stats), eng.layout)
    return jax.tree.map(np.asarray, params), runs


@pytest.fixture(scope="module")
def torch_h2o(jax_lanes):
    return params_from_numpy(jax_lanes[0], build_model(
        get_config(ARCH).reduced(), device="cpu"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lanes_engine_matches_jax(jax_lanes, torch_h2o, shape):
    jcomps, jstats, jlayout = jax_lanes[1][shape]
    eng = Engine.from_config(EngineConfig(path="direct", device="cpu",
                                          **SHAPES[shape]), torch_h2o)
    assert eng.layout == jlayout == "lanes"
    assert eng.attention == "reference"
    tcomps = eng.generate(_prompts(),
                          [SamplingParams(max_tokens=m) for m in MAX_NEW])
    assert len(tcomps) == len(jcomps) == len(PLENS)
    for jc, tc in zip(jcomps, tcomps):
        assert tc.req_id == jc.req_id
        np.testing.assert_array_equal(tc.tokens, np.asarray(jc.tokens))
        assert tc.path_counts == jc.path_counts
        assert tc.finish_reason == jc.finish_reason
    for k in STATS:
        assert eng.stats[k] == jstats[k], (k, eng.stats, jstats)


def test_lanes_engine_repeats_after_reset(torch_h2o):
    eng = Engine.from_config(EngineConfig(path="direct", device="cpu",
                                          **SHAPES["slots3-seg8"]), torch_h2o)
    out1 = eng.serve(synthetic_requests(5, [10, 50], 256, 12))
    eng.reset()
    out2 = eng.serve(synthetic_requests(5, [10, 50], 256, 12))
    assert sorted(out1) == list(range(5))
    for rid in out1:
        assert len(out1[rid]) == 12
        np.testing.assert_array_equal(out1[rid], out2[rid])
    assert eng.scheduler.pool is None


@pytest.mark.parametrize("path", ["staged", "adaptive"])
def test_lanes_refuses_staged_paths(torch_h2o, path):
    from repro.serve import build_model_and_params as jax_build
    with pytest.raises(ValueError, match="direct-only"):
        Engine.from_config(EngineConfig(path=path, device="cpu", max_seq=64),
                           torch_h2o)
    _, jmodel, jparams = jax_build(ARCH, 64)
    with pytest.raises(ValueError, match="direct-only"):
        JaxEngine.from_config(JaxConfig(path=path, max_seq=64), jmodel,
                              jparams)


def test_lanes_refuses_chunked_and_paged_on_swa(torch_h2o):
    """``chunked=True`` serves on lanes (``tests/test_torch_chunked.py``),
    with sampled decoding too (once refused, now ported:
    ``tests/test_torch_sampling.py`` holds its streams to JAX's); the paged
    layout is always refused for a sliding-window arch."""
    eng = Engine.from_config(EngineConfig(path="direct", device="cpu",
                                          max_seq=64, chunked=True),
                             torch_h2o)
    assert eng.layout == "lanes" and eng.scheduler.prompts is None
    sampled = Engine.from_config(EngineConfig(
        path="direct", device="cpu", max_seq=64, chunked=True,
        default_params=SamplingParams(temperature=0.7)), torch_h2o)
    assert sampled.layout == "lanes" and not sampled.scheduler.cfg.greedy
    with pytest.raises(ValueError, match="lanes"):
        Engine.from_config(EngineConfig(path="direct", device="cpu",
                                        max_seq=64, kv_layout="paged"),
                           torch_h2o)


def test_lane_regions_feed_the_monitor(torch_h2o):
    """Lanes regions are ``slot * max_pages + pos // page_size``: the monitor
    sees the prefill rows and one write per decode step of each slot."""
    eng = Engine.from_config(EngineConfig(
        path="direct", device="cpu", max_seq=32, n_slots=2, segment_len=4,
        page_size=4), torch_h2o)
    sch = eng.scheduler
    assert sch.plan.n_regions == 2 * 8
    sch.admit(synthetic_requests(2, [6, 9], 256, 5))
    counts0 = sch.mon_state.counts.clone()
    assert int(counts0[:8].sum()) == 6 and int(counts0[8:].sum()) == 9
    sch.run_segment()
    heat = (sch.mon_state.counts - counts0).numpy()
    want = np.zeros(16, np.int64)
    for slot, plen in ((0, 6), (1, 9)):
        for pos in range(plen, plen + 4):   # 4 decode writes per slot
            want[slot * 8 + pos // 4] += 1
    np.testing.assert_array_equal(heat, want)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
def test_paged_and_lanes_agree_on_a_dense_arch(arch):
    """A linear-addressed arch served from either layout: identical greedy
    streams (fused paged read on the paged side, ``flash_decode`` on
    lanes)."""
    model = build_model(get_config(arch).reduced(), device="cpu").init(5)
    outs = {}
    for layout in ("paged", "lanes"):
        eng = Engine.from_config(EngineConfig(
            path="direct", device="cpu", max_seq=48, n_slots=3,
            segment_len=6, page_size=4, kv_layout=layout), model)
        assert eng.layout == layout
        outs[layout] = eng.serve(synthetic_requests(5, [7, 12, 20], 256, 14))
    for rid in outs["paged"]:
        np.testing.assert_array_equal(outs["paged"][rid], outs["lanes"][rid])


def test_retired_slots_never_write_in_lanes_layout():
    """Twin of the JAX invariant: a retired slot's cache lane is frozen (its
    write goes to the drop row) while the other slot keeps decoding."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, device="cpu").init(0)
    eng = Engine.from_config(EngineConfig(
        max_seq=48, n_slots=2, segment_len=3, page_size=4, path="direct",
        device="cpu"), model)
    sch = eng.scheduler
    q = synthetic_requests(1, 8, cfg.vocab, 3, seed=2)    # retires fast
    q2 = synthetic_requests(1, 8, cfg.vocab, 40, seed=4)  # keeps decoding
    q2._q[0].req_id = 1
    sch.admit(q)
    sch.admit(q2)
    sch.run_segment()
    done = sch.done_flags()
    assert bool(done[0]) and not bool(done[1])
    snap = sch.cache["k"][:, 0].clone()   # slot 0's lane, NOT retired yet
    while any(sch._occupied):
        sch.run_segment()
        sch.retire_done()
    assert torch.equal(sch.cache["k"][:, 0], snap)
    assert not torch.equal(sch.cache["k"][:, 1], torch.zeros_like(snap))
