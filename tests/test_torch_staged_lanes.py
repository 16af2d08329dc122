"""The staging ring on the lanes cache (``kvcache/staged.py``), the ring
branch of ``DecoderLM.decode_step`` and the per-request ``ServeEngine``,
against the JAX package, fp32 on the CPU.

* Every ``staged`` function on the same numpy inputs: exact (the ring's
  metadata, validity, masks, conflicts and drained caches bit for bit).
* Twins of ``tests/test_kvcache.py``: staged ring decode = direct decode
  (qwen2-7b, and h2o-danube-3-4b with its sliding-window ring, also past the
  window, where the ring wraps), adaptive mixed routing = the full forward,
  and the drain (one table-of-planes call in the port) = the JAX package's
  per-sequence drain.
* ``ServeEngine`` = JAX's ``ServeEngine`` for direct, staged and adaptive,
  greedy and sampled, ``decode`` and ``decode_reference``, at ring sizes 1
  (a drain every step) and 4 (decoding past ``max_seq`` clamps the slot, so
  conflicts force drains): tokens and ``stats``.
* The port's paged engine = the port's ``ServeEngine``, token for token
  (the twin of ``tests/test_serve_batched.py``'s cross-substrate check).
Tolerance where not exact: atol 1e-5 / rtol 1e-4 (the twins' own 1e-4 on
logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kvcache as JK
from repro.configs import get_config as jget
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import kvcache as TK
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.kvcache import staged as ST
from repro_torch.models import build_model, prng
from repro_torch.serve import (WRITE_MODES, BatchConfig, BatchedServeEngine,
                               ServeConfig, ServeEngine, make_decision)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)


def same(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def close(got, want, what="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL), err_msg=what)


def T(a):
    return torch.from_numpy(np.array(a))


def pair_model(arch, max_seq=64, seed=0):
    """(reduced config, JAX model, params, the port's model on them)."""
    cfg = jget(arch).reduced()
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.key(seed), max_seq)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config(arch).reduced(),
                                           device="cpu"))
    return cfg, jmodel, jparams, tmodel


# ---------------------------------------------------------------------------
# every staged function on the same inputs
# ---------------------------------------------------------------------------


def test_each_staged_function_equals_jax():
    """A ring of 4 on a cache [2, 3, 8, 2, 4] walked through stages,
    commits (one sequence direct each step, one slot repeated), the overlay
    masks, conflicts, a gated drain with nothing due, a due one and a full
    drain: every output and every cache leaf equal JAX's exactly."""
    rng = np.random.RandomState(0)
    l, b, s, h, dh, r = 2, 3, 8, 2, 4, 4
    kv = {n: rng.randn(l, b, s, h, dh).astype(np.float32) for n in "kv"}
    jc = JK.add_ring({n: jnp.asarray(a) for n, a in kv.items()}, r)
    tc = ST.add_ring({n: T(a.copy()) for n, a in kv.items()}, r)
    assert set(tc) == set(jc) and set(ST.strip_ring(tc)) == {"k", "v"}
    for n in jc:
        assert tuple(tc[n].shape) == tuple(jc[n].shape), n
        same(tc[n], jc[n], n)
    steps = [([1, 5, 2], [True, False, True]),
             ([2, 6, 3], [True, True, False]),
             ([3, 7, 3], [False, True, True]),
             ([4, 7, 5], [True, False, True])]
    for t, (slots, unload) in enumerate(steps):
        js, ju = jnp.asarray(slots, jnp.int32), jnp.asarray(unload)
        ts, tu = T(np.asarray(slots, np.int64)), T(np.asarray(unload))
        vmask = rng.rand(b, s) > 0.3
        jm, jd, jcur = JK.overlay_step(jc, jnp.asarray(vmask), js, ju)
        tm, td, tcur = ST.overlay_step(tc, T(vmask), ts, tu)
        same(tm, jm, f"full_mask {t}")
        same(td, jd, f"direct_slots {t}")
        assert int(tcur) == int(jcur)
        same(ST.overlay_masks(tc, T(vmask)),
             JK.overlay_masks(jc, jnp.asarray(vmask)), f"overlay_masks {t}")
        same(ST.ring_conflicts(tc, ts), JK.ring_conflicts(jc, js))
        same(ST.ring_full(tc), JK.ring_full(jc))
        same(ST.ring_validity(tc), JK.ring_validity(jc))
        state, jstate = ST.ring_state(tc), JK.ring_state(jc)
        same(state.live, jstate.live)
        same(state.head, jstate.head)
        tiles = rng.randn(l, b, 1, h, dh).astype(np.float32)
        rk, rv = jc["ring_k"], jc["ring_v"]
        jc = dict(jc, ring_k=jnp.stack([JK.stage_tile(rk[i], tiles[i], jcur)
                                        for i in range(l)]),
                  ring_v=jnp.stack([JK.stage_tile(rv[i], -tiles[i], jcur)
                                    for i in range(l)]))
        for i in range(l):
            ST.stage_tile(tc["ring_k"][i], T(tiles[i]), tcur)
            ST.stage_tile(tc["ring_v"][i], T(-tiles[i]), tcur)
        jc = JK.ring_commit(jc, js, ju)
        tc = ST.ring_commit(tc, ts, tu)
        for n in jc:
            same(tc[n], jc[n], f"{n} after step {t}")
        lk, lv = rng.randn(2, b, s, h, dh).astype(np.float32)
        for got, want in zip(
                ST.overlay_kv(tc, T(lk), T(lv), tc["ring_k"][0],
                              tc["ring_v"][0]),
                JK.overlay_kv(jc, jnp.asarray(lk), jnp.asarray(lv),
                              jc["ring_k"][0], jc["ring_v"][0])):
            same(got, want, "overlay_kv")
    # the ring is full now: a gated drain with no conflict but full is due;
    # first one with a fresh slot set on a ring that is not full
    for incoming in ([0, 0, 0], [4, 1, 5]):
        jd, jdue = JK.maybe_drain(dict(jc), incoming_slots=jnp.asarray(
            incoming, jnp.int32))
        td, tdue = ST.maybe_drain({n: x.clone() for n, x in tc.items()},
                                  incoming_slots=T(np.asarray(incoming)))
        assert bool(tdue) == bool(jdue)
        for n in jd:
            same(td[n], jd[n], f"maybe_drain {incoming}: {n}")
    # three entries (not full): due only on a conflict (lane 0 holds slot 2
    # at column 1)
    jc3 = dict(jc, ring_fill=jnp.asarray(3, jnp.int32))
    tc3 = {n: x.clone() for n, x in tc.items()}
    tc3["ring_fill"] = torch.tensor(3)
    for incoming in ([0, 0, 0], [2, 0, 0]):
        jd, jdue = JK.maybe_drain(dict(jc3), incoming_slots=jnp.asarray(
            incoming, jnp.int32))
        td, tdue = ST.maybe_drain({n: x.clone() for n, x in tc3.items()},
                                  incoming_slots=T(np.asarray(incoming)))
        assert bool(tdue) == bool(jdue) == (incoming == [2, 0, 0])
        for n in jd:
            same(td[n], jd[n], f"maybe_drain at 3 {incoming}: {n}")
    jd = JK.drain_ring(jc, use_kernel=False)
    td = ST.drain_ring(tc)
    for n in jd:
        same(td[n], jd[n], f"drain_ring: {n}")


# ---------------------------------------------------------------------------
# twins of tests/test_kvcache.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,s,steps", [
    ("qwen2-7b", 24, 8), ("h2o-danube-3-4b", 24, 8),
    # past the reduced window of 32: the cache ring wraps while staged
    ("h2o-danube-3-4b", 28, 12)])
def test_staged_ring_decode_equals_direct(arch, s, steps):
    """The twin of ``test_kvcache.py::test_staged_ring_decode_equals_
    direct``: decode with a ring of 4 and ``maybe_drain`` after each step
    gives the direct decode's logits (1e-4) and, drained, its cache
    (1e-5), in the port and in JAX, and the port's staged logits equal
    JAX's staged ones."""
    cfg, jmodel, jparams, tmodel = pair_model(arch)
    b = 2
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s + steps))
    pos = [np.full((b,), s + t, np.int32) for t in range(steps)]
    _, cd = tmodel.prefill(T(tokens[:, :s]).long(), 64)
    _, cs = tmodel.prefill(T(tokens[:, :s]).long(), 64)
    cs = ST.add_ring(cs, 4)
    _, jcs = jmodel.prefill(jparams, jnp.asarray(tokens[:, :s]), 64)
    jcs = JK.add_ring(jcs, 4)
    # one compiled JAX step (its eager one retraces the layer scan each call)
    jstep = jax.jit(jmodel.decode_step)
    jdrain = jax.jit(JK.maybe_drain)
    for t in range(steps):
        tok = T(tokens[:, s + t]).long()
        lg_d, cd = tmodel.decode_step(cd, tok, T(pos[t]).long())
        lg_s, cs = tmodel.decode_step(cs, tok, T(pos[t]).long())
        cs, _ = ST.maybe_drain(cs)
        jl, jcs = jstep(jparams, jcs, jnp.asarray(tokens[:, s + t]),
                        jnp.asarray(pos[t]))
        jcs, _ = jdrain(jcs)
        close(lg_s, jl, f"staged logits vs JAX at {t}")
        close(lg_s, lg_d, f"staged vs direct at {t}", atol=1e-4, rtol=1e-4)
    cs = ST.drain_ring(cs)
    close(cs["k"], cd["k"], "drained cache vs direct")
    close(cs["k"], JK.drain_ring(jcs, use_kernel=False)["k"], "vs JAX")


def test_adaptive_mixed_paths_match_the_full_forward():
    """The twin of ``test_kvcache.py::test_adaptive_mixed_paths_match_
    direct``: sequences 1 and 3 staged, 0 and 2 direct, drains when due;
    the last step's logits equal JAX's full forward at that position."""
    cfg, jmodel, jparams, tmodel = pair_model("stablelm-1.6b")
    b, s, steps = 4, 16, 6
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s + steps))
    full = np.asarray(jmodel.forward(jparams, jnp.asarray(tokens)))
    _, cs = tmodel.prefill(T(tokens[:, :s]).long(), 64)
    cs = ST.add_ring(cs, 4)
    mask = torch.tensor([False, True, False, True])
    for t in range(steps):
        lg, cs = tmodel.decode_step(cs, T(tokens[:, s + t]).long(),
                                    torch.full((b,), s + t),
                                    unload_mask=mask)
        cs, _ = ST.maybe_drain(cs)
    close(lg, full[:, s + steps - 1], "vs forward", atol=1e-4, rtol=1e-4)


def test_one_plane_drain_equals_the_per_sequence_drain():
    """The twin of ``test_kvcache.py::test_drain_with_kernel_matches_
    reference_drain``: four steps staged for two sequences, then the port's
    drain (every layer's K and V as ``[B * S, H * Dh]`` planes under one
    routing list) equals JAX's per-(layer, sequence) drain bit for bit."""
    cfg, jmodel, jparams, tmodel = pair_model("stablelm-1.6b")
    b, s = 2, 16
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, (b, s + 4))
    _, cs = tmodel.prefill(T(tokens[:, :s]).long(), 64)
    cs = ST.add_ring(cs, 4)
    _, jcs = jmodel.prefill(jparams, jnp.asarray(tokens[:, :s]), 64)
    jcs = JK.add_ring(jcs, 4)
    for t in range(4):
        pos = np.full((b,), s + t, np.int32)
        _, cs = tmodel.decode_step(cs, T(tokens[:, s + t]).long(),
                                   T(pos).long())
        _, jcs = jmodel.decode_step(jparams, jcs,
                                    jnp.asarray(tokens[:, s + t]),
                                    jnp.asarray(pos))
    close(cs["ring_k"], jcs["ring_k"], "staged tiles")
    # the port's drain on JAX's own staged cache: exact
    mine = ST.drain_ring({n: T(np.asarray(x)).clone() for n, x in jcs.items()})
    for n, x in JK.drain_ring(jcs, use_kernel=False).items():
        same(mine[n], x, n)


def test_strip_ring_removes_the_overlay():
    tmodel = build_model(get_config("stablelm-1.6b").reduced(), device="cpu")
    cache = tmodel.init_cache(2, 32)
    ringed = ST.add_ring(cache, 4)
    assert "ring_k" in ringed and TK.drain_ring is ST.drain_ring
    assert set(ST.strip_ring(ringed)) == set(cache)
    assert TK.drain_ring_paged is TK.paged.drain_ring


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

MAX_SEQ, PLEN, N_STEPS, B = 24, 12, 16, 2
ENGINE_ARMS = [(m, r, smp) for m in WRITE_MODES for r in (1, 4)
               for smp in (False, True)]
ENGINE_IDS = [f"{m}-ring{r}-{'sampled' if smp else 'greedy'}"
              for m, r, smp in ENGINE_ARMS]


@pytest.fixture(scope="module")
def engine_models():
    cfg, jmodel, jparams, tmodel = pair_model("stablelm-1.6b", 64)
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, (B, PLEN))
    return jmodel, jparams, tmodel, prompt


def _engines(engine_models, mode, ring, sampled):
    """A fresh JAX and port ``ServeEngine`` of one arm, and their keys."""
    jmodel, jparams, tmodel, _ = engine_models
    kw = dict(max_seq=MAX_SEQ, write_mode=mode, ring_size=ring, page_size=4,
              hot_threshold=3, greedy=not sampled)
    return (JaxServeEngine(jmodel, jparams, JaxServeConfig(**kw),
                           _internal=True),
            ServeEngine(tmodel, ServeConfig(**kw), _internal=True),
            jax.random.key(5) if sampled else None,
            prng.key(5) if sampled else None)


@pytest.mark.parametrize("arm", ENGINE_ARMS, ids=ENGINE_IDS)
def test_serve_engine_equals_jax(engine_models, arm):
    """``generate`` (prefill, then the one-loop ``decode``) on both
    packages: the same tokens and the same ``stats``; the port's
    ``decode_reference`` (the per-step loop with host reads) gives them
    too. Decoding 16 steps past a 12-token prompt with ``max_seq`` 24
    clamps the last slots, so the ring of 4 sees conflict-forced drains and
    the ring of 1 drains every step."""
    prompt = engine_models[3]
    mode, ring, sampled = arm
    jeng, teng, jkey, tkey = _engines(engine_models, *arm)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), N_STEPS,
                                    sample_key=jkey))
    toks = teng.generate(T(prompt), N_STEPS, sample_key=tkey)
    same(toks, want, f"{arm}")
    assert teng.stats == jeng.stats, (arm, teng.stats, jeng.stats)
    _, ref, _, tkey = _engines(engine_models, *arm)
    same(ref.generate(T(prompt), N_STEPS, sample_key=tkey, reference=True),
         want, f"{arm} decode_reference")
    assert ref.stats == teng.stats
    st = teng.stats
    assert st["direct_writes"] + st["staged_writes"] == B * (N_STEPS - 1)
    if mode == "staged":
        assert st["direct_writes"] == 0
    if mode != "direct" and ring == 1:
        assert st["drains"] == N_STEPS - 2
    if mode == "direct":
        assert st["drains"] == 0 and st["staged_writes"] == 0


@pytest.mark.parametrize("mode", ["adaptive"])
def test_serve_engine_reference_loop_equals_jax(engine_models, mode):
    """The per-step ``decode_reference`` on both packages: the same tokens
    and ``stats``. JAX's loop runs its steps eagerly (about 30 s an arm on
    the CPU), so one arm: adaptive (the monitor routes, the ring of 1
    drains every step), sampled; every other arm holds the port's
    ``decode_reference`` to JAX's ``decode``, which JAX's own tests hold
    to its ``decode_reference``."""
    prompt = engine_models[3]
    jeng, teng, jkey, tkey = _engines(engine_models, mode, 1, True)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), N_STEPS,
                                    sample_key=jkey, reference=True))
    same(teng.generate(T(prompt), N_STEPS, sample_key=tkey, reference=True),
         want, mode)
    assert teng.stats == jeng.stats, (mode, teng.stats, jeng.stats)


def test_serve_engine_guards():
    """Direct construction raises ``TypeError`` (built internally, as in
    JAX); an unknown write mode is refused; ``ServeConfig`` has JAX's fields
    but the drain-kernel switch (the device decides); ``make_decision``
    resolves each write mode's policy as JAX's does."""
    tmodel = build_model(get_config("stablelm-1.6b").reduced(), device="cpu")
    with pytest.raises(TypeError, match="Engine.from_config"):
        ServeEngine(tmodel, ServeConfig(max_seq=16))
    with pytest.raises(ValueError, match="write_mode"):
        ServeEngine(tmodel, ServeConfig(max_seq=16, write_mode="ring"),
                    _internal=True)
    import dataclasses
    assert {f.name for f in dataclasses.fields(JaxServeConfig)} - {
        f.name for f in dataclasses.fields(ServeConfig)} == {"drain_kernel"}
    from repro.serve import make_decision as jmake
    for mode in WRITE_MODES:
        mine, theirs = make_decision(mode, 8, 3), jmake(mode, 8, 3)
        assert type(mine.policy).__name__ == type(theirs.policy).__name__
        assert type(mine.monitor).__name__ == type(theirs.monitor).__name__


@pytest.mark.parametrize("mode", WRITE_MODES)
def test_paged_engine_equals_the_serve_engine(mode):
    """The twin of ``tests/test_serve_batched.py::test_batched_equals_
    sequential_and_per_request``'s second half: the port's paged engine
    (2 slots) serves 5 requests, and the port's ``ServeEngine`` over the
    dense lanes (one request at a time) gives each the same greedy tokens,
    in every write mode."""
    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg, device="cpu").init(0)
    n_req, plen, max_new = 5, 12, 10
    eng = BatchedServeEngine(model, BatchConfig(
        max_seq=32, n_slots=2, write_mode=mode, page_size=8, segment_len=4,
        ring_size=4, hot_threshold=3, device="cpu"), _internal=True)
    out = eng.serve(synthetic_requests(n_req, plen, cfg.vocab, max_new,
                                       seed=3))
    assert eng.layout == "paged"
    q = synthetic_requests(n_req, plen, cfg.vocab, max_new, seed=3)
    jq = jax_requests(n_req, plen, cfg.vocab, max_new, seed=3)
    for r in range(n_req):
        req = q.pop()
        same(req.prompt, jq.pop().prompt)
        ref = ServeEngine(model, ServeConfig(
            max_seq=64, write_mode=mode, ring_size=4, page_size=8,
            hot_threshold=3), _internal=True).generate(
                T(req.prompt)[None], max_new)
        same(out[r], ref[0].numpy(), f"{mode} request {r}")
    total = eng.stats["direct_writes"] + eng.stats["staged_writes"]
    assert total == n_req * (max_new - 1)
