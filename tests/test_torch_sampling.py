"""Sampled decoding in the port against the JAX package: the threefry key
chain, the sampler, and the twins of ``tests/test_sampling_params.py``.

The key chain (``repro_torch.models.prng``) gives ``jax.random``'s integers
bit for bit: ``key``, ``fold_in``, ``split`` and ``random_bits`` exactly, the
float32 uniforms exactly (they are a bit pattern). The Gumbel noise goes
through a float ``log``, where PyTorch's and XLA's may differ by an ulp:
it is held to 4 ulps (of the value, or of 1.0 near zero). The tokens are
compared exactly, on the sampler's test logits and in the engine. The engine twins run the reduced
stablelm-1.6b (paged) and h2o-danube-3-4b (lanes), fp32 on the CPU, with
the JAX package's weights carried across as numpy, and hold the port's
streams, engine stats and per-request write counts to the JAX engine's on
the same queue, blocking and chunked, direct / staged / adaptive."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.models import sampling as JS
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatchedEngine
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import RequestQueue, synthetic_requests
from repro_torch.models import build_model, prng
from repro_torch.models import sampling as TS
from repro_torch.models.sampling import SamplingParams, SlotParams
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.scheduler import BatchConfig, BatchedServeEngine

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 + 7, -5]
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "segments", "admitted", "retired")


def _mixed(sp):
    return [sp(max_tokens=8, temperature=0.0, seed=11),
            sp(max_tokens=8, temperature=1.3, seed=5, top_k=24, top_p=0.9),
            sp(max_tokens=6, temperature=0.7, seed=7)]


MIXED, JMIXED = _mixed(SamplingParams), _mixed(JS.SamplingParams)


def _jkd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# ---------------------------------------------------------------------------
# the key chain
# ---------------------------------------------------------------------------


def test_jax_splits_partitionably():
    """The port reproduces the partitionable split and bits layout, JAX's
    default since 0.5; this pins it without setting it."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_random123_known_answers(key, count, want):
    a, b = prng.threefry2x32(*key, *count)
    assert (int(a), int(b)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bits_equal_jax(seed):
    k = jax.random.key(seed)
    kd = prng.key(seed)
    np.testing.assert_array_equal(kd.numpy(), _jkd(k))
    for d in (0, 3, 77, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(kd, d).numpy(),
                                      _jkd(jax.random.fold_in(k, d)))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(kd, num).numpy(),
                                      _jkd(jax.random.split(k, num)))
    np.testing.assert_array_equal(
        prng.random_bits(kd, 4099).numpy(),
        np.asarray(jax.random.bits(k, (4099,))).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_exact_and_gumbel_within_four_ulps(seed):
    k = jax.random.key(seed)
    kd = prng.key(seed)
    tiny = np.finfo(np.float32).tiny
    for lo in (0.0, tiny):
        np.testing.assert_array_equal(
            prng.uniform(kd, 50000, minval=lo).numpy(),
            np.asarray(jax.random.uniform(k, (50000,), minval=lo)))
    want = np.asarray(jax.random.gumbel(k, (50000,)))
    got = prng.gumbel(kd, 50000).numpy()
    # ulps of the value, or of 1.0 near zero: there the inner log is about
    # -1 and its last-bit rounding (~2^-23) passes through the outer log
    unit = np.maximum(np.spacing(np.abs(want).astype(np.float32)), 2.0**-23)
    assert (np.abs(got - want) / unit).max() <= 4.0


def test_key_chain_over_steps_equals_jax():
    """8 slots' chains split once per step for 64 steps: every key equal."""
    kd = torch.stack([prng.key(s) for s in range(8)])
    jk = jax.vmap(jax.random.key)(jnp.arange(8))
    for _ in range(64):
        kd = prng.split(kd)[:, 1]
        jk = jax.vmap(jax.random.split)(jk)[:, 1]
    np.testing.assert_array_equal(kd.numpy(), _jkd(jk))


def test_derive_key_equals_jax():
    base = prng.key(9)
    jbase = jax.random.key(9)
    for rid, seed in ((0, None), (5, None), (3, 11), (7, 2**31 + 1)):
        np.testing.assert_array_equal(
            TS.derive_key(base, rid, seed).numpy(),
            _jkd(JS.derive_key(jbase, rid, seed)))


# ---------------------------------------------------------------------------
# the sampler on [S, V] logits
# ---------------------------------------------------------------------------

TEMP = np.array([0, 1, 0.7, 1.3, 0.5, 1, 2, 0.9], np.float32)
TOP_K = np.array([0, 0, 5, 24, 0, 1, 100, 0], np.int32)
TOP_P = np.array([1, 0.9, 1, 0.8, 0.5, 1, 0.95, 1e-6], np.float32)


def _slot_params(s=8):
    t = SlotParams(torch.tensor(TEMP[:s]), torch.tensor(TOP_K[:s]).long(),
                   torch.tensor(TOP_P[:s]),
                   torch.full((s, TS.MAX_STOP_TOKENS), -1))
    j = JS.SlotParams(jnp.asarray(TEMP[:s]), jnp.asarray(TOP_K[:s]),
                      jnp.asarray(TOP_P[:s]),
                      jnp.full((s, JS.MAX_STOP_TOKENS), -1, jnp.int32))
    return t, j


def _logits(trial, s=8, v=1000):
    return (np.random.RandomState(trial).randn(s, v) * 3).astype(np.float32)


def _keys(trial, s=8):
    return np.stack([_jkd(jax.random.key(trial * 10 + i)) for i in range(s)])


@pytest.mark.parametrize("trial", range(4))
def test_categorical_equals_jax(trial):
    logits, kd = _logits(trial), _keys(trial)
    want = jax.vmap(jax.random.categorical)(
        jax.random.wrap_key_data(jnp.asarray(kd, jnp.uint32)),
        jnp.asarray(logits))
    got = prng.categorical(torch.tensor(kd), torch.tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("trial", range(4))
def test_filter_logits_equals_jax(trial):
    scaled = _logits(trial) / np.where(TEMP > 0, TEMP, 1)[:, None]
    want = jax.vmap(JS._filter_logits)(jnp.asarray(scaled),
                                       jnp.asarray(TOP_K), jnp.asarray(TOP_P))
    got = TS.filter_logits(torch.tensor(scaled), torch.tensor(TOP_K).long(),
                           torch.tensor(TOP_P))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", TS.SAMPLE_MODES)
def test_sample_tokens_equals_jax(mode):
    tp, jp = _slot_params()
    for trial in range(6):
        logits, kd = _logits(trial), _keys(trial)
        jt, jk = JS.sample_tokens(jnp.asarray(logits),
                                  jnp.asarray(kd, jnp.uint32), jp, mode)
        tt, tk = TS.sample_tokens(torch.tensor(logits), torch.tensor(kd), tp,
                                  mode)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tk.numpy(),
                                      np.asarray(jk).astype(np.int64))


# ---------------------------------------------------------------------------
# the engine: twins of tests/test_sampling_params.py
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(arch="stablelm-1.6b", max_seq=64):
    """(JAX model, JAX params, port model with the same weights)."""
    if arch not in _MODELS:
        jmodel = jbuild(jget(arch).reduced())
        jparams = jmodel.init(jax.random.key(0), max_seq)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config(arch).reduced(), device="cpu"))
        _MODELS[arch] = (jmodel, jparams, tmodel)
    return _MODELS[arch]


def _shape(n_slots, kw):
    kw = dict(kw)
    kw.setdefault("max_seq", 40)
    kw.setdefault("segment_len", 4)
    kw.setdefault("page_size", 4)
    return dict(n_slots=n_slots, **kw)


def _engine(n_slots, arch="stablelm-1.6b", **kw):
    return BatchedServeEngine(_models(arch)[2], BatchConfig(
        device="cpu", **_shape(n_slots, kw)), _internal=True)


def _jax_engine(n_slots, arch="stablelm-1.6b", **kw):
    jmodel, jparams, _ = _models(arch)
    return JaxBatchedEngine(jmodel, jparams, JaxBatchConfig(
        **_shape(n_slots, kw)), _internal=True)


def _queue(params, make=synthetic_requests, plens=(12, 7, 9), n=3):
    return make(n, list(plens), 256, 8, seed=3, params=params)


def _same(a, b):
    assert set(a) == set(b)
    for r in a:
        np.testing.assert_array_equal(np.asarray(a[r]), np.asarray(b[r]))


def _twin(n_slots, params, jparams, arch="stablelm-1.6b", **kw):
    """Serve the same queue on the port and the JAX engine: streams, stats
    and per-request write counts must be equal. Returns the port's
    streams."""
    eng = _engine(n_slots, arch, **kw)
    jeng = _jax_engine(n_slots, arch, **kw)
    out = eng.serve(_queue(params))
    _same(out, jeng.serve(_queue(jparams, jax_requests)))
    for k in STATS:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
    assert set(eng.req_writes) == set(jeng.req_writes)
    for rid, w in eng.req_writes.items():
        np.testing.assert_array_equal(w, np.asarray(jeng.req_writes[rid]))
    return out


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_params_batch_equals_sequential(chunked):
    kw = dict(chunked=True, chunk_size=3) if chunked else {}
    out_b = _twin(2, MIXED, JMIXED, **kw)
    out_s = _twin(1, MIXED, JMIXED)
    _same(out_b, out_s)
    # explicit seeds: the same prompt + params alone (another request id)
    # reproduce the stream
    q = _queue(MIXED)
    for r in sorted(out_b):
        solo = RequestQueue()
        req = q.pop()
        solo.submit(req.prompt, params=req.params)
        np.testing.assert_array_equal(out_b[r], _engine(2).serve(solo)[0])


@pytest.mark.parametrize("mode", ["staged", "adaptive"])
def test_mixed_params_hold_across_write_paths(mode):
    out_b = _twin(2, MIXED, JMIXED, write_mode=mode, hot_threshold=3)
    out_s = _twin(1, MIXED, JMIXED, write_mode=mode, hot_threshold=3)
    _same(out_b, out_s)


def test_mixed_params_on_the_lanes_layout():
    arch = "h2o-danube-3-4b"
    _models(arch, 40)
    assert _engine(1, arch).layout == "lanes"
    out_b = _twin(2, MIXED, JMIXED, arch)
    _same(out_b, _twin(1, MIXED, JMIXED, arch))
    _same(_twin(2, MIXED, JMIXED, arch, chunked=True, chunk_size=3), out_b)


def test_temperature_zero_matches_legacy_greedy():
    p0 = SamplingParams(max_tokens=8, temperature=0.0)
    out_new = _twin(2, p0, JS.SamplingParams(max_tokens=8, temperature=0.0))
    _same(out_new, _twin(2, None, None, greedy=True))


def test_temperature_one_matches_legacy_sampled():
    p1 = SamplingParams(max_tokens=8, temperature=1.0)
    out_new = _twin(2, p1, JS.SamplingParams(max_tokens=8, temperature=1.0))
    _same(out_new, _twin(2, None, None, greedy=False))


def test_top_k_one_is_greedy():
    pk = dict(max_tokens=8, temperature=1.0, top_k=1, seed=2)
    out_k = _twin(2, SamplingParams(**pk), JS.SamplingParams(**pk))
    g = dict(max_tokens=8, temperature=0.0)
    _same(out_k, _twin(2, SamplingParams(**g), JS.SamplingParams(**g)))


def test_stop_token_ids_retire_like_eos():
    base = _twin(2, None, None)
    stop = int(base[0][3])
    out_p = _twin(2, SamplingParams(max_tokens=8, stop_token_ids=(stop,)),
                  JS.SamplingParams(max_tokens=8, stop_token_ids=(stop,)))
    _same(out_p, _twin(2, None, None, eos_id=stop))
    assert len(out_p[0]) <= 4 and out_p[0][-1] == stop


def test_per_request_max_tokens():
    out = _twin(2, [SamplingParams(max_tokens=n) for n in (3, 8, 5)],
                [JS.SamplingParams(max_tokens=n) for n in (3, 8, 5)])
    assert [len(out[r]) for r in sorted(out)] == [3, 8, 5]


def _api_pair(**kw):
    jmodel, jparams, tmodel = _models()
    shape = dict(max_seq=40, n_slots=2, segment_len=4, page_size=4, **kw)
    jkw = dict(shape)
    if "default_params" in kw:
        jkw["default_params"] = JS.SamplingParams(
            **vars(kw["default_params"]))
    return (Engine.from_config(EngineConfig(device="cpu", **shape), tmodel),
            JaxEngine.from_config(JaxEngineConfig(**jkw), jmodel, jparams))


def test_completions_carry_params_and_telemetry():
    eng, jeng = _api_pair(path="adaptive", hot_threshold=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=9) for _ in range(3)]
    comps = eng.generate(prompts, MIXED)
    jcomps = jeng.generate(prompts, JMIXED)
    assert [c.req_id for c in comps] == [0, 1, 2]
    for c, j, p in zip(comps, jcomps, MIXED):
        np.testing.assert_array_equal(c.tokens, j.tokens)
        assert c.path_counts == j.path_counts
        assert c.finish_reason == j.finish_reason
        assert c.params.temperature == p.temperature == j.params.temperature
        assert c.path_counts["direct"] + c.path_counts["staged"] \
            == c.n_tokens - 1
        assert c.path_counts["prefill"] == 9 and c.ttft_s >= 0.0
    acc = {}
    for ev in eng.stream(prompts, MIXED):
        acc.setdefault(ev.req_id, []).extend(ev.tokens.tolist())
        if ev.done:
            np.testing.assert_array_equal(
                np.asarray(acc[ev.req_id], np.int32), ev.completion.tokens)
    for c in comps:
        np.testing.assert_array_equal(
            np.asarray(acc[c.req_id], np.int32), c.tokens)


def test_sampler_filters_shape_the_distribution():
    """Disabled filters are ``categorical`` on the split schedule; top_k=2
    keeps only the two largest logits; a tiny top_p collapses to the
    argmax. Every draw equals JAX's."""
    logits = np.asarray(jax.random.normal(jax.random.key(1), (2, 64)))
    kd = np.stack([_jkd(jax.random.key(0)), _jkd(jax.random.key(9))])

    def params(top_k, top_p):
        t = SlotParams(torch.ones(2), torch.full((2,), top_k),
                       torch.full((2,), top_p), torch.full((2, 4), -1))
        j = JS.SlotParams(jnp.ones((2,)), jnp.full((2,), top_k, jnp.int32),
                          jnp.full((2,), top_p), jnp.full((2, 4), -1))
        return t, j

    tl = torch.tensor(logits)
    tp, _ = params(0, 1.0)
    toks, kd2 = TS.sample_tokens(tl, torch.tensor(kd), tp)
    pairs = prng.split(torch.tensor(kd))
    np.testing.assert_array_equal(
        toks.numpy(), prng.categorical(pairs[:, 0], tl).numpy())
    np.testing.assert_array_equal(kd2.numpy(), pairs[:, 1].numpy())
    tp2, jp2 = params(2, 1.0)
    allowed = np.argsort(logits, axis=-1)[:, -2:]
    kd_i, jkd_i = torch.tensor(kd), jnp.asarray(kd, jnp.uint32)
    for _ in range(20):
        t, kd_i = TS.sample_tokens(tl, kd_i, tp2)
        jt, jkd_i = JS.sample_tokens(jnp.asarray(logits), jkd_i, jp2)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        for row in range(2):
            assert int(t[row]) in allowed[row]
    tp3, _ = params(0, 1e-6)
    t3, _ = TS.sample_tokens(tl, torch.tensor(kd), tp3)
    np.testing.assert_array_equal(t3.numpy(), logits.argmax(axis=-1))


def test_engine_default_params_backfill():
    eng, jeng = _api_pair(
        default_params=SamplingParams(temperature=1.0, max_tokens=6))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=9) for _ in range(3)]
    comps = eng.generate(prompts, [
        None, SamplingParams(max_tokens=4),
        SamplingParams(max_tokens=4, temperature=0.0)])
    jcomps = jeng.generate(prompts, [
        None, JS.SamplingParams(max_tokens=4),
        JS.SamplingParams(max_tokens=4, temperature=0.0)])
    assert [c.params.temperature for c in comps] == [1.0, 1.0, 0.0]
    assert [c.n_tokens for c in comps] == [6, 4, 4]
    for c, j in zip(comps, jcomps):
        np.testing.assert_array_equal(c.tokens, j.tokens)


@pytest.mark.parametrize("bad", [
    dict(max_tokens=0), dict(temperature=-0.5), dict(top_p=0.0),
    dict(top_k=-1), dict(stop_token_ids=(1, 2, 3, 4))])
def test_sampling_params_validation(bad):
    with pytest.raises(ValueError):
        SamplingParams(**bad)
    with pytest.raises(ValueError):
        JS.SamplingParams(**bad)


@pytest.mark.parametrize("sample_seed", [0, 5])
def test_sample_seed_sets_the_key_chains(sample_seed):
    """``sample_seed`` is the base key every unseeded request's chain folds
    its id into: the port's streams follow JAX's for each base, and two
    bases give other streams."""
    p = dict(max_tokens=8, temperature=1.0)
    out = _twin(2, SamplingParams(**p), JS.SamplingParams(**p),
                sample_seed=sample_seed)
    other = _engine(2, sample_seed=sample_seed + 1).serve(
        _queue(SamplingParams(**p)))
    assert any(not np.array_equal(out[r], other[r]) for r in out)
