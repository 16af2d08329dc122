"""The encoder-decoder engine against the JAX engine: reduced whisper-medium
with the JAX package's weights (carried across with ``params_from_numpy``),
fp32 on the CPU, 3 requests over 2 slots (admission AND retirement), each
with its own frames (``synthetic_requests(..., media_shape=...)``, the same
values in both packages), on the lanes layout with direct writes: blocking
and chunked (chunks of 3 and 16, prompts of 8 and 5 tokens), greedy and
sampled (T 0.9, top-k 20, seed 3). The streams, ``stats`` and each
request's ``path_counts`` equal the JAX engine's; chunked equals blocking;
the chunked engine runs the encoder once an admission group. What the JAX
engine refuses for whisper (the paged layout, the staged paths, the prefix
cache, the host tier, spec with whisper as target or draft, a media list of
the wrong length) the port refuses with the same error type.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic_requests as jax_requests
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import MemoryConfig as JaxMemory
from repro.serve import SpecConfig as JaxSpec
from repro.serve import build_model_and_params as jax_build
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import WhisperModel, build_model, media_spec
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SpecConfig)

torch.set_num_threads(1)

ARCH = "whisper-medium"
MAX_SEQ, PLENS, MAX_NEW = 32, [8, 5], 5
SHAPE = dict(max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
             path="direct", ring_size=2, hot_threshold=2)
SAMPLED = dict(temperature=0.9, top_k=20, seed=3)
# (chunk size or 0 for blocking, sampled)
ARMS = [(c, s) for c in (0, 3, 16) for s in (False, True)]
IDS = [f"{'chunk%d' % c if c else 'blocking'}-"
       f"{'sampled' if s else 'greedy'}" for c, s in ARMS]
FRAMES = media_spec(get_config(ARCH).reduced(), 1)[1:]


def _queue(make, sampled, params_cls):
    sp = params_cls(max_tokens=MAX_NEW, **(SAMPLED if sampled else {}))
    return make(3, PLENS, 256, MAX_NEW, seed=7, media_shape=FRAMES,
                params=sp)


def _run(eng, make, sampled, params_cls):
    out = eng.serve(_queue(make, sampled, params_cls))
    comps = eng.completions()
    return ({r: np.asarray(t) for r, t in out.items()}, dict(eng.stats),
            {r: c.path_counts for r, c in comps.items()}, eng.layout)


def _counting(tmodel, sch):
    """Count the model's ``encode`` calls and the engine's admission
    groups; returns the counter and the function that unwraps them."""
    calls = {"encode": 0, "groups": 0}

    def encode(*a, _f=tmodel.encode, **kw):
        calls["encode"] += 1
        return _f(*a, **kw)

    def admit_group(*a, _f=sch._admit_group, **kw):
        calls["groups"] += 1
        return _f(*a, **kw)

    tmodel.encode, sch._admit_group = encode, admit_group

    def unwrap():
        del tmodel.encode, sch._admit_group
    return calls, unwrap


@pytest.fixture(scope="module")
def runs():
    """(port model, {arm: JAX run}, {arm: port run}, {arm: encoder and
    admission-group counts}) on the same weights."""
    _, jmodel, jparams = jax_build(ARCH, MAX_SEQ, seed=0)
    tmodel = params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        build_model(get_config(ARCH).reduced(), device="cpu",
                    max_seq=MAX_SEQ))
    jax_runs, port_runs, counts = {}, {}, {}
    for chunk, sampled in ARMS:
        kw = dict(chunked=bool(chunk), chunk_size=chunk or 8)
        jeng = JaxEngine.from_config(JaxConfig(**kw, **SHAPE), jmodel,
                                     jparams)
        jax_runs[chunk, sampled] = _run(jeng, jax_requests, sampled,
                                        JaxParams)
        eng = Engine.from_config(EngineConfig(device="cpu", **kw, **SHAPE),
                                 tmodel)
        calls, unwrap = _counting(tmodel, eng.scheduler)
        try:
            port_runs[chunk, sampled] = _run(eng, synthetic_requests,
                                             sampled, SamplingParams)
        finally:
            unwrap()
        counts[chunk, sampled] = calls
    return tmodel, jax_runs, port_runs, counts


@pytest.mark.parametrize("arm", ARMS, ids=IDS)
def test_engine_matches_jax(runs, arm):
    tmodel, jax_runs, port_runs, counts = runs
    jout, jstats, jpaths, jlayout = jax_runs[arm]
    out, stats, paths, layout = port_runs[arm]
    assert isinstance(tmodel, WhisperModel)
    assert layout == jlayout == "lanes"
    assert sorted(out) == sorted(jout) == [0, 1, 2]
    for r in out:
        assert out[r].shape == (MAX_NEW,)
        np.testing.assert_array_equal(out[r], jout[r], err_msg=f"{arm} {r}")
        assert paths[r] == jpaths[r], (arm, r, paths[r], jpaths[r])
    for k in stats:
        assert stats[k] == jstats[k], (arm, k, stats, jstats)
    assert stats["admitted"] == stats["retired"] == 3
    assert stats["direct_writes"] == 3 * (MAX_NEW - 1)
    assert stats["staged_writes"] == 0
    # the encoder runs once an admission group, blocking and chunked
    c = counts[arm]
    assert c["encode"] == c["groups"] >= 2, c


@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("sampled", [False, True])
def test_chunked_equals_blocking(runs, chunk, sampled):
    """The twin of ``tests/test_config_matrix.py::
    test_chunked_prefill_bit_parity``: chunk prefill at admission with the
    media on the first chunk gives the blocking engine's streams."""
    _, _, port_runs, _ = runs
    for r in port_runs[0, sampled][0]:
        np.testing.assert_array_equal(port_runs[chunk, sampled][0][r],
                                      port_runs[0, sampled][0][r])


def _outcome(fn):
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return type(e).__name__
    return "ok"


def test_refuses_what_jax_refuses():
    """Each combination the JAX engine refuses for whisper raises the same
    error type in the port: the paged layout, the staged and adaptive
    paths, the prefix cache, the host tier, and spec with whisper as the
    target (lanes) or as the draft (an encoder-decoder draft cannot be
    rolled back)."""
    _, jmodel, jparams = jax_build(ARCH, MAX_SEQ, seed=0)
    tmodel = build_model(get_config(ARCH).reduced(), device="cpu",
                         max_seq=MAX_SEQ)
    cases = {
        "paged": (dict(kv_layout="paged"), dict(kv_layout="paged")),
        "staged": (dict(path="staged"), dict(path="staged")),
        "adaptive": (dict(path="adaptive"), dict(path="adaptive")),
        "prefix_cache": (dict(chunked=True,
                              memory=MemoryConfig(prefix_cache=True)),
                         dict(chunked=True,
                              memory=JaxMemory(prefix_cache=True))),
        "host_tier": (dict(memory=MemoryConfig(host_tier=True)),
                      dict(memory=JaxMemory(host_tier=True))),
        "spec": (dict(spec=SpecConfig(enabled=True, k=3)),
                 dict(spec=JaxSpec(enabled=True, k=3))),
    }
    for what, (mine, theirs) in cases.items():
        got = _outcome(lambda: Engine.from_config(EngineConfig(
            max_seq=MAX_SEQ, device="cpu", **mine), tmodel))
        want = _outcome(lambda: JaxEngine.from_config(JaxConfig(
            max_seq=MAX_SEQ, **theirs), jmodel, jparams))
        assert want != "ok" and got == want, (what, got, want)
    # whisper as the draft of a paged dense target (the same vocabulary)
    _, jtarget, jtparams = jax_build("stablelm-1.6b", MAX_SEQ, seed=0)
    ttarget = build_model(get_config("stablelm-1.6b").reduced(),
                          device="cpu")
    got = _outcome(lambda: Engine.from_config(EngineConfig(
        max_seq=MAX_SEQ, device="cpu",
        spec=SpecConfig(enabled=True, k=3, draft_arch=ARCH)), ttarget))
    want = _outcome(lambda: JaxEngine.from_config(JaxConfig(
        max_seq=MAX_SEQ, spec=JaxSpec(enabled=True, k=3, draft_arch=ARCH)),
        jtarget, jtparams))
    assert want == got == "ValueError", (got, want)


def test_generate_with_media(runs):
    """``generate`` / ``stream`` take one media entry a prompt: the streams
    equal the queue path's, and a list of the wrong length raises JAX's
    ``ValueError``."""
    tmodel, _, port_runs, _ = runs
    q = _queue(synthetic_requests, False, SamplingParams)
    prompts, media = [], []
    while len(q):
        r = q.pop_at(0)
        prompts.append(r.prompt)
        media.append(r.media)
    eng = Engine.from_config(EngineConfig(device="cpu", **SHAPE), tmodel)
    comps = eng.generate(prompts, SamplingParams(max_tokens=MAX_NEW),
                         media=media)
    for c in comps:
        np.testing.assert_array_equal(c.tokens, port_runs[0, False][0][
            c.req_id])
    _, jmodel, jparams = jax_build(ARCH, MAX_SEQ, seed=0)
    jeng = JaxEngine.from_config(JaxConfig(**SHAPE), jmodel, jparams)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="2 media entries for 3"):
            e.generate(prompts, media=media[:2])


def test_from_config_builds_whisper_on_lanes():
    """``EngineConfig(arch=...)`` builds ``WhisperModel`` itself (the
    learned positions sized for ``max_seq``) and serves on lanes; the lanes
    cache holds every leaf of the model's own cache, the cross leaves
    ``n_audio_frames`` rows long."""
    eng = Engine.from_config(EngineConfig(arch=ARCH, max_seq=MAX_SEQ,
                                          n_slots=2, device="cpu"))
    assert type(eng.model) is WhisperModel and eng.layout == "lanes"
    cache = eng.scheduler.cache
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in
        eng.model.init_cache(2, MAX_SEQ).items()}
    assert cache["cross_k"].shape[2] == FRAMES[0]
    assert cache["k"].shape[2] == MAX_SEQ


def test_launcher_serves_whisper_on_cpu(capsys):
    """``--arch whisper-medium`` serves through the CLI, batched (the
    synthetic frames) and plain (numpy frames), the write mode downgraded
    to direct with a message."""
    common = ["--arch", ARCH, "--device", "cpu", "--prompt-len", "6",
              "--gen-len", "4", "--max-seq", "16"]
    serve_main(common + ["--batched", "--requests", "3", "--slots", "2",
                         "--segment-len", "2", "--chunked", "--chunk-size",
                         "4"])
    out = capsys.readouterr().out
    assert "downgrading --write-mode adaptive -> direct" in out
    assert "[lanes, chunked, reference, cpu] served 3 requests / 12 " \
           "tokens" in out
    serve_main(common + ["--batch", "2"])
    out = capsys.readouterr().out
    assert "generated 2 x 4 tokens" in out
