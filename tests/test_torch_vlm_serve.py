"""The VLM engine against the JAX engine: llama-3.2-vision-90b reduced and
cut to 4 layers (two groups), the JAX package's weights with nonzero gates
drawn from a seed (carried across with ``params_from_numpy``), fp32 on the
CPU, 3 requests over 2 slots (admission AND retirement), each with its own
image embeddings (``synthetic_requests(..., media_shape=...)``, the same
values in both packages), on the lanes layout with direct writes: blocking
and chunked (chunks of 3 and 16, prompts of 8 and 5 tokens), greedy and
sampled (T 0.9, top-k 20, seed 3). The streams, ``stats`` and each
request's ``path_counts`` equal the JAX engine's; chunked equals blocking;
the chunked engine gives the media to every chunk. What the JAX engine
refuses for the VLM (the paged layout, the staged and adaptive paths, the
prefix cache, the host tier, spec with the VLM as target or draft, a media
list of the wrong length) the port refuses with the same error type; a
request without media fails on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import RequestQueue as JaxQueue
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import MemoryConfig as JaxMemory
from repro.serve import SpecConfig as JaxSpec
from repro.serve import build_model_and_params as jax_build
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import RequestQueue, synthetic_requests
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import DecoderLM, build_model, media_spec
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SpecConfig)

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
MAX_SEQ, PLENS, MAX_NEW = 32, [8, 5], 5
SHAPE = dict(max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
             path="direct", ring_size=2, hot_threshold=2)
SAMPLED = dict(temperature=0.9, top_k=20, seed=3)
# (chunk size or 0 for blocking, sampled)
ARMS = [(c, s) for c in (0, 3, 16) for s in (False, True)]
IDS = [f"{'chunk%d' % c if c else 'blocking'}-"
       f"{'sampled' if s else 'greedy'}" for c, s in ARMS]


def _cfg(get):
    return dataclasses.replace(get(ARCH).reduced(), n_layers=4)


IMAGE = media_spec(_cfg(get_config), 1)[1:]


def _models():
    """(JAX model, params with nonzero seeded gates; the port's model on
    the same weights)."""
    jmodel = jbuild(_cfg(jget))
    jparams = jmodel.init(jax.random.key(0), MAX_SEQ)
    rng = np.random.RandomState(9)
    cb = dict(jparams["cross_blocks"])
    for name in ("gate_attn", "gate_mlp"):
        cb[name] = jnp.asarray(rng.uniform(0.3, 1.2, cb[name].shape)
                               .astype(np.float32))
    jparams = dict(jparams, cross_blocks=cb)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(_cfg(get_config), device="cpu"))
    return jmodel, jparams, tmodel


def _queue(make, sampled, params_cls):
    sp = params_cls(max_tokens=MAX_NEW, **(SAMPLED if sampled else {}))
    return make(3, PLENS, 256, MAX_NEW, seed=7, media_shape=IMAGE,
                params=sp)


def _run(eng, make, sampled, params_cls):
    out = eng.serve(_queue(make, sampled, params_cls))
    comps = eng.completions()
    return ({r: np.asarray(t) for r, t in out.items()}, dict(eng.stats),
            {r: c.path_counts for r, c in comps.items()}, eng.layout)


def _counting(tmodel):
    """Count the model's ``chunk_prefill`` calls and those given media;
    returns the counter and the function that unwraps it."""
    calls = {"chunks": 0, "with_media": 0}

    def chunk_prefill(*a, _f=tmodel.chunk_prefill, **kw):
        calls["chunks"] += 1
        calls["with_media"] += kw.get("media") is not None
        return _f(*a, **kw)

    tmodel.chunk_prefill = chunk_prefill

    def unwrap():
        del tmodel.chunk_prefill
    return calls, unwrap


@pytest.fixture(scope="module")
def runs():
    """(port model, {arm: JAX run}, {arm: port run}, {arm: chunk counts})
    on the same weights."""
    jmodel, jparams, tmodel = _models()
    jax_runs, port_runs, counts = {}, {}, {}
    for chunk, sampled in ARMS:
        kw = dict(chunked=bool(chunk), chunk_size=chunk or 8)
        jeng = JaxEngine.from_config(JaxConfig(**kw, **SHAPE), jmodel,
                                     jparams)
        jax_runs[chunk, sampled] = _run(jeng, jax_requests, sampled,
                                        JaxParams)
        eng = Engine.from_config(EngineConfig(device="cpu", **kw, **SHAPE),
                                 tmodel)
        calls, unwrap = _counting(tmodel)
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
    assert type(tmodel) is DecoderLM and tmodel.is_vlm
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
    # the media go to every chunk (the gated cross layers read them each
    # time), and a prompt of 8 / 5 tokens takes ceil(plen / chunk) chunks
    c = counts[arm]
    assert c["with_media"] == c["chunks"], c
    if arm[0]:
        assert c["chunks"] >= sum(-(-p // arm[0]) for p in PLENS), c
    else:
        assert c["chunks"] == 0, c


@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("sampled", [False, True])
def test_chunked_equals_blocking(runs, chunk, sampled):
    """Chunk prefill at admission with the media on every chunk gives the
    blocking engine's streams."""
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
    """Each combination the JAX engine refuses for the VLM raises the same
    error type in the port: the paged layout, the staged and adaptive
    paths, the prefix cache, the host tier, and spec with the VLM as the
    target (lanes) or as the draft (a vlm draft cannot be rolled back)."""
    jmodel, jparams, tmodel = _models()
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
    # the VLM as the draft of a paged dense target
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


def test_a_request_without_media_fails_on_both_sides():
    """A VLM request without image embeddings cannot be served: the JAX
    engine fails inside its prefill (``AttributeError`` on the ``None``
    media), the port's prefill raises ``ValueError`` naming the shape the
    request needs."""
    jmodel, jparams, tmodel = _models()
    jeng = JaxEngine.from_config(JaxConfig(**SHAPE), jmodel, jparams)
    jq = JaxQueue()
    jq.submit(np.arange(5), MAX_NEW)
    with pytest.raises(AttributeError):
        jeng.serve(jq)
    for chunked in (False, True):
        eng = Engine.from_config(EngineConfig(device="cpu", chunked=chunked,
                                              chunk_size=3, **SHAPE), tmodel)
        q = RequestQueue()
        q.submit(np.arange(5), MAX_NEW)
        with pytest.raises(ValueError, match="takes media"):
            eng.serve(q)


def test_generate_with_media(runs):
    """``generate`` takes one media entry a prompt: the streams equal the
    queue path's, and a list of the wrong length raises JAX's
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
    jmodel, jparams, _ = _models()
    jeng = JaxEngine.from_config(JaxConfig(**SHAPE), jmodel, jparams)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="2 media entries for 3"):
            e.generate(prompts, media=media[:2])


def test_from_config_builds_the_vlm_on_lanes():
    """``EngineConfig(arch=...)`` builds the VLM ``DecoderLM`` itself and
    serves on lanes; the lanes cache holds every leaf of the model's own
    cache, the cross leaves ``n_image_tokens`` rows long, one a group."""
    eng = Engine.from_config(EngineConfig(arch=ARCH, max_seq=MAX_SEQ,
                                          n_slots=2, device="cpu"))
    assert type(eng.model) is DecoderLM and eng.model.is_vlm
    assert eng.layout == "lanes"
    cache = eng.scheduler.cache
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in
        eng.model.init_cache(2, MAX_SEQ).items()}
    assert cache["cross_k"].shape[:3] == (eng.model.n_groups, 2,
                                          get_config(ARCH).reduced()
                                          .n_image_tokens)


def test_launcher_serves_the_vlm_on_cpu(capsys):
    """``--arch llama-3.2-vision-90b`` serves through the CLI, batched (the
    synthetic embeddings) and plain (numpy embeddings), the write mode
    downgraded to direct with a message."""
    common = ["--arch", ARCH, "--device", "cpu", "--prompt-len", "6",
              "--gen-len", "4", "--max-seq", "16"]
    serve_main(common + ["--batched", "--requests", "3", "--slots", "2",
                         "--segment-len", "2", "--chunked", "--chunk-size",
                         "4", "--write-mode", "staged"])
    out = capsys.readouterr().out
    assert "downgrading --write-mode staged -> direct" in out
    assert "[lanes, chunked, reference, cpu] served 3 requests / 12 " \
           "tokens" in out
    serve_main(common + ["--batch", "2"])
    out = capsys.readouterr().out
    assert "generated 2 x 4 tokens" in out
