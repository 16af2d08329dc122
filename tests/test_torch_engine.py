"""The slice as a whole: the same prompts through the JAX engine and its
PyTorch port give identical greedy token streams, identical write-path
statistics and identical per-request path counts, for the direct, staged and
adaptive write paths. Reduced stablelm-1.6b in fp32 on the CPU, and the
reduced qwen2-7b (4 query heads to 1 KV head, qkv bias); weights are initialised by the
JAX package and carried across as numpy. More requests
than slots, so admission, retirement and block reuse are crossed, and
``ring_size < segment_len`` forces drains inside a segment."""
import jax
import numpy as np
import pytest
import torch

from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import build_model_and_params as jax_build
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams

torch.set_num_threads(1)

ARCH, MAX_SEQ = "stablelm-1.6b", 64
SHAPE = dict(max_seq=MAX_SEQ, n_slots=3, segment_len=8, page_size=8,
             ring_size=4)
PLENS = [9, 16, 16, 5, 12, 16, 7]   # 7 requests > 3 slots
MAX_NEW = [14, 20, 9, 1, 17, 20, 11]
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "admitted", "retired", "segments")
PATHS = ("direct", "staged", "adaptive")


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n in PLENS]


@pytest.fixture(scope="module")
def jax_side():
    return _jax_runs(ARCH)


def _jax_runs(arch):
    """(numpy params, {path: (completions, stats)}) from the JAX engine."""
    _, model, params = jax_build(arch, MAX_SEQ, seed=3)
    runs = {}
    for path in PATHS:
        eng = JaxEngine.from_config(JaxConfig(path=path, **SHAPE), model,
                                    params)
        comps = eng.generate(_prompts(),
                             [JaxParams(max_tokens=m) for m in MAX_NEW])
        runs[path] = (comps, dict(eng.stats))
    return jax.tree.map(np.asarray, params), runs


@pytest.fixture(scope="module")
def jax_qwen():
    return _jax_runs("qwen2-7b")


@pytest.fixture(scope="module")
def torch_model(jax_side):
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    return params_from_numpy(jax_side[0], model)


def _torch_run(model, path, attention="auto"):
    eng = Engine.from_config(EngineConfig(
        path=path, attention=attention, device="cpu", **SHAPE), model)
    comps = eng.generate(_prompts(),
                         [SamplingParams(max_tokens=m) for m in MAX_NEW])
    return comps, dict(eng.stats)


def _assert_matches(jax_run, torch_run):
    (jcomps, jstats), (tcomps, tstats) = jax_run, torch_run
    assert len(tcomps) == len(jcomps) == len(PLENS)
    for jc, tc in zip(jcomps, tcomps):
        assert tc.req_id == jc.req_id
        np.testing.assert_array_equal(tc.tokens, np.asarray(jc.tokens))
        assert tc.path_counts == jc.path_counts
        assert tc.finish_reason == jc.finish_reason
    for k in STATS:
        assert tstats[k] == jstats[k], (k, tstats, jstats)


@pytest.mark.parametrize("path", PATHS)
def test_engine_matches_jax(jax_side, torch_model, path):
    _assert_matches(jax_side[1][path], _torch_run(torch_model, path))


@pytest.mark.parametrize("path", PATHS)
def test_gqa_engine_matches_jax(jax_qwen, path):
    """qwen2-7b's engine (GQA, qkv bias) on the paged layout, blocking."""
    model = params_from_numpy(jax_qwen[0], build_model(
        get_config("qwen2-7b").reduced(), device="cpu"))
    assert (model.cfg.n_heads, model.cfg.n_kv_heads) == (4, 1)
    _assert_matches(jax_qwen[1][path], _torch_run(model, path))


def test_drains_happen_inside_segments(jax_side):
    """ring_size < segment_len: more drains than segment boundaries could
    explain are counted (only in-segment drains are counted at all)."""
    for path in ("staged", "adaptive"):
        stats = jax_side[1][path][1]
        assert stats["drains"] > 0 and stats["staged_writes"] > 0


@pytest.mark.parametrize("path", PATHS)
def test_fused_matches_reference_streams(torch_model, path):
    """attention="fused" (on the CPU: the kernel's plain version) gives the
    same greedy streams and telemetry as the gather+concat reference."""
    ref_c, ref_s = _torch_run(torch_model, path, "reference")
    fus_c, fus_s = _torch_run(torch_model, path, "fused")
    for a, b in zip(ref_c, fus_c):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.path_counts == b.path_counts
    assert ref_s == fus_s


def test_paths_agree_with_each_other(torch_model):
    runs = [_torch_run(torch_model, p)[0] for p in PATHS]
    for comps in runs[1:]:
        for a, b in zip(runs[0], comps):
            np.testing.assert_array_equal(a.tokens, b.tokens)


def test_stop_token_retires_and_reports(torch_model):
    """An eos hit ends a request early with finish_reason "stop"."""
    base, _ = _torch_run(torch_model, "adaptive")
    eos = int(base[1].tokens[4])
    eng = Engine.from_config(EngineConfig(
        path="adaptive", device="cpu", eos_id=eos, **SHAPE), torch_model)
    comps = eng.generate(_prompts(),
                         [SamplingParams(max_tokens=m) for m in MAX_NEW])
    c = comps[1]
    assert c.finish_reason == "stop" and int(c.tokens[-1]) == eos
    assert c.n_tokens <= 5
    np.testing.assert_array_equal(c.tokens, base[1].tokens[:c.n_tokens])


def test_serve_queue_and_reset(torch_model):
    from repro_torch.data import synthetic_requests

    eng = Engine.from_config(EngineConfig(
        path="staged", device="cpu", **SHAPE), torch_model)
    q = synthetic_requests(5, [8, 12], 256, 10)
    out1 = eng.serve(q)
    assert sorted(out1) == list(range(5))
    assert all(len(t) == 10 for t in out1.values())
    eng.reset()
    out2 = eng.serve(synthetic_requests(5, [8, 12], 256, 10))
    for rid in out1:
        np.testing.assert_array_equal(out1[rid], out2[rid])
    eng.scheduler.pool.audit()
    assert eng.scheduler.pool.n_free == eng.scheduler.n_blocks
