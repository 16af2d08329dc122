"""The SSM and hybrid engines against the JAX engine, and the twin of
``tests/test_config_matrix.py::test_batched_serve_smoke`` over the port's
nine archs.

Reduced mamba2-130m and zamba2-2.7b with the JAX package's weights (carried
across with ``params_from_numpy``), fp32 on the CPU, 3 requests over 2
slots (admission AND retirement) on the lanes layout with direct writes:
blocking and chunked (chunks of 3, prompts of 8 and 5 tokens), greedy and
sampled (T 0.9, top-k 20, seed 3). The streams, ``stats`` and each
request's ``path_counts`` equal the JAX engine's, and chunked equals
blocking. What the JAX engine refuses for these families (the paged
layout, the staged paths, the prefix cache, spec, a mesh) the port refuses
with the same error type.
"""
import os
import subprocess
import sys

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
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import synthetic_requests
from repro_torch.distributed import ParallelConfig
from repro_torch.models import (MambaLM, ZambaLM, build_model, media_spec,
                                needs_media)
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SpecConfig)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_NAMES = ("mamba2-130m", "zamba2-2.7b")
MAX_SEQ, PLENS, MAX_NEW = 32, [8, 5], 5
SHAPE = dict(max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
             path="direct", ring_size=2, hot_threshold=2, chunk_size=3)
SAMPLED = dict(temperature=0.9, top_k=20, seed=3)
ARMS = [(c, s) for c in (False, True) for s in (False, True)]


def _run(eng, make, sampled, params_cls):
    sp = params_cls(max_tokens=MAX_NEW, **(SAMPLED if sampled else {}))
    out = eng.serve(make(3, PLENS, 256, MAX_NEW, seed=7, params=sp))
    comps = eng.completions()
    return ({r: np.asarray(t) for r, t in out.items()}, dict(eng.stats),
            {r: c.path_counts for r, c in comps.items()}, eng.layout)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def runs(request):
    """(arch, port model, {arm: JAX run}, {arm: port run}) on the same
    weights; an arm is (chunked, sampled)."""
    arch = request.param
    _, jmodel, jparams = jax_build(arch, MAX_SEQ, seed=0)
    tmodel = params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        build_model(get_config(arch).reduced(), device="cpu"))
    jax_runs, port_runs = {}, {}
    for chunked, sampled in ARMS:
        jeng = JaxEngine.from_config(JaxConfig(chunked=chunked, **SHAPE),
                                     jmodel, jparams)
        jax_runs[chunked, sampled] = _run(jeng, jax_requests, sampled,
                                          JaxParams)
        eng = Engine.from_config(EngineConfig(chunked=chunked, device="cpu",
                                              **SHAPE), tmodel)
        port_runs[chunked, sampled] = _run(eng, synthetic_requests, sampled,
                                           SamplingParams)
    return arch, tmodel, jax_runs, port_runs


@pytest.mark.parametrize("arm", ARMS, ids=["blocking-greedy",
                                           "blocking-sampled",
                                           "chunked-greedy",
                                           "chunked-sampled"])
def test_engine_matches_jax(runs, arm):
    arch, tmodel, jax_runs, port_runs = runs
    jout, jstats, jpaths, jlayout = jax_runs[arm]
    out, stats, paths, layout = port_runs[arm]
    assert isinstance(tmodel, ZambaLM if arch == "zamba2-2.7b" else MambaLM)
    assert layout == jlayout == "lanes"
    assert sorted(out) == sorted(jout) == [0, 1, 2]
    for r in out:
        assert out[r].shape == (MAX_NEW,)
        np.testing.assert_array_equal(out[r], jout[r],
                                      err_msg=f"{arch} {arm} {r}")
        assert paths[r] == jpaths[r], (arch, r, paths[r], jpaths[r])
    for k in stats:
        assert stats[k] == jstats[k], (arch, k, stats, jstats)
    # 3 requests over 2 slots: the third admission needs a retirement
    assert stats["admitted"] == stats["retired"] == 3
    assert stats["direct_writes"] == 3 * (MAX_NEW - 1)
    assert stats["staged_writes"] == 0


@pytest.mark.parametrize("sampled", [False, True])
def test_chunked_equals_blocking(runs, sampled):
    """The twin of ``tests/test_config_matrix.py::
    test_chunked_prefill_bit_parity``: chunk prefill at admission carries
    the recurrent state (and the shared block's KV) chunk to chunk."""
    _, _, _, port_runs = runs
    for r in port_runs[False, sampled][0]:
        np.testing.assert_array_equal(port_runs[True, sampled][0][r],
                                      port_runs[False, sampled][0][r])


def _outcome(fn):
    try:
        fn()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        return type(e).__name__
    return "ok"


def _refusals():
    """(port, JAX) config pairs the JAX engine refuses for these families
    (None: the JAX engine is not asked)."""
    return {
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
        "mesh": (dict(parallel=ParallelConfig.tensor(2)), None),
    }


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_refuses_what_jax_refuses(arch):
    """Each combination the JAX engine refuses for the SSM / hybrid family
    raises the same error type in the port (the mesh: the port's
    ``ValueError``, as the JAX package's own validate gives it for a lanes
    layout)."""
    _, jmodel, jparams = jax_build(arch, MAX_SEQ, seed=0)
    tmodel = build_model(get_config(arch).reduced(), device="cpu")
    for what, (mine, theirs) in _refusals().items():
        got = _outcome(lambda: Engine.from_config(EngineConfig(
            max_seq=MAX_SEQ, device="cpu", **mine), tmodel))
        if theirs is None:
            assert got == "ValueError", what
            continue
        want = _outcome(lambda: JaxEngine.from_config(JaxConfig(
            max_seq=MAX_SEQ, **theirs), jmodel, jparams))
        assert want != "ok" and got == want, (what, got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batched_serve_smoke(arch):
    """The twin of ``tests/test_config_matrix.py::test_batched_serve_smoke``
    over every arch the port registers: the tiny variant serves 3 requests
    over 2 slots through the continuous-batching engine (admission AND
    retirement), dense non-SWA archs from the paged pool with adaptive
    routing, every other family from lanes with direct writes; whisper's
    requests carry their frames."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", max_seq=MAX_SEQ).init(0)
    media_shape = media_spec(cfg, 1)[1:] if needs_media(cfg) else None
    layout = ("paged" if cfg.family == "dense" and not cfg.sliding_window
              else "lanes")
    eng = Engine.from_config(EngineConfig(
        max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
        path="adaptive" if layout == "paged" else "direct",
        ring_size=2, hot_threshold=2, device="cpu"), model)
    assert eng.layout == layout
    out = eng.serve(synthetic_requests(3, 8, cfg.vocab, MAX_NEW, seed=7,
                                       media_shape=media_shape))
    assert set(out) == {0, 1, 2}
    for toks in out.values():
        assert toks.shape == (MAX_NEW,) and toks.dtype == np.int32
        assert (0 <= toks).all() and (toks < cfg.vocab).all()
    st = eng.stats
    assert st["admitted"] == 3 and st["retired"] == 3
    assert st["direct_writes"] + st["staged_writes"] == 3 * (MAX_NEW - 1)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_from_config_builds_the_family_on_lanes(arch):
    """``EngineConfig(arch=...)`` builds ``MambaLM`` / ``ZambaLM`` itself
    and serves on lanes; the lanes cache holds every leaf of the model's
    own cache."""
    eng = Engine.from_config(EngineConfig(arch=arch, max_seq=MAX_SEQ,
                                          n_slots=2, device="cpu"))
    want = ZambaLM if arch == "zamba2-2.7b" else MambaLM
    assert type(eng.model) is want and eng.layout == "lanes"
    cache = eng.scheduler.cache
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in
        eng.model.init_cache(2, MAX_SEQ).items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_serves_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id> --device cpu``
    serves the reduced model on lanes, downgrading the write path."""
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--device", "cpu", "--batched", "--requests", "3",
          "--slots", "2", "--prompt-len", "8", "--gen-len", "4",
          "--max-seq", "32", "--segment-len", "2"])
    out = capsys.readouterr().out
    assert "downgrading --write-mode adaptive -> direct" in out
    assert "[lanes, reference, cpu] served 3 requests / 12 tokens" in out


def test_models_default_to_the_card():
    """``build_model(cfg)``, ``MambaLM(cfg)`` and ``ZambaLM(cfg)`` with no
    device run on the card: without CUDA they raise and name
    ``device='cpu'``."""
    code = (
        "import pytest\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import MambaLM, ZambaLM, build_model\n"
        "for arch, cls in (('mamba2-130m', MambaLM), "
        "('zamba2-2.7b', ZambaLM)):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    for make in (build_model, cls):\n"
        "        with pytest.raises(RuntimeError, match=\"device='cpu'\"):\n"
        "            make(cfg)\n"
        "    assert type(build_model(cfg, device='cpu')) is cls\n"
        "print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("refused")
