"""The MoE engine against the JAX engine: the twin of
``tests/test_config_matrix.py``'s two tests for the MoE archs.

Reduced granite-moe-3b-a800m and qwen3-moe-235b-a22b with the JAX package's
weights (carried across with ``params_from_numpy``), fp32 on the CPU, 3
requests over 2 slots (admission AND retirement), on the lanes layout with
direct KV writes and staged expert dispatch (every MoE call drains through
K1's plain version here). Blocking and chunked (chunks of 3, prompts of 8
and 5 tokens): the greedy streams, ``stats`` and each request's
``path_counts`` equal the JAX engine's, and chunked equals blocking.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic_requests as jax_requests
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import build_model_and_params as jax_build
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.models import MoELM, build_model
from repro_torch.serve import Engine, EngineConfig

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
MAX_SEQ, PLENS, MAX_NEW = 32, [8, 5], 5
SHAPE = dict(max_seq=MAX_SEQ, n_slots=2, segment_len=2, page_size=4,
             path="direct", ring_size=2, hot_threshold=2, chunk_size=3)
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "admitted", "retired", "segments")


def _run(eng, make):
    out = eng.serve(make(3, PLENS, 256, MAX_NEW, seed=7))
    comps = eng.completions()
    return ({r: np.asarray(t) for r, t in out.items()}, dict(eng.stats),
            {r: c.path_counts for r, c in comps.items()}, eng.layout)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """(arch, {chunked: JAX run}, {chunked: port run}) on the same weights."""
    arch = request.param
    _, jmodel, jparams = jax_build(arch, MAX_SEQ, seed=0)
    tmodel = params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        build_model(get_config(arch).reduced(), device="cpu"))
    jax_runs, port_runs = {}, {}
    for chunked in (False, True):
        jeng = JaxEngine.from_config(JaxConfig(chunked=chunked, **SHAPE),
                                     jmodel, jparams)
        jax_runs[chunked] = _run(jeng, jax_requests)
        eng = Engine.from_config(EngineConfig(chunked=chunked, device="cpu",
                                              **SHAPE), tmodel)
        port_runs[chunked] = _run(eng, synthetic_requests)
    return arch, tmodel, jax_runs, port_runs


@pytest.mark.parametrize("chunked", [False, True])
def test_moe_engine_matches_jax(runs, chunked):
    arch, tmodel, jax_runs, port_runs = runs
    jout, jstats, jpaths, jlayout = jax_runs[chunked]
    out, stats, paths, layout = port_runs[chunked]
    assert isinstance(tmodel, MoELM) and tmodel.dispatch_mode == "staged"
    assert layout == jlayout == "lanes"
    assert sorted(out) == sorted(jout) == [0, 1, 2]
    for r in out:
        assert out[r].shape == (MAX_NEW,)
        np.testing.assert_array_equal(out[r], jout[r], err_msg=f"{arch} {r}")
        assert paths[r] == jpaths[r], (arch, r, paths[r], jpaths[r])
    for k in STATS:
        assert stats[k] == jstats[k], (arch, k, stats, jstats)
    # 3 requests over 2 slots: the third admission needs a retirement
    assert stats["admitted"] == stats["retired"] == 3
    assert stats["direct_writes"] == 3 * (MAX_NEW - 1)


def test_chunked_equals_blocking(runs):
    _, _, _, port_runs = runs
    for r in port_runs[False][0]:
        np.testing.assert_array_equal(port_runs[True][0][r],
                                      port_runs[False][0][r])


def test_auto_layout_is_lanes_from_the_arch_name():
    """``EngineConfig(arch=...)`` builds the MoE model itself and picks the
    lanes layout; the staged write paths are refused there."""
    eng = Engine.from_config(EngineConfig(arch="granite-moe-3b-a800m",
                                          max_seq=32, device="cpu"))
    assert eng.layout == "lanes" and isinstance(eng.model, MoELM)
    with pytest.raises(ValueError, match="direct-only"):
        Engine.from_config(EngineConfig(path="staged", max_seq=32,
                                        device="cpu"), eng.model)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <moe> --device cpu``
    serves the reduced MoE on lanes, downgrading the write path."""
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--device", "cpu", "--batched", "--requests", "3",
          "--slots", "2", "--prompt-len", "8", "--gen-len", "4",
          "--max-seq", "32", "--segment-len", "2"])
    out = capsys.readouterr().out
    assert "downgrading --write-mode adaptive -> direct" in out
    assert "[lanes, reference, cpu] served 3 requests / 12 tokens" in out
