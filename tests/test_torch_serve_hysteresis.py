"""The paged engine serves with ``policy="hysteresis"`` on the adaptive path:
the same prompts through the JAX engine and its PyTorch port give identical
greedy token streams, write-path statistics and per-request path counts.
Reduced stablelm-1.6b at 4 layers, fp32, on the CPU; weights initialised by
the JAX package and carried across as numpy. More requests than slots, and
``ring_size < segment_len`` forces drains inside a segment."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams

torch.set_num_threads(1)

ARCH, MAX_SEQ, LAYERS = "stablelm-1.6b", 64, 4
SHAPE = dict(max_seq=MAX_SEQ, n_slots=3, segment_len=8, page_size=8,
             ring_size=4, path="adaptive", policy="hysteresis")
PLENS = [9, 16, 16, 5, 12, 16, 7]
MAX_NEW = [14, 20, 9, 1, 17, 20, 11]
STATS = ("direct_writes", "staged_writes", "drains", "prefill_writes",
         "admitted", "retired", "segments")


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n in PLENS]


@pytest.fixture(scope="module")
def runs():
    """(JAX completions and stats, port completions and stats) on the same
    4-layer weights."""
    cfg = dataclasses.replace(jax_config(ARCH).reduced(), n_layers=LAYERS)
    model = jax_model(cfg)
    params = model.init(jax.random.key(3), MAX_SEQ)
    jeng = JaxEngine.from_config(JaxConfig(**SHAPE), model, params)
    jcomps = jeng.generate(_prompts(),
                           [JaxParams(max_tokens=m) for m in MAX_NEW])
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=LAYERS)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, params),
                               build_model(tcfg, device="cpu"))
    teng = Engine.from_config(EngineConfig(device="cpu", **SHAPE), tmodel)
    tcomps = teng.generate(_prompts(),
                           [SamplingParams(max_tokens=m) for m in MAX_NEW])
    return (jcomps, dict(jeng.stats)), (tcomps, dict(teng.stats))


def test_hysteresis_engine_matches_jax(runs):
    (jcomps, jstats), (tcomps, tstats) = runs
    assert len(tcomps) == len(jcomps) == len(PLENS)
    for jc, tc in zip(jcomps, tcomps):
        assert tc.req_id == jc.req_id
        np.testing.assert_array_equal(tc.tokens, np.asarray(jc.tokens))
        assert tc.path_counts == jc.path_counts
        assert tc.finish_reason == jc.finish_reason
    for k in STATS:
        assert tstats[k] == jstats[k], (k, tstats, jstats)
    # both paths ran, and drains happened inside segments
    assert jstats["direct_writes"] > 0 and jstats["staged_writes"] > 0
    assert jstats["drains"] > 0
