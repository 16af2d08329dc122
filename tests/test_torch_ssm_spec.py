"""Speculative decoding with a recurrent (SSM) and an MoE draft against the
JAX spec engine: the twin of ``tests/test_spec_decode.py::
test_cross_arch_draft_rejection_falls_back_correctly`` and its MoE
counterpart.

The reduced stablelm-1.6b target (paged layout, the JAX package's weights),
k = 3, fp32 on the CPU; the draft is a reduced mamba2-130m (snapshot
rollback: one copy of its state a draft step, each slot taking back the one
at its committed count) or a reduced granite-moe-3b-a800m (positional: its
own lanes rewound by cursor, staged expert dispatch, so K1's plain version
drains in every draft step), either carrying the JAX engine's draft
weights. A random draft proposes junk, so nearly every round commits only
the target's own token and exercises the rollback. The streams equal the
non-speculative engine's and the JAX spec engine's, with every counter
(``spec_*`` among them) and each request's write counts.

The recurrent draft's rollback is held directly: after every spec segment
each live slot's draft state must be the state after its prompt and its
committed tokens but the last, within atol 1e-5 / rtol 1e-4 (fp32; the
prefill runs the SSD chunk-wise where the draft stepped token by token).
Greedy with a random draft commits one token a round; at temperature 1.0
the draft's near-uniform distribution is often accepted by rejection
sampling, so rounds commit 1 to k + 1 tokens and take back different
snapshots, and that stream must equal the JAX spec engine's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.paths import SpecConfig as JaxSpec
from repro.data import synthetic_requests as jax_requests
from repro.models import build_model as jbuild
from repro.models.sampling import SamplingParams as JaxParams
from repro.configs import get_config as jget
from repro.serve import BatchConfig as JaxBatchConfig
from repro.serve import BatchedServeEngine as JaxBatched
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.models import MambaLM, MoELM, build_model
from repro_torch.serve import (BatchConfig, BatchedServeEngine,
                               SamplingParams, SpecConfig)

torch.set_num_threads(1)

K = 3
KW = dict(n_slots=2, max_seq=48, segment_len=4, page_size=4)
DRAFTS = {"mamba2-130m": (MambaLM, False),
          "granite-moe-3b-a800m": (MoELM, True)}


TOL = dict(atol=1e-5, rtol=1e-4)


def _queue(make=synthetic_requests, params=None):
    return make(4, [9, 7, 12, 5], 256, 12, seed=3, params=params)


def _ssm_spec_engine(tmodel):
    return BatchedServeEngine(tmodel, BatchConfig(
        device="cpu", spec=SpecConfig(draft_arch="mamba2-130m", enabled=True,
                                      k=K), **KW), _internal=True)


@pytest.fixture(scope="module")
def target():
    """(JAX model, JAX params, the port's model on the same weights)."""
    jmodel = jbuild(jget("stablelm-1.6b").reduced())
    jparams = jmodel.init(jax.random.key(0), 64)
    tmodel = params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        build_model(get_config("stablelm-1.6b").reduced(), device="cpu"))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module", params=sorted(DRAFTS))
def served(request, target):
    """(draft arch, port engine, its streams, JAX engine, its streams,
    non-spec streams)."""
    draft = request.param
    jmodel, jparams, tmodel = target
    eng = BatchedServeEngine(tmodel, BatchConfig(
        device="cpu", spec=SpecConfig(draft_arch=draft, enabled=True, k=K),
        **KW), _internal=True)
    jeng = JaxBatched(jmodel, jparams, JaxBatchConfig(
        spec=JaxSpec(draft_arch=draft, enabled=True, k=K), **KW),
        _internal=True)
    params_from_numpy(jax.tree.map(np.asarray, jeng.draft_params),
                      eng.draft_model)
    base = BatchedServeEngine(tmodel, BatchConfig(device="cpu", **KW),
                              _internal=True).serve(_queue())
    return (draft, eng, eng.serve(_queue()), jeng,
            jeng.serve(_queue(jax_requests)), base)


def test_draft_family_and_rollback_kind(served):
    draft, eng, _, jeng, _, _ = served
    cls, positional = DRAFTS[draft]
    assert type(eng.draft_model) is cls
    assert eng._draft_positional is positional is jeng._draft_positional
    assert eng.draft_model.cfg.name == f"{draft}-smoke"
    assert {k: tuple(v.shape) for k, v in eng.draft_cache.items()} == {
        k: tuple(v.shape) for k, v in jeng.draft_cache.items()}
    assert "pages_k" in eng.cache


def test_spec_stream_equals_nonspec(served):
    _, eng, out, _, _, base = served
    assert set(out) == set(base)
    for r in out:
        np.testing.assert_array_equal(out[r], base[r], err_msg=str(r))
    st = eng.stats
    assert st["spec_committed"] == sum(len(v) for v in out.values()) - len(out)
    assert st["spec_proposed"] == K * st["spec_rounds"]
    # junk proposals: acceptance far below the proposals
    assert st["spec_accepted"] < st["spec_proposed"] // 4


def test_spec_engine_equals_jax(served):
    _, eng, out, jeng, jout, _ = served
    assert set(out) == set(jout)
    for r in out:
        np.testing.assert_array_equal(out[r], np.asarray(jout[r]),
                                      err_msg=str(r))
        assert tuple(int(x) for x in eng.req_writes[r]) == tuple(
            int(x) for x in np.asarray(jeng.req_writes[r]))
    for k in eng.stats:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)


def test_ssm_draft_resync_is_exact_length(target):
    """A stale recurrent draft lane is re-prefilled from the committed
    tokens at their exact length: its state equals a prefill of exactly
    those tokens (never padded to a bucket, which would fold the padding
    into the state)."""
    _, _, tmodel = target
    eng = _ssm_spec_engine(tmodel)
    q = _queue()
    eng.admit(q)
    eng._sync_draft()
    for s in range(KW["n_slots"]):
        rid = eng._slot_req[s]
        toks = torch.as_tensor(np.asarray(eng._requests[rid].prompt,
                                          np.int64))[None]
        _, lane = eng.draft_model.prefill(toks, KW["max_seq"])
        for name in lane:
            assert torch.equal(eng.draft_cache[name][:, s], lane[name][:, 0])


def _check_draft_states(eng):
    """Each live slot's draft lanes against a prefill of its prompt and its
    committed tokens but the last (``pos - plen`` of them); returns how many
    slots were checked."""
    pos, done = eng.slots.pos.cpu().numpy(), eng.done_flags()
    checked = 0
    for s in range(KW["n_slots"]):
        if not eng._occupied[s] or done[s] or eng._parked[s]:
            continue
        rid = eng._slot_req[s]
        prompt = np.asarray(eng._requests[rid].prompt, np.int64)
        toks = np.concatenate([prompt, np.asarray(
            eng.outputs[rid][:pos[s] - len(prompt)], np.int64)])
        _, lane = eng.draft_model.prefill(torch.as_tensor(toks)[None],
                                          KW["max_seq"])
        for name in lane:
            torch.testing.assert_close(
                eng.draft_cache[name][:, s], lane[name][:, 0], **TOL,
                msg=lambda m: f"slot {s} request {rid} {name}: {m}")
        checked += 1
    return checked


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_ssm_draft_rollback_keeps_the_committed_state(target, temperature):
    """After every spec segment each live slot's recurrent draft state is
    the one after its committed tokens but the last: the snapshot at its
    round's committed count, whatever that count was."""
    _, _, tmodel = target
    eng = _ssm_spec_engine(tmodel)
    q = _queue(params=SamplingParams(temperature=temperature, max_tokens=12,
                                     seed=3))
    checked = 0
    for _ in range(100):
        eng.retire_done()
        eng.admit(q)
        live = ~eng.done_flags() & np.asarray(eng._occupied)
        if not live.any():
            break
        eng.run_topped_up_segment(live)
        checked += _check_draft_states(eng)
    assert len(q) == 0 and eng.stats["retired"] == 4
    assert checked > 0
    if temperature:
        # rounds that committed more than one token took back later
        # snapshots than the greedy rounds do
        assert eng.stats["spec_accepted"] > 0, eng.stats


def test_sampled_ssm_draft_spec_equals_jax(target):
    """Rejection sampling reads the draft's probabilities, so the stream
    depends on the draft state each round starts from: at temperature 1.0
    (proposals accepted) the stream and every counter equal the JAX spec
    engine's."""
    jmodel, jparams, tmodel = target
    eng = _ssm_spec_engine(tmodel)
    jeng = JaxBatched(jmodel, jparams, JaxBatchConfig(
        spec=JaxSpec(draft_arch="mamba2-130m", enabled=True, k=K), **KW),
        _internal=True)
    params_from_numpy(jax.tree.map(np.asarray, jeng.draft_params),
                      eng.draft_model)
    out = eng.serve(_queue(params=SamplingParams(
        temperature=1.0, max_tokens=12, seed=3)))
    jout = jeng.serve(_queue(jax_requests, JaxParams(
        temperature=1.0, max_tokens=12, seed=3)))
    assert eng.stats["spec_accepted"] > 0, eng.stats
    assert set(out) == set(jout)
    for r in out:
        np.testing.assert_array_equal(out[r], np.asarray(jout[r]),
                                      err_msg=str(r))
    for k in eng.stats:
        assert eng.stats[k] == jeng.stats[k], (k, eng.stats, jeng.stats)
