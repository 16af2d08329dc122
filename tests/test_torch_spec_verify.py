"""Speculative decoding's pieces in the port against the JAX package:
``spec_verify`` (the accept / reject pass and the bonus sample), ``SpecStats``,
``SpecConfig`` and ``resolve_draft``.

``spec_verify`` runs on the same seeded logits, draft tokens and keys in both
packages, for the ``greedy``, ``sampled`` and ``filtered`` modes: the
commits, ``n_commit``, ``n_accepted`` and the new key data must be equal
value for value. The logits are draws from numpy; the draft's are the
target's plus noise, so rounds accept some of their proposals and reject
others. A temperature-0 slot rides in the sampling calls, and rows with a
zero residual (target and draft alike at the rejected column, where the
fallback samples from ``p`` itself) are held too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import paths as JP
from repro.core.types import SpecStats as JaxSpecStats
from repro.models import sampling as JS
from repro_torch.configs import get_config
from repro_torch.core import paths as TP
from repro_torch.core.types import SpecStats
from repro_torch.models import sampling as TS

torch.set_num_threads(1)

S, V = 6, 64
TEMP = [0.0, 0.8, 1.0, 1.3, 0.0, 0.7]
TOP_K = [0, 0, 10, 0, 0, 5]
TOP_P = [1.0, 1.0, 1.0, 0.9, 1.0, 0.8]


def _inputs(seed, k, mode):
    """Target logits [S, k+1, V], draft logits (target + noise), draft
    tokens (the draft's argmax on even slots, the target's on odd ones, one
    random token), key data and the slot parameters (no filters in the
    ``sampled`` mode, all temperatures 0 in ``greedy``)."""
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((S, k + 1, V)) * 3).astype(np.float32)
    d = (t[:, :k] + rng.standard_normal((S, k, V)) * 1.5).astype(np.float32)
    dt = np.where(np.arange(S)[:, None] % 2 == 0, d.argmax(-1),
                  t[:, :k].argmax(-1)).astype(np.int64)
    dt[rng.integers(S), rng.integers(k)] = rng.integers(V)
    keys = rng.integers(0, 2**32, (S, 2), dtype=np.uint64).astype(np.int64)
    temp = np.asarray(TEMP if mode != "greedy" else [0.0] * S, np.float32)
    top_k = np.asarray(TOP_K if mode == "filtered" else [0] * S, np.int64)
    top_p = np.asarray(TOP_P if mode == "filtered" else [1.0] * S,
                       np.float32)
    return t, d, dt, keys, temp, top_k, top_p


def _both(t, d, dt, keys, temp, top_k, top_p, mode):
    """(port's, JAX's) spec_verify outputs as int64 numpy arrays."""
    stop = np.full((S, TS.MAX_STOP_TOKENS), -1, np.int64)
    tp = TS.SlotParams(torch.as_tensor(temp), torch.as_tensor(top_k),
                       torch.as_tensor(top_p), torch.as_tensor(stop))
    got = TS.spec_verify(torch.as_tensor(t), torch.as_tensor(dt),
                         torch.as_tensor(d), torch.as_tensor(keys), tp,
                         mode=mode)
    jp = JS.SlotParams(temperature=jnp.asarray(temp),
                       top_k=jnp.asarray(top_k, jnp.int32),
                       top_p=jnp.asarray(top_p),
                       stop=jnp.asarray(stop, jnp.int32))
    want = JS.spec_verify(jnp.asarray(t), jnp.asarray(dt, jnp.int32),
                          jnp.asarray(d), jnp.asarray(keys, jnp.uint32), jp,
                          mode=mode)
    return ([x.numpy().astype(np.int64) for x in got],
            [np.asarray(x).astype(np.int64) for x in want])


def _held(got, want):
    names = ("commit", "n_commit", "n_accepted", "key data")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), (name, g, w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", ["greedy", "sampled", "filtered"])
def test_spec_verify_equals_jax(mode, k, seed):
    args = _inputs(seed, k, mode)
    got, want = _both(*args, mode=mode)
    _held(got, want)
    commit, n_commit, n_acc, key = got
    assert ((n_commit >= 1) & (n_commit <= k + 1)).all()
    assert np.array_equal(n_commit, n_acc + 1)
    dt = args[2]
    for s in range(S):        # the accepted run is the draft's own prefix
        assert np.array_equal(commit[s, :n_acc[s]], dt[s, :n_acc[s]])
    if mode == "greedy":      # greedy reads no key
        assert np.array_equal(key, args[3])
        assert np.array_equal(commit[np.arange(S), n_acc],
                              args[0].argmax(-1)[np.arange(S), n_acc])


@pytest.mark.parametrize("mode", ["sampled", "filtered"])
def test_spec_verify_temperature_zero_slot_is_greedy(mode):
    """Slots 0 and 4 sample at temperature 0 inside a sampling call: their
    accepts and fallbacks are the greedy mode's (the key still splits)."""
    args = _inputs(7, 4, mode)
    got, want = _both(*args, mode=mode)
    _held(got, want)
    greedy, _ = _both(*args[:4], np.zeros(S, np.float32), *args[5:],
                      mode="greedy")
    for s in (0, 4):
        assert np.array_equal(got[0][s], greedy[0][s])
        assert got[2][s] == greedy[2][s]
    assert not np.array_equal(got[3], args[3])


@pytest.mark.parametrize("mode,temp,top_k", [
    ("sampled", 1e-3, 0),     # p of every other token underflows to 0
    ("filtered", 1.0, 1),     # top-k 1: p and q keep the argmax alone
])
def test_spec_verify_zero_residual_falls_back_to_p(mode, temp, top_k):
    """Column 0's draft logits equal the target's and the draft token is
    not the argmax: p(d) = 0, so the token is rejected, and max(p - q, 0)
    is 0 everywhere, so the fallback samples from p, which puts all its
    mass on the argmax."""
    k = 3
    t, d, _, keys, _, _, _ = _inputs(11, k, mode)
    d[:, 0] = t[:, 0]
    top = t[:, 0].argmax(-1)
    dt = np.tile(((top + 1) % V)[:, None], (1, k)).astype(np.int64)
    temp_a = np.full((S,), temp, np.float32)
    top_k_a = np.full((S,), top_k, np.int64)
    top_p_a = np.ones((S,), np.float32)
    got, want = _both(t, d, dt, keys, temp_a, top_k_a, top_p_a, mode)
    _held(got, want)
    assert (got[2] == 0).all() and (got[1] == 1).all()
    assert np.array_equal(got[0][:, 0], top)


def test_spec_stats_zero_matches_jax():
    z, jz = SpecStats.zero(), JaxSpecStats.zero()
    assert SpecStats._fields == JaxSpecStats._fields
    assert all(int(a) == int(b) == 0 for a, b in zip(z, jz))
    assert all(x.dtype == torch.int64 and x.shape == () for x in z)


def test_spec_config_defaults_match_jax():
    t, j = TP.SpecConfig(), JP.SpecConfig()
    assert (t.draft_arch, t.k, t.enabled) == (j.draft_arch, j.k, j.enabled)
    assert TP._DRAFT_POSITIONAL == JP._DRAFT_POSITIONAL
    assert TP._DRAFT_SNAPSHOT == JP._DRAFT_SNAPSHOT


def _outcome(fn):
    try:
        cfg = fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return "ok", (cfg.name, cfg.n_layers, cfg.vocab, cfg.family)


@pytest.mark.parametrize("draft,target,reduced", [
    (None, "stablelm-1.6b", True),          # self-draft, reduced target
    (None, "stablelm-1.6b", False),         # self-draft, full target
    ("qwen2-7b", "stablelm-1.6b", True),    # cross-arch, both reduced
    ("qwen2-7b", "stablelm-1.6b", False),   # full vocabs differ
    ("nemotron-4-15b", "qwen2-7b", False),
    ("h2o-danube-3-4b", "h2o-danube-3-4b", False),
    (None, None, True),                     # target arch unknown
])
def test_resolve_draft_equals_jax(draft, target, reduced):
    """The vocab match picks the same candidate and the refusals carry the
    same text, for every ported draft."""
    spec = TP.SpecConfig(draft_arch=draft, enabled=True)
    jspec = JP.SpecConfig(draft_arch=draft, enabled=True)
    if target is None:
        vocab, name = 256, None
    else:
        tcfg = get_config(target)
        tcfg = tcfg.reduced() if reduced else tcfg
        vocab, name = tcfg.vocab, tcfg.name
    got = _outcome(lambda: TP.resolve_draft(spec, vocab=vocab,
                                            arch_name=name))
    want = _outcome(lambda: JP.resolve_draft(jspec, vocab=vocab,
                                             arch_name=name))
    assert got == want


@pytest.mark.parametrize("draft", ["mamba2-130m", "zamba2-2.7b",
                                   "granite-moe-3b-a800m"])
def test_unported_draft_archs_raise(draft):
    """The SSM, hybrid and MoE draft archs have the outcome of JAX's
    ``resolve_draft``: mamba2-130m (snapshot rollback) and
    granite-moe-3b-a800m (positional) resolve to the same config, zamba2-2.7b
    raises the same ``ValueError`` (it cannot be rolled back)."""
    spec = TP.SpecConfig(draft_arch=draft, enabled=True)
    jspec = JP.SpecConfig(draft_arch=draft, enabled=True)
    vocab = jget(draft).vocab
    got = _outcome(lambda: TP.resolve_draft(spec, vocab=vocab,
                                            arch_name="stablelm-1.6b"))
    want = _outcome(lambda: JP.resolve_draft(jspec, vocab=vocab,
                                             arch_name="stablelm-1.6b"))
    assert got == want
    if draft == "zamba2-2.7b":
        assert got[0] == "ValueError" and "cannot roll back" in got[1]
    else:
        assert got[0] == "ok"


def test_ssm_draft_family_raises_not_ported(monkeypatch):
    """An SSM-family draft config resolves (snapshot rollback), as in the
    JAX package; a hybrid one raises its ``ValueError``."""
    import dataclasses
    from repro_torch import configs as C
    ssm = dataclasses.replace(get_config("stablelm-1.6b"), family="ssm",
                              name="ssm-draft")
    monkeypatch.setitem(C.ARCHS, "ssm-draft", ssm)
    assert TP.resolve_draft(TP.SpecConfig(draft_arch="ssm-draft",
                                          enabled=True),
                            vocab=ssm.vocab) == ssm
    hybrid = dataclasses.replace(ssm, family="hybrid", name="hybrid-draft")
    monkeypatch.setitem(C.ARCHS, "hybrid-draft", hybrid)
    with pytest.raises(ValueError, match="cannot roll back"):
        TP.resolve_draft(TP.SpecConfig(draft_arch="hybrid-draft",
                                       enabled=True), vocab=ssm.vocab)
