"""The MoE family of the port against the JAX package (reduced
granite-moe-3b-a800m: 8 experts top-2, GQA group 4, fp32 on the CPU).

The same weights (initialised by the JAX package, carried across with
``params_from_numpy``) and the same numpy inputs through both:

* ``route`` (expert indices equal, weights and aux within 1e-6, loads
  equal), with exact ties in the router's probabilities (the lower expert
  first, as ``jax.lax.top_k``);
* ``dispatch_direct`` / ``dispatch_staged`` (buffers, permutation and slots
  equal; the staged drain is K1's plain version here), ``combine_direct``;
* ``moe_ffn_layer`` in all three modes within atol 1e-5, also where the
  capacity drops assignments (the twin of ``tests/test_moe.py::
  test_capacity_drops_are_counted_not_crashed``);
* ``expert_hot_mask``;
* ``MoELM.forward_with_stats`` / ``prefill`` / ``chunk_prefill`` /
  ``decode_step`` (atol 1e-5), and the three dispatch modes agreeing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.decision import expert_hot_mask as jax_hot_mask
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.decision import expert_hot_mask
from repro_torch.models import MoELM, build_model
from repro_torch.models import moe as TM

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
TOL = dict(atol=1e-5, rtol=1e-5)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def pair():
    jcfg = jget(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(3), 64)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config(ARCH).reduced(),
                                           device="cpu"))
    return jcfg, jmodel, jparams, tmodel


def _layer(pair, i=0):
    """(JAX params of layer i's MoE, the port's MoEMLP of layer i)."""
    jcfg, _, jparams, tmodel = pair
    p = {k: v[i] for k, v in jparams["blocks"]["moe"].items()}
    return p, tmodel.blocks[i].moe


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_reduced_config_and_model(pair):
    jcfg, jmodel, _, tmodel = pair
    cfg = tmodel.cfg
    assert isinstance(tmodel, MoELM) and tmodel.dispatch_mode == "staged"
    assert jmodel.dispatch_mode == "staged"
    for f in ("n_experts", "top_k", "expert_d_ff", "n_heads", "n_kv_heads",
              "capacity_factor", "router_aux_coef"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELM(cfg, device="cpu", dispatch_mode="scatter")


@pytest.mark.parametrize("n_tokens", [1, 7, 64])
def test_route_matches_jax(pair, n_tokens):
    jcfg, _, _, tmodel = pair
    p, moe = _layer(pair)
    x = _x(n_tokens, n_tokens, jcfg.d_model)
    ji, jw, ja, jl = JM.route(jcfg, p, jnp.asarray(x))
    ti, tw, ta, tl = TM.route(tmodel.cfg, moe.tensors()["router"], T(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_route_ties_take_the_lower_expert(pair):
    """A zero router gives every expert the same probability: the top-k
    must be experts 0..k-1 in order, as ``jax.lax.top_k`` gives them."""
    jcfg, _, _, tmodel = pair
    p, _ = _layer(pair)
    zero = np.zeros_like(np.asarray(p["router"]))
    x = _x(1, 5, jcfg.d_model)
    ji, jw, _, _ = JM.route(jcfg, dict(p, router=jnp.asarray(zero)),
                            jnp.asarray(x))
    ti, tw, _, _ = TM.route(tmodel.cfg, T(zero), T(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == np.arange(jcfg.top_k)).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


@pytest.mark.parametrize("n_tokens,cap_factor", [(12, 1.25), (64, 0.25)])
def test_dispatch_and_combine_match_jax(pair, n_tokens, cap_factor):
    """Random assignments with a keep mask; at capacity factor 0.25 the
    per-expert capacity (8) drops assignments on both paths."""
    jcfg = dataclasses.replace(pair[0], capacity_factor=cap_factor)
    rng = np.random.RandomState(n_tokens)
    e, k, d = jcfg.n_experts, jcfg.top_k, jcfg.d_model
    x = rng.randn(n_tokens, d).astype(np.float32)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(n_tokens)])
    keep = rng.rand(n_tokens, k) < 0.8
    cap = JM.expert_capacity(jcfg, n_tokens)
    assert cap == TM.expert_capacity(jcfg, n_tokens)
    jb, js = JM.dispatch_direct(jnp.asarray(x), jnp.asarray(idx),
                                jnp.asarray(keep), cap, e)
    tb, ts = TM.dispatch_direct(T(x), T(idx), T(keep), cap, e)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jb2, jp, js2 = JM.dispatch_staged(jnp.asarray(x), jnp.asarray(idx),
                                      jnp.asarray(keep), cap, e)
    tb2, tp, ts2 = TM.dispatch_staged(T(x), T(idx), T(keep), cap, e)
    np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb2))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    if cap_factor < 1:
        assert (ts2.numpy() == -1).sum() > (~keep).sum()   # drops happened
    out = rng.randn(e, cap, d).astype(np.float32)
    w = rng.rand(n_tokens, k).astype(np.float32)
    np.testing.assert_allclose(
        TM.combine_direct(T(out), T(idx), ts2, T(w)).numpy(),
        np.asarray(JM.combine_direct(jnp.asarray(out), jnp.asarray(idx),
                                     js2, jnp.asarray(w))), atol=1e-6)


@pytest.mark.parametrize("mode", ["direct", "staged", "adaptive"])
@pytest.mark.parametrize("cap_factor", [1.25, 0.25])
def test_moe_ffn_layer_matches_jax(pair, mode, cap_factor):
    """All three modes, with capacity to spare and with drops (the twin of
    ``test_capacity_drops_are_counted_not_crashed``: finite and equal)."""
    jcfg = dataclasses.replace(pair[0], capacity_factor=cap_factor)
    tcfg = dataclasses.replace(pair[3].cfg, capacity_factor=cap_factor)
    p, moe = _layer(pair, 1)
    x = _x(5, 2, 64, jcfg.d_model)
    hot = np.zeros((jcfg.n_experts,), bool)
    hot[[1, 4, 6]] = True
    jh = jnp.asarray(hot) if mode == "adaptive" else None
    th = T(hot) if mode == "adaptive" else None
    jy, ja, jl = JM.moe_ffn_layer(jcfg, p, jnp.asarray(x), mode, jh)
    ty, ta, tl = TM.moe_ffn_layer(tcfg, moe, T(x), mode, th)
    assert torch.isfinite(ty).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_adaptive_needs_a_hot_mask_and_modes_are_checked(pair):
    _, moe = _layer(pair)
    x = T(_x(0, 1, 4, pair[0].d_model))
    with pytest.raises(ValueError, match="hot_mask"):
        TM.moe_ffn_layer(pair[3].cfg, moe, x, "adaptive")
    with pytest.raises(ValueError, match="not in"):
        TM.moe_ffn_layer(pair[3].cfg, moe, x, "scatter")


@pytest.mark.parametrize("k", [0, 3, 8])
def test_expert_hot_mask_matches_jax_with_ties(k):
    load = np.array([5, 9, 5, 0, 9, 5, 1, 9], np.int32)   # ties on 9 and 5
    np.testing.assert_array_equal(
        expert_hot_mask(T(load).long(), k).numpy(),
        np.asarray(jax_hot_mask(jnp.asarray(load), k)))


def test_forward_with_stats_matches_jax(pair):
    jcfg, jmodel, jparams, tmodel = pair
    tokens = np.random.RandomState(2).randint(0, jcfg.vocab, (2, 24))
    jl, ja, jload = jmodel.forward_with_stats(jparams,
                                              jnp.asarray(tokens, jnp.int32))
    tl, ta, tload = tmodel.forward_with_stats(T(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    np.testing.assert_array_equal(tmodel.forward(T(tokens)).numpy(),
                                  tl.numpy())


def test_prefill_chunks_and_decode_match_jax(pair):
    """prefill; chunk_prefill over the same prompt in chunks of 5 (from a
    fresh cache); 12 decode steps from the prefill's cache. The chunk and
    decode calls route their own token counts, as JAX's do."""
    jcfg, jmodel, jparams, tmodel = pair
    b, plen, max_seq = 2, 17, 40
    tokens = np.random.RandomState(4).randint(0, jcfg.vocab, (b, plen))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32), max_seq)
    tl, tc = tmodel.prefill(T(tokens), max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    jcc = jmodel.init_cache(b, max_seq)
    tcc = tmodel.init_cache(b, max_seq)
    for s0 in range(0, plen, 5):
        chunk = tokens[:, s0:s0 + 5]
        jcl, jcc = jmodel.chunk_prefill(jparams, jcc,
                                        jnp.asarray(chunk, jnp.int32), s0)
        tcl, tcc = tmodel.chunk_prefill(tcc, T(chunk), s0)
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), **TOL)
    np.testing.assert_allclose(tcc["k"].numpy(), np.asarray(jcc["k"]), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda c, t, p: jmodel.decode_step(jparams, c, t, p))
    for step in range(12):
        pos = np.full((b,), plen + step, np.int32)
        jl, jc = jstep(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tc, T(tok).long(), T(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


def test_dispatch_modes_agree_and_paged_steps_refuse(pair):
    """The JAX package's ``test_moe_lm_dispatch_modes_agree`` on the port:
    direct, staged and adaptive logits agree (no drops at this size); the
    paged steps are refused (MoE serves from lanes)."""
    cfg, tmodel = pair[3].cfg, pair[3]
    tokens = T(np.random.RandomState(1).randint(0, cfg.vocab, (2, 16)))
    got = {}
    for mode in ("direct", "staged", "adaptive"):
        m = build_model(cfg, device="cpu", dispatch_mode=mode)
        m.load_state_dict(tmodel.state_dict())
        m.hot_mask = torch.arange(cfg.n_experts) % 2 == 0
        got[mode] = m.forward(tokens)
    torch.testing.assert_close(got["direct"], got["staged"], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got["direct"], got["adaptive"], atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(NotImplementedError, match="lanes layout"):
        tmodel.decode_step_paged(None, None, None, None)
