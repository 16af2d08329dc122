"""The port's dense decoder against the JAX package with the SAME weights
(initialised by the JAX package, carried across as numpy): layer functions,
``prefill`` logits and three ``decode_step_paged`` steps (reference and fused
read paths, with and without the staging ring), on the reduced stablelm
(LayerNorm, partial rotary, MHA), qwen2 (GQA, qkv bias) and nemotron
(squared-ReLU) configs. fp32 on the CPU: logits atol 2e-4 / rtol 1e-4 (the
two frameworks sum in different orders) and identical argmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.kvcache import paged as JP
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kvcache import paged as TP
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
ARCHS = ["stablelm-1.6b", "qwen2-7b", "nemotron-4-15b"]
B, S, PS, MP, R = 3, 8, 4, 4, 4
NB = B * MP


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg/model/params, numpy params, torch model) for one arch."""
    jcfg = jget(request.param).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(5), 32)
    if jcfg.qkv_bias:   # zero-initialised: give the biases something to do
        rng = np.random.RandomState(0)
        attn = dict(jparams["blocks"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.randn(*attn[k].shape).astype(np.float32)
                                  * 0.1)
        jparams = dict(jparams, blocks=dict(jparams["blocks"], attn=attn))
    np_params = jax.tree.map(np.asarray, jparams)
    tcfg = get_config(request.param).reduced()
    tmodel = params_from_numpy(np_params, build_model(tcfg, device="cpu"))
    return jcfg, jmodel, jparams, np_params, tcfg, tmodel


def test_configs_agree(pair):
    jcfg, _, _, _, tcfg, _ = pair
    import dataclasses
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jget(jcfg.name[:-6]).param_count() == get_config(
        tcfg.name[:-6]).param_count()


def test_layer_functions(pair):
    jcfg, _, jparams, np_params, tcfg, tmodel = pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, jcfg.d_model).astype(np.float32)
    blk = jax.tree.map(lambda a: a[1], jparams["blocks"])
    tblk = tmodel.blocks[1]
    np.testing.assert_allclose(
        TL.apply_norm(tcfg, tblk.ln1.tensors(), T(x)).numpy(),
        np.asarray(JL.apply_norm(jcfg, blk["ln1"], jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TL.apply_mlp(tcfg, tblk.mlp.tensors(), T(x)).numpy(),
        np.asarray(JL.apply_mlp(jcfg, blk["mlp"], jnp.asarray(x))), **TOL)
    pos = rng.randint(0, 50, (2, 5)).astype(np.int32)
    h = rng.randn(2, 5, jcfg.n_heads, jcfg.resolved_head_dim).astype(np.float32)
    np.testing.assert_allclose(
        TL.apply_rope(tcfg, T(h), T(pos)).numpy(),
        np.asarray(JL.apply_rope(jcfg, jnp.asarray(h), jnp.asarray(pos))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TL.rope_frequencies(tcfg, 16).numpy(),
        np.asarray(JL.rope_frequencies(jcfg, 16)), rtol=1e-6)
    jq = JL.project_q(jcfg, blk["attn"], jnp.asarray(x), jnp.asarray(pos))
    tq = TL.project_q(tcfg, tblk.attn.tensors(), T(x), T(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    jk, jv = JL.project_kv(jcfg, blk["attn"], jnp.asarray(x), jnp.asarray(pos))
    tk, tv = TL.project_kv(tcfg, tblk.attn.tensors(), T(x), T(pos))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(
        TL.attention(tcfg, tblk.attn.tensors(), T(x), T(pos)).numpy(),
        np.asarray(JL.attention(jcfg, blk["attn"], jnp.asarray(x),
                                jnp.asarray(pos))), **TOL)
    np.testing.assert_array_equal(
        TL.causal_mask(4, 6, window=3, offset=2).numpy(),
        np.asarray(JL.causal_mask(4, 6, window=3, offset=2)))
    assert TL.repeat_kv(tk, tcfg.n_heads).shape[2] == tcfg.n_heads


def test_compute_copy_is_cast_once(pair):
    tmodel = pair[5]
    a = tmodel.blocks[0].attn
    assert a.tensors(torch.float32)["wq"] is a.wq
    c1, c2 = a.tensors(torch.bfloat16), a.tensors(torch.bfloat16)
    assert c1 is c2 and c1["wq"].dtype == torch.bfloat16
    assert torch.equal(c1["wq"], a.wq.to(torch.bfloat16))


def _prefill_both(pair, seed=2):
    jcfg, jmodel, jparams, _, tcfg, tmodel = pair
    tokens = np.random.RandomState(seed).randint(0, jcfg.vocab, (B, S))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32), S)
    tl, tc = tmodel.prefill(T(tokens), S)
    return tokens, (jl, jc), (tl, tc)


def test_prefill_matches_jax(pair):
    _, (jl, jc), (tl, tc) = _prefill_both(pair)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    assert tl.dtype == torch.float32


@pytest.mark.parametrize("attention", ["reference", "fused"])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_step_paged_matches_jax(pair, attention, ring):
    jcfg, jmodel, jparams, _, tcfg, tmodel = pair
    _, (jl, jc), _ = _prefill_both(pair)
    l, h, dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.resolved_head_dim
    # one pool for both sides, filled from the JAX prefill's K/V
    rng = np.random.RandomState(3)
    table = rng.permutation(NB).reshape(B, MP).astype(np.int32)
    table[1, 3] = -1                       # an unallocated page
    pk = rng.randn(l, NB, PS, h, dh).astype(np.float32)   # garbage elsewhere
    pv = rng.randn(l, NB, PS, h, dh).astype(np.float32)
    for b in range(B):
        for r in range(S):
            blk = table[b, r // PS]
            pk[:, blk, r % PS] = np.asarray(jc["k"])[:, b, r]
            pv[:, blk, r % PS] = np.asarray(jc["v"])[:, b, r]
    jcache = JP.make_paged_kv(l, NB, PS, B, MP, h, dh,
                              ring_size=R if ring else 0)
    jcache = dict(jcache, pages_k=jnp.asarray(pk), pages_v=jnp.asarray(pv),
                  page_table=jnp.asarray(table))
    tcache = TP.make_paged_kv(l, NB, PS, B, MP, h, dh,
                              ring_size=R if ring else 0)
    tcache["pages_k"][:, :NB] = T(pk)
    tcache["pages_v"][:, :NB] = T(pv)
    tcache["page_table"] = T(table).long()

    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    write = np.array([True, True, False])           # slot 2 is dead
    for step in range(3):
        pos = np.array([S + step, S + step, 3], np.int32)
        unload = np.array([step % 2 == 0, step % 2 == 1, True])
        jlog, jcache = jmodel.decode_step_paged(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(write),
            unload_mask=jnp.asarray(unload) if ring else None,
            attention="reference")
        tlog, tcache = tmodel.decode_step_paged(
            tcache, T(tok).long(), T(pos).long(), T(write),
            unload_mask=T(unload) if ring else None, attention=attention)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      np.asarray(jlog).argmax(-1))
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    np.testing.assert_allclose(tcache["pages_k"][:, :NB].numpy(),
                               np.asarray(jcache["pages_k"]), **TOL)
    np.testing.assert_allclose(tcache["pages_v"][:, :NB].numpy(),
                               np.asarray(jcache["pages_v"]), **TOL)
    if ring:
        np.testing.assert_array_equal(tcache["ring_pos"].numpy(),
                                      np.asarray(jcache["ring_pos"]))
        assert int(tcache["ring_fill"]) == int(jcache["ring_fill"]) == 3
        live = np.asarray(jcache["ring_pos"]) >= 0
        np.testing.assert_allclose(
            tcache["ring_k"].numpy()[:, live],
            np.asarray(jcache["ring_k"])[:, live], **TOL)


def test_load_checkpoint_round_trip(pair, tmp_path):
    _, _, jparams, np_params, tcfg, tmodel = pair
    step_dir = jckpt.save(str(tmp_path), 7, jparams)
    for path in (step_dir, str(tmp_path)):          # step dir, or via LATEST
        tree = load_checkpoint(path)
        fresh = params_from_numpy(tree, build_model(tcfg, device="cpu"))
        for (n1, p1), (n2, p2) in zip(tmodel.named_parameters(),
                                      fresh.named_parameters()):
            assert n1 == n2 and torch.equal(p1, p2), n1
    np.testing.assert_array_equal(tree["embed"]["tok"],
                                  np_params["embed"]["tok"])
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nowhere"))


def test_params_from_numpy_rejects_wrong_trees(pair):
    _, _, _, np_params, tcfg, _ = pair
    model = build_model(tcfg, device="cpu")
    bad = dict(np_params, ln_f={"scale": np_params["ln_f"]["scale"][:-1]})
    with pytest.raises((ValueError, KeyError)):
        params_from_numpy(bad, model)
    short = jax.tree.map(lambda a: a[:1], np_params["blocks"])
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(dict(np_params, blocks=short), model)


def test_init_uses_the_jax_scales():
    cfg = get_config("stablelm-1.6b").reduced()
    m1 = build_model(cfg, device="cpu").init(3)
    m2 = build_model(cfg, device="cpu").init(3)
    m3 = build_model(cfg, device="cpu").init(4)
    for (n, a), (_, b), (_, c) in zip(m1.named_parameters(),
                                      m2.named_parameters(),
                                      m3.named_parameters()):
        assert torch.equal(a, b), n
        if a.dim() > 1:
            assert not torch.equal(a, c), n
    blk = m1.blocks[0]
    d, f = cfg.d_model, cfg.d_ff
    assert abs(float(blk.attn.wq.std()) - d ** -0.5) < 0.2 * d ** -0.5
    assert abs(float(blk.mlp.wo.std()) - f ** -0.5) < 0.2 * f ** -0.5
    assert abs(float(m1.embed.tok.std()) - 0.02) < 0.004
    assert torch.equal(blk.ln1.scale, torch.ones(d))
    assert not any(p.requires_grad for p in m1.parameters())
