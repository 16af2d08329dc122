"""The VLM family of the port against the JAX package: ``DecoderLM`` with
``cross_attn_every`` (llama-3.2-vision-90b reduced, cut to 4 layers: two
groups of one self layer and one gated cross layer; d_model 64, 4 heads of
16 over 1 KV head), fp32 on the CPU.

The same numpy inputs (tokens, image embeddings, and the JAX package's
weights carried across with ``params_from_numpy``) go through both. The
gates start at zero in both packages, which would take the whole cross path
out of the output (``tanh(0) = 0``), so every test here sets them to nonzero
values drawn from a seed, the same on both sides. ``reduced()`` gives 2
layers, one group, which cannot show a wrong self-to-cross order: the tests
run 4 (two groups) on both sides, with 16 and 17 image tokens (17 is one
past a power of two, ragged against any tile). Tolerance: atol 1e-5 and
rtol 1e-4 (fp32: the two packages sum the einsums in their own orders), on
logits and every cache leaf (``k``, ``v``, ``cross_k``, ``cross_v``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.kvcache import add_ring as jadd_ring
from repro.models import build_model as jbuild
from repro.models.transformer import direct_kv_write as jdirect
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs import ARCHS, NOT_PORTED, get_config
from repro_torch.kvcache import add_ring
from repro_torch.models import (DecoderLM, build_model, media_spec,
                                needs_media)
from repro_torch.models.transformer import CrossBlock

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
ARCH = "llama-3.2-vision-90b"
LAYERS = 4
B, S, MAX_SEQ = 3, 24, 48
PAGED_REFUSAL = "paged KV decode covers"
RING_REFUSAL = "staging-ring KV overlay is wired for the dense family"


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def vlm_cfg(get, n_image_tokens=16):
    """The reduced config at 4 layers (two groups) and ``n_image_tokens``,
    from ``get`` (either package's ``get_config``)."""
    return dataclasses.replace(get(ARCH).reduced(), n_layers=LAYERS,
                               n_image_tokens=n_image_tokens)


def seeded_gates(jparams, seed=7):
    """The JAX tree with nonzero gates drawn from ``seed``
    (``[n_groups]`` each, as JAX's ``vmap`` stacks them)."""
    rng = np.random.RandomState(seed)
    cb = dict(jparams["cross_blocks"])
    for name in ("gate_attn", "gate_mlp"):
        cb[name] = jnp.asarray(rng.uniform(0.3, 1.2, cb[name].shape)
                               .astype(np.float32))
    return dict(jparams, cross_blocks=cb)


def make_pair(n_image_tokens, seed=3):
    jcfg = vlm_cfg(jget, n_image_tokens)
    jmodel = jbuild(jcfg)
    jparams = seeded_gates(jmodel.init(jax.random.key(seed), MAX_SEQ))
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams), build_model(
        vlm_cfg(get_config, n_image_tokens), device="cpu"))
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    media = rng.randn(*media_spec(tmodel.cfg, B)).astype(np.float32)
    return jmodel, jparams, tmodel, tokens, media


@pytest.fixture(scope="module", params=[16, 17], ids=["img16", "img17"])
def pair(request):
    """(JAX model, params; the port's model on the same weights, gates
    nonzero; numpy tokens [B, S] and image embeddings [B, T, D])."""
    return make_pair(request.param)


@pytest.fixture(scope="module")
def pair16():
    return make_pair(16)


def test_config_equals_the_jax_package():
    """Registered (``NOT_PORTED`` is empty), and field for field the JAX
    config: full, reduced and reduced at 4 layers. ``get_config`` builds a
    model."""
    assert ARCH in ARCHS and NOT_PORTED == ()
    assert len(ARCHS) == 10
    for mine, theirs in ((get_config(ARCH), jget(ARCH)),
                         (get_config(ARCH).reduced(), jget(ARCH).reduced()),
                         (vlm_cfg(get_config), vlm_cfg(jget))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab,
            full.cross_attn_every, full.n_image_tokens, full.rope_theta) == (
        100, 8192, 64, 8, 128, 28672, 128256, 5, 1601, 500_000.0)
    assert needs_media(full) and media_spec(full, 2) == (2, 1601, 8192)
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    assert type(model) is DecoderLM and model.is_vlm
    assert (model.n_groups, model.n_self_per_group) == (1, 1)


def test_model_class_cache_layout_and_layer_order(pair16):
    """Two groups of one self and one cross layer, as JAX splits them; the
    cache's leaves and shapes are JAX's; fresh gates are zero; the layers
    run self 0, cross 0, self 1, cross 1 (and at 10 layers, 4 self layers a
    group before each cross layer)."""
    jmodel, jparams, tmodel, _, _ = pair16
    assert type(tmodel) is DecoderLM and tmodel.is_vlm
    assert (tmodel.n_groups, tmodel.n_self_per_group) == (
        jmodel.n_groups, jmodel.n_self_per_group) == (2, 1)
    assert len(tmodel.blocks) == 2 and len(tmodel.cross_blocks) == 2
    assert all(type(cb) is CrossBlock for cb in tmodel.cross_blocks)
    jc = jmodel.init_cache(3, 40)
    tc = tmodel.init_cache(3, 40)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    fresh = build_model(vlm_cfg(get_config), device="cpu").init(0)
    for cb in fresh.cross_blocks:
        assert float(cb.gate_attn) == float(cb.gate_mlp) == 0.0
        assert cb.gate_attn.dtype == torch.float32 and cb.gate_attn.dim() == 0
    order = [("cross" if cb is not None else "self", i)
             for i, _, cb in tmodel._stack()]
    assert order == [("self", 0), ("cross", 0), ("self", 1), ("cross", 1)]
    ten = build_model(dataclasses.replace(vlm_cfg(get_config), n_layers=10,
                                          cross_attn_every=5), device="cpu")
    order = [("cross" if cb is not None else "self", i)
             for i, _, cb in ten._stack()]
    assert order == [("self", i) for i in range(4)] + [("cross", 0)] + [
        ("self", i) for i in range(4, 8)] + [("cross", 1)]


def test_prefill_logits_and_every_cache_leaf(pair):
    jmodel, jparams, tmodel, tokens, media = pair
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                            media=jnp.asarray(media))
    tl, tc = tmodel.prefill(torch.from_numpy(tokens).long(), MAX_SEQ,
                            media=torch.from_numpy(media))
    close(tl, jl, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for k in tc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        close(tc[k], jc[k], f"cache leaf {k}")


def _chunked(model_step, cache, tokens, c, media):
    """Whole prompt in chunks of ``c``, the media on EVERY chunk."""
    lg = None
    for s0 in range(0, tokens.shape[1], c):
        lg, cache = model_step(cache, tokens[:, s0:s0 + c], s0, media)
    return lg, cache


@pytest.mark.parametrize("c", [16, 5])
def test_chunk_prefill_equals_prefill(pair, c):
    """Chunks of 16 and a ragged 5, the media on every chunk (each cross
    layer projects its image K/V again, as JAX does): the port's chunked
    logits and cache equal JAX's chunked ones and the one-shot prefill's."""
    jmodel, jparams, tmodel, tokens, media = pair
    jl_ref, jc_ref = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                                    media=jnp.asarray(media))
    jl, jc = _chunked(
        lambda cache, t, s0, m: jmodel.chunk_prefill(
            jparams, cache, t, s0, media=m),
        jmodel.init_cache(B, MAX_SEQ, jnp.float32), jnp.asarray(tokens), c,
        jnp.asarray(media))
    tl, tc = _chunked(
        lambda cache, t, s0, m: tmodel.chunk_prefill(cache, t, s0, media=m),
        tmodel.init_cache(B, MAX_SEQ), torch.from_numpy(tokens).long(), c,
        torch.from_numpy(media))
    close(tl, jl, f"chunk {c} logits vs JAX chunked")
    close(tl, jl_ref, f"chunk {c} logits vs prefill")
    for k in tc:
        close(tc[k], jc[k], f"chunk {c} cache leaf {k} vs JAX chunked")
        close(tc[k], jc_ref[k], f"chunk {c} cache leaf {k} vs prefill")


def test_eight_decode_steps_with_a_slot_held_back(pair):
    """Prefill half the prompt, then 8 teacher-forced decode steps with a
    ``write_mask`` that holds slot 1 back (the JAX side through a masked
    writer): logits and every cache leaf equal JAX's each step, slot 1's
    ``k`` / ``v`` rows past the prompt stay unwritten, and the cross K/V is
    read, never written."""
    jmodel, jparams, tmodel, tokens, media = pair
    half = S // 2
    _, jc = jmodel.prefill(jparams, jnp.asarray(tokens[:, :half]), MAX_SEQ,
                           media=jnp.asarray(media))
    _, tc = tmodel.prefill(torch.from_numpy(tokens[:, :half]).long(),
                           MAX_SEQ, media=torch.from_numpy(media))
    cross0 = tc["cross_k"].clone()
    mask = np.array([True, False, True])
    jmask = jnp.asarray(mask)

    def masked_writer(kc, vc, k_new, v_new, rows):
        return jdirect(kc, vc, k_new, v_new,
                       jnp.where(jmask, rows, kc.shape[1]))

    # one compiled JAX step (its eager one retraces the layer scan each call)
    jstep = jax.jit(jmodel.decode_step, static_argnames="kv_writer")
    for t in range(half, half + 8):
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t]),
                       jnp.asarray(pos), kv_writer=masked_writer)
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(tokens[:, t]).long(),
                                    torch.from_numpy(pos).long(),
                                    write_mask=torch.from_numpy(mask))
        close(tl, jl, f"decode logits at {t}")
        for k in tc:
            close(tc[k], jc[k], f"decode cache leaf {k} at {t}")
    for k in ("k", "v"):
        assert not tc[k][:, 1, half:].any(), k
        assert tc[k][:, 0, half:half + 8].abs().sum(-1).min() > 0, k
    assert torch.equal(tc["cross_k"], cross0)


def test_weights_through_the_jax_checkpoint(pair16, tmp_path):
    """The JAX package's checkpoint writer saves the VLM tree (the gates
    stacked to ``[n_groups]``); ``load_checkpoint`` plus
    ``params_from_numpy`` give the JAX logits and the in-memory bridge's
    parameters."""
    jmodel, jparams, tmodel, tokens, media = pair16
    jckpt.save(str(tmp_path), 5, jparams)
    tree = load_checkpoint(str(tmp_path))
    assert set(tree) == {"embed", "ln_f", "blocks", "cross_blocks"}
    assert set(tree["cross_blocks"]) == {"ln1", "attn", "gate_attn", "ln2",
                                         "mlp", "gate_mlp"}
    assert tree["cross_blocks"]["gate_attn"].shape == (2,)
    fresh = params_from_numpy(tree, build_model(vlm_cfg(get_config),
                                                device="cpu"))
    for (n1, p1), (n2, p2) in zip(tmodel.named_parameters(),
                                  fresh.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    assert float(fresh.cross_blocks[1].gate_mlp) == float(
        tree["cross_blocks"]["gate_mlp"][1]) != 0.0
    jl, _ = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                           media=jnp.asarray(media))
    tl, _ = fresh.prefill(torch.from_numpy(tokens).long(), MAX_SEQ,
                          media=torch.from_numpy(media))
    close(tl, jl, "logits through the checkpoint")
    short = jax.tree.map(lambda a: np.asarray(a)[:1], tree["cross_blocks"])
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(dict(tree, cross_blocks=short), fresh)


def test_media_change_the_logits_through_the_gates(pair16):
    """The cross path is live: other image embeddings move the prefill and
    decode logits on both sides. With the gates at zero (as initialised)
    they move nothing, on both sides."""
    jmodel, jparams, tmodel, tokens, media = pair16
    other = np.random.RandomState(5).randn(*media.shape).astype(np.float32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()

    def logits(jp, model, m):
        jl, jc = jmodel.prefill(jp, jt, MAX_SEQ, media=jnp.asarray(m))
        tl, tc = model.prefill(tt, MAX_SEQ, media=torch.from_numpy(m))
        pos = np.full((B,), S, np.int32)
        jd, _ = jmodel.decode_step(jp, jc, jt[:, 0], jnp.asarray(pos))
        td, _ = model.decode_step(tc, tt[:, 0], torch.from_numpy(pos).long())
        return [np.asarray(jl), tl.numpy(), np.asarray(jd), td.numpy()]

    for a, b in zip(logits(jparams, tmodel, media),
                    logits(jparams, tmodel, other)):
        assert np.abs(a - b).max() > 1e-3
    zero = dict(jparams, cross_blocks=dict(
        jparams["cross_blocks"],
        gate_attn=jnp.zeros_like(jparams["cross_blocks"]["gate_attn"]),
        gate_mlp=jnp.zeros_like(jparams["cross_blocks"]["gate_mlp"])))
    tzero = params_from_numpy(jax.tree.map(np.asarray, zero), build_model(
        vlm_cfg(get_config), device="cpu"))
    for a, b in zip(logits(zero, tzero, media), logits(zero, tzero, other)):
        np.testing.assert_array_equal(a, b)


def test_refusals_equal_the_jax_package(pair16):
    """Both packages refuse the paged steps (the VLM serves from lanes) and
    a staging ring on the VLM's lanes, with JAX's messages; the port's
    prefill and chunk without media raise ``ValueError`` (JAX's fail on the
    ``None`` inside its trace)."""
    jmodel, jparams, tmodel, tokens, media = pair16
    b = 2
    tok = torch.zeros((b,), dtype=torch.long)
    for call in (lambda: tmodel.decode_step_paged(
                     {}, tok, tok, torch.ones((b,), dtype=torch.bool)),
                 lambda: tmodel.decode_chunk_paged(
                     {}, tok[:, None], tok, tok + 1,
                     torch.ones((b,), dtype=torch.bool))):
        with pytest.raises(NotImplementedError, match=PAGED_REFUSAL):
            call()
    jtok = jnp.zeros((b,), jnp.int32)
    with pytest.raises(NotImplementedError, match=PAGED_REFUSAL):
        jmodel.decode_step_paged(jparams, {}, jtok, jtok,
                                 jnp.ones((b,), jnp.bool_))
    with pytest.raises(NotImplementedError, match=PAGED_REFUSAL):
        jmodel.decode_chunk_paged(jparams, {}, jtok[:, None], jtok, jtok + 1,
                                  jnp.ones((b,), jnp.bool_))
    tcache = add_ring(tmodel.init_cache(b, MAX_SEQ), 4)
    with pytest.raises(NotImplementedError, match=RING_REFUSAL):
        tmodel.decode_step(tcache, tok, tok)
    jcache = jadd_ring(jmodel.init_cache(b, MAX_SEQ, jnp.float32), 4)
    with pytest.raises(NotImplementedError, match=RING_REFUSAL):
        jmodel.decode_step(jparams, jcache, jtok, jtok)
    with pytest.raises(ValueError, match="takes media"):
        tmodel.prefill(torch.from_numpy(tokens).long(), MAX_SEQ)
    with pytest.raises(ValueError, match="takes media"):
        tmodel.chunk_prefill(tmodel.init_cache(B, MAX_SEQ),
                             torch.from_numpy(tokens).long(), 0)
    with pytest.raises(Exception):
        jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ)
