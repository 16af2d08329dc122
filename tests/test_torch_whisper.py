"""The encoder-decoder family of the port against the JAX package:
``WhisperModel`` (reduced whisper-medium: 2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, 32 audio frames, 4096 learned decoder positions),
fp32 on the CPU.

The same numpy inputs (tokens, frames, and the JAX package's weights carried
across with ``params_from_numpy``) go through both. Tolerance: atol 1e-5
and rtol 1e-4 (fp32: the two packages sum the einsums in their own orders),
on the encoder's output, logits and every cache leaf (``k``, ``v``,
``cross_k``, ``cross_v``). The reference's encoder is causal: replacing the
last frame leaves every other row of its output unchanged, on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models.transformer import direct_kv_write as jdirect
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import (WhisperModel, build_model, media_spec,
                                needs_media)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
ARCH = "whisper-medium"
B, S, MAX_SEQ = 3, 32, 64


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params; the port's model on the same weights; numpy
    tokens [B, S] and frames [B, F, D])."""
    jcfg = jget(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(3), MAX_SEQ)
    tmodel = params_from_numpy(
        jax.tree.map(np.asarray, jparams),
        build_model(get_config(ARCH).reduced(), device="cpu",
                    max_seq=MAX_SEQ))
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    frames = rng.randn(*media_spec(tmodel.cfg, B)).astype(np.float32)
    return jmodel, jparams, tmodel, tokens, frames


def test_config_equals_the_jax_package():
    """Registered, and field for field the JAX config, full and reduced:
    2 + 2 layers, 32 frames and 4096 learned positions when reduced."""
    assert ARCH in ARCHS
    for mine, theirs in ((get_config(ARCH), jget(ARCH)),
                         (get_config(ARCH).reduced(), jget(ARCH).reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    assert (full.n_layers, full.n_enc_layers, full.d_model, full.n_heads,
            full.resolved_head_dim, full.vocab, full.n_audio_frames,
            full.max_position) == (24, 24, 1024, 16, 64, 51865, 1500, 448)
    assert (red.n_layers, red.n_enc_layers, red.n_audio_frames,
            red.max_position, red.learned_pos) == (2, 2, 32, 4096, True)
    assert needs_media(full) and media_spec(full, 2) == (2, 1500, 1024)
    assert not needs_media(get_config("stablelm-1.6b"))
    with pytest.raises(ValueError, match="no media"):
        media_spec(get_config("stablelm-1.6b"), 1)


def test_model_class_and_cache_layout(pair):
    jmodel, jparams, tmodel, _, _ = pair
    assert type(tmodel) is WhisperModel and tmodel.device.type == "cpu"
    assert tuple(tmodel.dec_pos.shape) == jparams["dec_pos"].shape
    assert tuple(tmodel.enc_pos.shape) == jparams["enc_pos"].shape
    jc = jmodel.init_cache(3, 40)
    tc = tmodel.init_cache(3, 40)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    assert tc["cross_k"].shape[2] == tmodel.cfg.n_audio_frames
    # the learned table grows with max_seq past max_position, as in JAX
    big = build_model(get_config(ARCH).reduced(), device="cpu", max_seq=5000)
    assert big.dec_pos.shape[0] == 5000
    # forward / loss (training) are ported and, like prefill, take media:
    # without them they raise prefill's ValueError
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="takes media"):
        tmodel.forward(toks)
    with pytest.raises(ValueError, match="takes media"):
        tmodel.loss({"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match="takes media"):
        tmodel.prefill(toks, MAX_SEQ)
    frames = pair[4][:1]
    with torch.no_grad():
        got = tmodel.forward(toks, torch.from_numpy(frames))
    close(got, jmodel.forward(jparams, jnp.zeros((1, 4), jnp.int32),
                              jnp.asarray(frames)), "forward logits")


def test_encode(pair):
    jmodel, jparams, tmodel, _, frames = pair
    want = jmodel.encode(jparams, jnp.asarray(frames))
    got = tmodel.encode(torch.from_numpy(frames))
    assert got.shape == (B,) + frames.shape[1:]
    close(got, want, "encode")


def test_the_reference_encoder_is_causal_on_both_sides(pair):
    """Replacing the last frame leaves encoder rows 0 .. F-2 unchanged in
    JAX and in the port (the reference's encoder masks causally), and
    moves the last row."""
    jmodel, jparams, tmodel, _, frames = pair
    other = frames.copy()
    other[:, -1] = np.random.RandomState(5).randn(*other[:, -1].shape)
    for name, run in (
            ("jax", lambda f: np.asarray(jmodel.encode(jparams,
                                                       jnp.asarray(f)))),
            ("port", lambda f: tmodel.encode(torch.from_numpy(f)).numpy())):
        a, b = run(frames), run(other)
        np.testing.assert_array_equal(a[:, :-1], b[:, :-1], err_msg=name)
        assert np.abs(a[:, -1] - b[:, -1]).max() > 1e-3, name


def test_prefill_logits_and_every_cache_leaf(pair):
    jmodel, jparams, tmodel, tokens, frames = pair
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                            media=jnp.asarray(frames))
    tl, tc = tmodel.prefill(torch.from_numpy(tokens).long(), MAX_SEQ,
                            media=torch.from_numpy(frames))
    close(tl, jl, "prefill logits")
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for k in tc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        close(tc[k], jc[k], f"cache leaf {k}")


def _chunked(model_step, cache, tokens, c, media):
    """Whole prompt in chunks of ``c``, the media on the first only."""
    lg = None
    for s0 in range(0, tokens.shape[1], c):
        lg, cache = model_step(cache, tokens[:, s0:s0 + c], s0,
                               media if s0 == 0 else None)
    return lg, cache


@pytest.mark.parametrize("c", [16, 5])
def test_chunk_prefill_equals_prefill(pair, c):
    """The twin of ``tests/test_models.py::test_chunked_prefill_equals_
    oneshot`` at chunks of 16 and a ragged 5, the encoder run on the first
    chunk only (later chunks read the cross K/V from the cache): the port's
    chunked logits and cache equal JAX's chunked ones and the one-shot
    prefill's."""
    jmodel, jparams, tmodel, tokens, frames = pair
    jl_ref, jc_ref = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                                    media=jnp.asarray(frames))
    jl, jc = _chunked(
        lambda cache, t, s0, m: jmodel.chunk_prefill(
            jparams, cache, t, s0, media=m),
        jmodel.init_cache(B, MAX_SEQ, jnp.float32), jnp.asarray(tokens), c,
        jnp.asarray(frames))
    tl, tc = _chunked(
        lambda cache, t, s0, m: tmodel.chunk_prefill(cache, t, s0, media=m),
        tmodel.init_cache(B, MAX_SEQ), torch.from_numpy(tokens).long(), c,
        torch.from_numpy(frames))
    close(tl, jl, f"chunk {c} logits vs JAX chunked")
    close(tl, jl_ref, f"chunk {c} logits vs prefill")
    for k in tc:
        close(tc[k], jc[k], f"chunk {c} cache leaf {k} vs JAX chunked")
        close(tc[k], jc_ref[k], f"chunk {c} cache leaf {k} vs prefill")


def test_eight_decode_steps_with_a_slot_held_back(pair):
    """Prefill half the prompt, then 8 teacher-forced decode steps with a
    ``write_mask`` that holds slot 1 back (the JAX side through the JAX
    engine's masked writer): logits and every cache leaf equal JAX's each
    step, and slot 1's ``k`` / ``v`` rows past the prompt stay unwritten."""
    jmodel, jparams, tmodel, tokens, frames = pair
    half = S // 2
    _, jc = jmodel.prefill(jparams, jnp.asarray(tokens[:, :half]), MAX_SEQ,
                           media=jnp.asarray(frames))
    _, tc = tmodel.prefill(torch.from_numpy(tokens[:, :half]).long(),
                           MAX_SEQ, media=torch.from_numpy(frames))
    mask = np.array([True, False, True])
    jmask = jnp.asarray(mask)

    def masked_writer(kc, vc, k_new, v_new, rows):
        return jdirect(kc, vc, k_new, v_new,
                       jnp.where(jmask, rows, kc.shape[1]))

    for t in range(half, half + 8):
        pos = np.full((B,), t, np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tokens[:, t]),
                                    jnp.asarray(pos),
                                    kv_writer=masked_writer)
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(tokens[:, t]).long(),
                                    torch.from_numpy(pos).long(),
                                    write_mask=torch.from_numpy(mask))
        close(tl, jl, f"decode logits at {t}")
        for k in tc:
            close(tc[k], jc[k], f"decode cache leaf {k} at {t}")
    for k in ("k", "v"):
        assert not tc[k][:, 1, half:].any(), k
        assert tc[k][:, 0, half:half + 8].abs().sum(-1).min() > 0, k


def test_decode_position_past_the_table_is_nan_as_in_jax(pair):
    """``dec_pos`` is read with the reference's ``take``, which fills a
    position past the table with NaN: that slot's logits are NaN on both
    sides and the other slots' are untouched. (The engine never gets
    there: a request's positions stay below ``max_seq``, and the table has
    at least ``max_seq`` rows when the model is built for it.)"""
    jmodel, jparams, tmodel, tokens, frames = pair
    n = tmodel.dec_pos.shape[0]
    _, jc = jmodel.prefill(jparams, jnp.asarray(tokens[:, :4]), 8,
                           media=jnp.asarray(frames))
    _, tc = tmodel.prefill(torch.from_numpy(tokens[:, :4]).long(), 8,
                           media=torch.from_numpy(frames))
    pos = np.array([4, n, n + 7], np.int32)
    jl, _ = jmodel.decode_step(jparams, jc, jnp.asarray(tokens[:, 4]),
                               jnp.asarray(pos))
    tl, _ = tmodel.decode_step(tc, torch.from_numpy(tokens[:, 4]).long(),
                               torch.from_numpy(pos).long())
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.isnan(jl[1:]).all() and np.isnan(tl[1:]).all()
    assert np.isfinite(jl[0]).all() and np.isfinite(tl[0]).all()
    close(tl[0], jl[0], "the slot inside the table")


def test_weights_through_the_jax_checkpoint(pair, tmp_path):
    """The JAX package's checkpoint writer saves the whisper tree; the
    port's ``load_checkpoint`` plus ``params_from_numpy`` give the JAX
    logits (and the same parameters as the in-memory bridge)."""
    jmodel, jparams, tmodel, tokens, frames = pair
    jckpt.save(str(tmp_path), 3, jparams)
    tree = load_checkpoint(str(tmp_path))
    assert set(tree) == {"embed", "enc_pos", "dec_pos", "enc_blocks",
                         "ln_enc", "dec_blocks", "ln_f"}
    assert set(tree["dec_blocks"]) == {"ln1", "self_attn", "ln2",
                                       "cross_attn", "ln3", "mlp"}
    fresh = params_from_numpy(tree, build_model(
        get_config(ARCH).reduced(), device="cpu", max_seq=MAX_SEQ))
    for (n1, p1), (n2, p2) in zip(tmodel.named_parameters(),
                                  fresh.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    jl, _ = jmodel.prefill(jparams, jnp.asarray(tokens), MAX_SEQ,
                           media=jnp.asarray(frames))
    tl, _ = fresh.prefill(torch.from_numpy(tokens).long(), MAX_SEQ,
                          media=torch.from_numpy(frames))
    close(tl, jl, "logits through the checkpoint")
    short = jax.tree.map(lambda a: np.asarray(a)[:1], tree["dec_blocks"])
    with pytest.raises(ValueError, match="n_layers"):
        params_from_numpy(dict(tree, dec_blocks=short), fresh)
    with pytest.raises(ValueError, match="dec_pos"):
        params_from_numpy(dict(tree, dec_pos=tree["dec_pos"][:8]), fresh)
