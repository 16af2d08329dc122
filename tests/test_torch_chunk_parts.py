"""The chunk half of the port against the JAX package, on the same numpy
inputs (fp32, CPU):

* the paged cache's chunk addressing and overlay: ``logical_to_physical_many``
  and ``scatter_chunk`` (invalid rows land in the sink, never wrap),
  ``view_chunk_mask_from`` and ``overlay_chunk_parts`` (with and without a
  hoisted plan, with unload masks), exact;
* ``write_chunk``'s three ring cases and ``slot_positions``, exact;
* ``decode_chunk_paged`` (reduced stablelm), the reference read and the
  fused one (the plain version of ``flash_decode_paged``), with and without
  the staging ring, with ``all_logits`` on and off, one batch holding slots
  with ``n_valid`` = C (prefill chunk), 1 (decode) and 0 (an empty slot,
  every key masked): pool, ring and masks exact, logits atol 2e-6 / rtol
  1e-4 as ``tests/test_flash_decode_paged.py``;
* ``chunk_prefill`` on the lanes cache (reduced h2o-danube-3-4b, window
  32): equal to JAX ``chunk_prefill`` while the prompt stays inside the
  window, and to JAX ``prefill`` past it, where JAX ``chunk_prefill`` is not
  (a known difference inside the reference, shown on its smallest input).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kvcache import paged as JP
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kvcache import paged as TP
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(1)

L, NB, PS, S, MP, H, DH, R = 2, 10, 4, 3, 5, 2, 4, 4
TOL = dict(atol=2e-6, rtol=1e-4)
LANES_TOL = dict(atol=2e-5, rtol=1e-4)   # as tests/test_torch_lanes.py


def T(a):
    return torch.from_numpy(np.array(a))


def eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _caches(seed, fill=0):
    """The same paged cache with a staging ring on both sides (the port's
    planes carry one sink block more)."""
    rng = np.random.RandomState(seed)
    table = np.full((S, MP), -1, np.int32)
    perm = rng.permutation(NB)
    table[0, :3] = perm[:3]
    table[1, :2] = perm[3:5]
    table[2, :4] = perm[5:9]
    pk = rng.randn(L, NB, PS, H, DH).astype(np.float32)
    ring_pos = np.full((S, R), -1, np.int32)
    for c in range(fill):       # distinct rows below each slot's cursor
        ring_pos[0, c] = 4 + c
        ring_pos[2, c] = 9 + c if c % 2 == 0 else -1
    jc = JP.make_paged_kv(L, NB, PS, S, MP, H, DH, ring_size=R)
    jc = dict(jc, pages_k=jnp.asarray(pk), page_table=jnp.asarray(table),
              ring_pos=jnp.asarray(ring_pos), ring_fill=jnp.int32(fill))
    tc = TP.make_paged_kv(L, NB, PS, S, MP, H, DH, ring_size=R, device="cpu")
    tc["pages_k"][:, :NB] = T(pk)
    tc.update(page_table=T(table).long(), ring_pos=T(ring_pos).long(),
              ring_fill=torch.tensor(fill))
    return jc, tc


# ---------------------------------------------------------------------------
# paged cache: chunk addressing and overlay
# ---------------------------------------------------------------------------

def test_logical_to_physical_many_and_scatter_chunk_drop_to_the_sink():
    jc, tc = _caches(0)
    # -1 sentinels, a row past the view, rows on unallocated pages
    rows = np.array([[0, 5, 11, 12, -1],
                     [4, 7, 8, -1, -1],
                     [13, 14, 15, 16, 20]], np.int32)
    jd = JP.logical_to_physical_many(jc, jnp.asarray(rows))
    td = TP.logical_to_physical_many(tc, T(rows).long())
    eq(td, jd)
    sink = TP.pool_rows(tc)
    assert int(td.max()) == sink and int(td.min()) >= 0
    assert int((td == sink).sum()) == int((np.asarray(jd) == NB * PS).sum())
    tiles = np.random.RandomState(1).randn(S, 5, H, DH).astype(np.float32)
    want = JP.scatter_chunk(jc["pages_k"][1], jd, jnp.asarray(tiles))
    got = TP.scatter_chunk(tc["pages_k"][1], td, T(tiles))
    assert got is tc["pages_k"][1] or got.data_ptr() == \
        tc["pages_k"][1].data_ptr()
    eq(tc["pages_k"][1, :NB], want)
    eq(tc["pages_k"][0, :NB], jc["pages_k"][0])   # other layers untouched


@pytest.mark.parametrize("seed", range(3))
def test_view_chunk_mask_from(seed):
    jc, tc = _caches(seed)
    rng = np.random.RandomState(seed)
    pos = rng.randint(-1, MP * PS, size=(S, 4)).astype(np.int32)
    jplan, tplan = JP.step_plan(jc), TP.step_plan(tc)
    eq(TP.view_chunk_mask_from(tplan.allocated, T(pos).long()),
       JP.view_chunk_mask_from(jplan.allocated, jnp.asarray(pos)))


@pytest.mark.parametrize("fill,hoisted", [(0, True), (2, False), (3, True)])
@pytest.mark.parametrize("unload", [[False, False, False], [True, False, True],
                                    [True, True, True]])
def test_overlay_chunk_parts(fill, hoisted, unload):
    jc, tc = _caches(2, fill=fill)
    start = np.array([8, 6, 13], np.int32)
    pos = start[:, None] + np.arange(3, dtype=np.int32)[None, :]
    um = np.asarray(unload)
    jv, jr, jcur = JP.overlay_chunk_parts(
        jc, jnp.asarray(pos), jnp.asarray(um),
        allocated=JP.step_plan(jc).allocated if hoisted else None)
    tv, tr, tcur = TP.overlay_chunk_parts(
        tc, T(pos).long(), T(um),
        allocated=TP.step_plan(tc).allocated if hoisted else None)
    eq(tv, jv)
    eq(tr, jr)
    assert int(tcur) == int(jcur) == fill
    # shadowing: a live staged row and this step's staged column-0 row are
    # not read from the view by any query column
    for s in range(S):
        if um[s]:
            assert not tv[s, :, start[s]].any()


# ---------------------------------------------------------------------------
# lanes cache: ring addressing of a chunk
# ---------------------------------------------------------------------------

# (clen, c, start): fits, ends at the ring's end, wraps, covers the ring
# exactly, covers it and more, a single row
WRITE_CASES = [(8, 3, 2), (8, 3, 5), (8, 3, 6), (8, 8, 0), (8, 8, 11),
               (8, 11, 5), (8, 1, 7)]


@pytest.mark.parametrize("clen,c,start", WRITE_CASES)
def test_write_chunk_ring_cases(clen, c, start):
    rng = np.random.RandomState(clen * 100 + c * 10 + start)
    cache = rng.randn(2, clen, H, DH).astype(np.float32)
    chunk = rng.randn(2, c, H, DH).astype(np.float32)
    want = JL.write_chunk(jnp.asarray(cache), jnp.asarray(chunk), start)
    got = T(cache).clone()
    TL.write_chunk(got, T(chunk), start)
    eq(got, want)
    last = start + c - 1
    eq(TL.slot_positions(clen, last), JL.slot_positions(clen, last))


# ---------------------------------------------------------------------------
# decode_chunk_paged (reduced stablelm)
# ---------------------------------------------------------------------------

B, C, MPM, PSM, RM = 3, 4, 4, 4, 3
NBM = B * MPM + 2


@pytest.fixture(scope="module")
def stablelm():
    jcfg = jget("stablelm-1.6b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(5), 32)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config("stablelm-1.6b")
                                           .reduced(), device="cpu"))
    return jcfg, jmodel, jparams, tmodel


def _chunk_caches(jcfg, ring):
    l, h, dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.resolved_head_dim
    rng = np.random.RandomState(3)
    table = np.full((B, MPM), -1, np.int32)
    perm = rng.permutation(NBM)
    table[0] = perm[:4]          # slot 0 prefills rows 6..9 after 6 rows
    table[1, :3] = perm[4:7]     # slot 1 decodes at row 9
    # slot 2: an empty slot (no pages: every key masked, n_valid = 0)
    pk = rng.randn(l, NBM, PSM, h, dh).astype(np.float32)
    pv = rng.randn(l, NBM, PSM, h, dh).astype(np.float32)
    jc = JP.make_paged_kv(l, NBM, PSM, B, MPM, h, dh,
                          ring_size=RM if ring else 0)
    jc = dict(jc, pages_k=jnp.asarray(pk), pages_v=jnp.asarray(pv),
              page_table=jnp.asarray(table))
    tc = TP.make_paged_kv(l, NBM, PSM, B, MPM, h, dh,
                          ring_size=RM if ring else 0, device="cpu")
    tc["pages_k"][:, :NBM] = T(pk)
    tc["pages_v"][:, :NBM] = T(pv)
    tc["page_table"] = T(table).long()
    return jc, tc


@pytest.mark.parametrize("all_logits", [False, True])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("attention", ["reference", "fused"])
def test_decode_chunk_paged_matches_jax(stablelm, attention, ring,
                                        all_logits):
    jcfg, jmodel, jparams, tmodel = stablelm
    jc, tc = _chunk_caches(jcfg, ring)
    rng = np.random.RandomState(4)
    # two steps: slot 0 a prefill chunk then a short last chunk, slot 1 two
    # decode tokens, slot 2 nothing
    steps = [(np.array([6, 9, 0]), np.array([C, 1, 0]),
              np.array([True, True, False]), np.array([False, True, False])),
             (np.array([10, 10, 0]), np.array([2, 1, 0]),
              np.array([True, True, False]), np.array([False, True, True]))]
    for start, n_valid, write, unload in steps:
        tokens = rng.randint(0, jcfg.vocab, (B, C)).astype(np.int32)
        jl, jc = jmodel.decode_chunk_paged(
            jparams, jc, jnp.asarray(tokens), jnp.asarray(start, jnp.int32),
            jnp.asarray(n_valid, jnp.int32), jnp.asarray(write),
            unload_mask=jnp.asarray(unload) if ring else None,
            attention="reference", all_logits=all_logits)
        tl, tc = tmodel.decode_chunk_paged(
            tc, T(tokens).long(), T(start).long(), T(n_valid).long(),
            T(write), unload_mask=T(unload) if ring else None,
            attention=attention, all_logits=all_logits)
        assert tl.shape == jl.shape == ((B, C, jcfg.vocab) if all_logits
                                        else (B, jcfg.vocab))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
    for plane in ("pages_k", "pages_v"):
        np.testing.assert_allclose(tc[plane][:, :NBM].numpy(),
                                   np.asarray(jc[plane]), **TOL)
    if ring:
        eq(tc["ring_pos"], jc["ring_pos"])
        assert int(tc["ring_fill"]) == int(jc["ring_fill"]) == 2
        live = np.asarray(jc["ring_pos"]) >= 0
        assert live.sum() == 2
        np.testing.assert_allclose(tc["ring_k"].numpy()[:, live],
                                   np.asarray(jc["ring_k"])[:, live], **TOL)


def test_decode_chunk_paged_c1_is_decode_step_paged(stablelm):
    """One column, every slot decoding: the mixed step's logits are those of
    ``decode_step_paged`` on the same cache."""
    jcfg, _, _, tmodel = stablelm
    _, tc = _chunk_caches(jcfg, True)
    tc2 = {k: v.clone() for k, v in tc.items()}
    tok = torch.tensor([5, 7, 9])
    pos = torch.tensor([6, 9, 0])
    write = torch.tensor([True, True, False])
    unload = torch.tensor([True, False, False])
    want, _ = tmodel.decode_step_paged(tc, tok, pos, write,
                                       unload_mask=unload,
                                       attention="reference")
    got, _ = tmodel.decode_chunk_paged(tc2, tok[:, None], pos,
                                       write.long(), write,
                                       unload_mask=unload,
                                       attention="reference")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for k in tc:
        np.testing.assert_allclose(tc2[k].float().numpy(),
                                   tc[k].float().numpy(), **TOL)


# ---------------------------------------------------------------------------
# chunk_prefill on the lanes cache (reduced h2o-danube-3-4b, window 32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h2o():
    jcfg = jget("h2o-danube-3-4b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(11), 64)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(get_config("h2o-danube-3-4b")
                                           .reduced(), device="cpu"))
    return jcfg, jmodel, jparams, tmodel


def _jax_chunked(jmodel, jparams, tokens, max_seq, chunk):
    cache = jmodel.init_cache(tokens.shape[0], max_seq)
    for s0 in range(0, tokens.shape[1], chunk):
        logits, cache = jmodel.chunk_prefill(
            jparams, cache, jnp.asarray(tokens[:, s0:s0 + chunk]), s0)
    return logits, cache


def _torch_chunked(tmodel, tokens, max_seq, chunk):
    cache = tmodel.init_cache(tokens.shape[0], max_seq)
    for s0 in range(0, tokens.shape[1], chunk):
        logits, cache = tmodel.chunk_prefill(
            cache, T(tokens[:, s0:s0 + chunk]).long(), s0)
    return logits, cache


@pytest.mark.parametrize("plen,chunk,max_seq", [(24, 8, 64), (32, 5, 64),
                                                (20, 8, 20), (13, 4, 64)])
def test_chunk_prefill_matches_jax_inside_the_window(h2o, plen, chunk,
                                                     max_seq):
    jcfg, jmodel, jparams, tmodel = h2o
    tokens = np.random.RandomState(plen).randint(0, jcfg.vocab, (2, plen))
    jl, jc = _jax_chunked(jmodel, jparams, tokens.astype(np.int32), max_seq,
                          chunk)
    tl, tc = _torch_chunked(tmodel, tokens, max_seq, chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LANES_TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **LANES_TOL)


@pytest.mark.parametrize("plen,chunk", [(34, 2), (40, 8), (48, 8), (70, 16),
                                        (45, 40)])
def test_chunk_prefill_past_the_window_matches_jax_prefill(h2o, plen, chunk):
    """Past the window the port's ``chunk_prefill`` is ``prefill``'s answer:
    logits and the kept ring of the last ``cache_len`` positions."""
    jcfg, jmodel, jparams, tmodel = h2o
    max_seq = 96
    tokens = np.random.RandomState(plen).randint(0, jcfg.vocab, (2, plen))
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32), max_seq)
    tl, tc = _torch_chunked(tmodel, tokens, max_seq, chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LANES_TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **LANES_TOL)
    pl, _ = tmodel.prefill(T(tokens).long(), max_seq)
    np.testing.assert_allclose(tl.numpy(), pl.numpy(), **LANES_TOL)


@pytest.mark.parametrize("window,plen,chunk", [(2, 3, 3), (32, 33, 3)])
def test_jax_chunk_prefill_differs_from_prefill_past_the_window(
        window, plen, chunk):
    """The known difference inside the reference: JAX ``chunk_prefill``
    writes the chunk into the ring BEFORE it attends, so once the prompt
    passes the window the chunk's own rows overwrite keys its first queries
    still need. Smallest input found (2 layers, seed 11): window 2, a prompt
    of 3 tokens in one chunk of 3 (the chunk covers the 2-slot ring, so
    query 0 loses key 0 and query 1 key 0); with the reduced window of 32, a
    33-token prompt in chunks of 3 (the last chunk, positions 30-32, writes
    position 32 over position 0, which query 30 still sees). JAX
    ``prefill`` is the right one here, and the port follows it."""
    jcfg = dataclasses.replace(jget("h2o-danube-3-4b").reduced(),
                               sliding_window=window)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(11), 64)
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab, (1, plen))
    jl, _ = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32), 64)
    cl, _ = _jax_chunked(jmodel, jparams, tokens.astype(np.int32), 64, chunk)
    assert float(np.abs(np.asarray(jl) - np.asarray(cl)).max()) > 1e-2
    # one token fewer (the chunk no longer overwrites a key in the window):
    # the two agree
    jl1, _ = jmodel.prefill(jparams, jnp.asarray(tokens[:, :-1], jnp.int32),
                            64)
    cl1, _ = _jax_chunked(jmodel, jparams, tokens[:, :-1].astype(np.int32),
                          64, chunk)
    np.testing.assert_allclose(np.asarray(cl1), np.asarray(jl1), **LANES_TOL)
    # the port's chunk_prefill on the same weights gives prefill's answer
    tcfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                               sliding_window=window)
    tmodel = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               build_model(tcfg, device="cpu"))
    tl, _ = _torch_chunked(tmodel, tokens, 64, chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LANES_TOL)


def test_chunk_attention_inside_the_window_matches_jax(h2o):
    """The port's read of one chunk (cache before the write + the chunk,
    through the plain ``flash_attention``) against JAX ``chunk_attention``
    (the ring after the write, masked by slot positions) where the ring
    still holds every key the window allows."""
    jcfg, _, jparams, tmodel = h2o
    rng = np.random.RandomState(9)
    clen, start, c = 32, 20, 6
    d = jcfg.d_model
    h, dh = jcfg.n_kv_heads, jcfg.resolved_head_dim
    x = rng.randn(2, c, d).astype(np.float32)
    kc = rng.randn(2, clen, h, dh).astype(np.float32)
    vc = rng.randn(2, clen, h, dh).astype(np.float32)
    positions = np.broadcast_to(start + np.arange(c), (2, c)).astype(np.int32)
    p = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    k_new, v_new = JL.project_kv(jcfg, p, jnp.asarray(x),
                                 jnp.asarray(positions))
    jk = JL.write_chunk(jnp.asarray(kc), k_new, start)
    jv = JL.write_chunk(jnp.asarray(vc), v_new, start)
    want = JL.chunk_attention(jcfg, p, jnp.asarray(x), jnp.asarray(positions),
                              jk, jv, JL.slot_positions(clen, start + c - 1))
    pt = tmodel.blocks[0].attn.tensors()
    got = TL.chunk_attention(tmodel.cfg, pt, T(x), T(positions).long(),
                             T(kc), T(vc), T(k_new), T(v_new), start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LANES_TOL)
