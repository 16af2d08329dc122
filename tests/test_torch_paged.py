"""The port's paged KV cache against the JAX package: ``BlockPool`` hands
out the same blocks over a random alloc/free trace (the write-path telemetry
depends on block ids), addressing and masks are exact, and after a forced
drain the pool bytes of the staged path equal the direct path's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged as JP
from repro_torch.kvcache import paged as TP

torch.set_num_threads(1)

L, NB, PS, S, MP, H, DH, R = 2, 10, 4, 3, 5, 2, 4, 4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _caches(seed, ring=True, fill=0):
    """The same paged cache on both sides (the port's planes carry one sink
    block more)."""
    rng = np.random.RandomState(seed)
    table = np.full((S, MP), -1, np.int32)
    perm = rng.permutation(NB)
    table[0, :3] = perm[:3]
    table[1, :2] = perm[3:5]
    table[2, :4] = perm[5:9]
    pk = rng.randn(L, NB, PS, H, DH).astype(np.float32)
    pv = rng.randn(L, NB, PS, H, DH).astype(np.float32)
    jc = JP.make_paged_kv(L, NB, PS, S, MP, H, DH, ring_size=R if ring else 0)
    jc = dict(jc, pages_k=jnp.asarray(pk), pages_v=jnp.asarray(pv),
              page_table=jnp.asarray(table))
    tc = TP.make_paged_kv(L, NB, PS, S, MP, H, DH, ring_size=R if ring else 0,
                          device="cpu")
    tc["pages_k"][:, :NB] = T(pk)
    tc["pages_v"][:, :NB] = T(pv)
    tc["page_table"] = T(table).long()
    if ring:
        ring_pos = np.full((S, R), -1, np.int32)
        rk = rng.randn(L, S, R, H, DH).astype(np.float32)
        rv = rng.randn(L, S, R, H, DH).astype(np.float32)
        for c in range(fill):       # distinct rows on allocated pages
            ring_pos[0, c] = 4 + c
            ring_pos[2, c] = 9 + c if c % 2 == 0 else -1
        jc.update(ring_pos=jnp.asarray(ring_pos), ring_k=jnp.asarray(rk),
                  ring_v=jnp.asarray(rv), ring_fill=jnp.int32(fill))
        tc.update(ring_pos=T(ring_pos).long(), ring_k=T(rk), ring_v=T(rv),
                  ring_fill=torch.tensor(fill))
    return jc, tc


def _same_pool(tc, jc):
    eq(tc["pages_k"][:, :NB], jc["pages_k"])
    eq(tc["pages_v"][:, :NB], jc["pages_v"])


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_block_pool_hands_out_the_same_blocks(seed):
    rng = np.random.RandomState(seed)
    jp, tp = JP.BlockPool(16), TP.BlockPool(16)
    for _ in range(60):
        slot = int(rng.randint(0, 5))
        if rng.rand() < 0.6:
            n = int(rng.randint(0, 6))
            a, b = jp.alloc(slot, n), tp.alloc(slot, n)
            assert (a is None) == (b is None)
            if a is not None:
                eq(b, a)
        else:
            eq(tp.free_slot(slot), jp.free_slot(slot))
        assert tp.n_free == jp.n_free
        eq(tp.owner, jp.owner)
        for s in range(5):
            assert tp.held(s) == jp.held(s)
        tp.audit()


def test_block_pool_audit_catches_corruption():
    tp = TP.BlockPool(4)
    tp.alloc(0, 2)
    tp.refcount[0] += 1
    with pytest.raises(RuntimeError):
        tp.audit()


def test_geometry_and_addressing():
    jc, tc = _caches(0)
    assert TP.pool_rows(tc) == JP.pool_rows(jc) == NB * PS
    assert TP.view_len(tc) == JP.view_len(jc)
    assert TP.n_blocks(tc) == NB and TP.has_ring(tc)
    for rows in ([0, 3, 15], [-1, 7, 16], [11, 8, 19], [12, 20, 99]):
        r = np.asarray(rows, np.int32)
        eq(TP.logical_to_physical(tc, T(r)),
           JP.logical_to_physical(jc, jnp.asarray(r)))
    eq(TP.view_rows(tc), JP.view_rows(jc))
    eq(TP.kernel_blocks(tc), JP.kernel_blocks(jc))
    jplan, tplan = JP.step_plan(jc), TP.step_plan(tc)
    eq(tplan.view_ids, jplan.view_ids)
    eq(tplan.blocks, jplan.blocks)
    eq(tplan.allocated, jplan.allocated)
    assert tplan.blocks.dtype == torch.int32
    pos = np.array([9, 0, 15], np.int32)
    eq(TP.view_mask_from(tplan.allocated, T(pos).long()),
       JP.view_mask_from(jplan.allocated, jnp.asarray(pos)))
    eq(TP.view_mask(tc, T(pos).long()), JP.view_mask(jc, jnp.asarray(pos)))
    eq(TP.gather_view(tc["pages_k"][1], tplan.view_ids),
       JP.gather_view(jc["pages_k"][1], jplan.view_ids))


def test_scatter_token_drops_the_sentinel():
    jc, tc = _caches(1, ring=False)
    dest = np.array([5, NB * PS, 38], np.int32)    # middle one: sentinel
    tile = np.random.RandomState(0).randn(S, H, DH).astype(np.float32)
    want = JP.scatter_token(jc["pages_k"][0], jnp.asarray(dest),
                            jnp.asarray(tile))
    TP.scatter_token(tc["pages_k"][0], T(dest), T(tile))
    eq(tc["pages_k"][0, :NB], want)


@pytest.mark.parametrize("fill", [0, 2, 4])
def test_ring_bookkeeping(fill):
    jc, tc = _caches(2, fill=fill)
    eq(TP.ring_validity(tc), JP.ring_validity(jc))
    assert bool(TP.ring_full(tc)) == bool(JP.ring_full(jc))
    for pos in ([4, 0, 9], [0, 1, 2], [5, 5, 10]):
        p = np.asarray(pos, np.int32)
        assert bool(TP.ring_conflicts(tc, T(p).long())) == bool(
            JP.ring_conflicts(jc, jnp.asarray(p)))
    if fill == 4:
        return                        # full ring: nothing may be appended
    pos = np.array([10, 3, 14], np.int32)
    unload = np.array([True, False, True])
    vmask_j = JP.view_mask(jc, jnp.asarray(pos))
    vmask_t = TP.view_mask(tc, T(pos).long())
    jv, jr, jcur = JP.overlay_step_parts(jc, vmask_j, jnp.asarray(pos),
                                         jnp.asarray(unload))
    tv, tr, tcur = TP.overlay_step_parts(tc, vmask_t, T(pos).long(),
                                         T(unload))
    eq(tv, jv)
    eq(tr, jr)
    assert int(tcur) == int(jcur)
    tile = np.random.RandomState(3).randn(S, H, DH).astype(np.float32)
    eq(TP.stage_tile(tc["ring_k"][0], T(tile), tcur),
       JP.stage_tile(jc["ring_k"][0], jnp.asarray(tile), jcur))
    jc2 = JP.ring_commit(jc, jnp.asarray(pos), jnp.asarray(unload))
    tc2 = TP.ring_commit(tc, T(pos).long(), T(unload))
    eq(tc2["ring_pos"], jc2["ring_pos"])
    assert int(tc2["ring_fill"]) == int(jc2["ring_fill"])


@pytest.mark.parametrize("fill", [0, 1, 3, 4])
def test_drain_ring_matches_jax(fill):
    jc, tc = _caches(3, fill=fill)
    jd = JP.drain_ring(jc, use_kernel=False)
    td = TP.drain_ring(tc)
    _same_pool(td, jd)
    eq(td["ring_pos"], jd["ring_pos"])
    assert int(td["ring_fill"]) == int(jd["ring_fill"]) == 0
    sink = td["pages_k"][:, NB:]
    assert not sink.any(), "a drain never writes the sink block"


@pytest.mark.parametrize("fill,pos", [(2, [0, 0, 0]), (2, [4, 0, 0]),
                                      (4, [0, 0, 0]), (0, [1, 2, 3])])
def test_maybe_drain_gates_without_host_read(fill, pos):
    jc, tc = _caches(4, fill=fill)
    p = np.asarray(pos, np.int32)
    jd, jdue = JP.maybe_drain(jc, use_kernel=False,
                              incoming_pos=jnp.asarray(p))
    td, tdue = TP.maybe_drain(tc, incoming_pos=T(p).long())
    assert isinstance(tdue, torch.Tensor) and tdue.dtype == torch.bool
    assert bool(tdue) == bool(jdue)
    _same_pool(td, jd)
    eq(td["ring_pos"], jd["ring_pos"])
    assert int(td["ring_fill"]) == int(jd["ring_fill"])


def test_staged_pool_bytes_equal_direct_after_forced_drain():
    """The same token tiles written direct, or staged and then drained, leave
    the same pool bytes (the two paths are interchangeable)."""
    _, direct = _caches(5, ring=False)
    _, staged = _caches(5)
    rng = np.random.RandomState(6)
    for step in range(3):
        pos = torch.tensor([4 + step, 2 + step, 9 + step])
        active = torch.tensor([True, step != 1, True])
        tiles = [(T(rng.randn(S, H, DH).astype(np.float32)),
                  T(rng.randn(S, H, DH).astype(np.float32)))
                 for _ in range(L)]
        dest = TP.logical_to_physical(direct, torch.where(active, pos, -1))
        cur = staged["ring_fill"]
        for l, (k, v) in enumerate(tiles):
            TP.scatter_token(direct["pages_k"][l], dest, k)
            TP.scatter_token(direct["pages_v"][l], dest, v)
            TP.stage_tile(staged["ring_k"][l], k, cur)
            TP.stage_tile(staged["ring_v"][l], v, cur)
        TP.ring_commit(staged, pos, active)
    assert not torch.equal(staged["pages_k"], direct["pages_k"])
    TP.drain_ring(staged)
    assert torch.equal(staged["pages_k"][:, :NB], direct["pages_k"][:, :NB])
    assert torch.equal(staged["pages_v"][:, :NB], direct["pages_v"][:, :NB])
