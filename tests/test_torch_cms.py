"""K5 ``cms_update``, K6 ``cms_query`` and the fused monitor step
``cms_update_query`` of the port on the CPU, where their wrappers run the
plain PyTorch versions, held bit for bit against the JAX package's oracle
(``kernels/ref.py``), its ``CMSMonitor.update`` then ``.query``, and its
Pallas kernels in interpret mode on the same numpy inputs; the port's
``CMSMonitor`` against the JAX one (masked, decaying, several batches); and
the decision module's fused and unfused monitor steps. All integer work:
exact. The CUDA kernels are held against the same plain versions on the
card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import seeds
from repro.core import decision as jdec
from repro.core import monitor as jmon
from repro.core import policy as jpol
from repro.core import types as jtypes
from repro.kernels import ref as jref
from repro.kernels.cms import cms_query as pallas_query
from repro.kernels.cms import cms_update as pallas_update
from repro_torch import kernels as K
from repro_torch.core import decision as tdec
from repro_torch.core import monitor as tmon
from repro_torch.core import policy as tpol
from repro_torch.core import types as ttypes
from repro_torch.kernels.cms import cms_hash

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _ids(seed, n, lo=0, hi=10 ** 6):
    return np.random.RandomState(seed).randint(lo, hi, n).astype(np.int32)


@pytest.mark.parametrize("row", range(4))
@pytest.mark.parametrize("k", [0, 1, 4, 12, 16, 30])
def test_hash_matches_jax(row, k):
    """The int64 multiply-shift equals JAX's uint32 one, negatives and
    k = 0 (a shift by 32, 0 in JAX) included."""
    ids = _ids(row + k, 4000, -2 ** 31, 2 ** 31 - 1)
    eq(cms_hash(T(ids), row, k), jref.cms_hash(jnp.asarray(ids), row, k))
    assert int(cms_hash(torch.tensor([-5]), 1, 1)[0]) == 0


# the cases of tests/test_kernels.py::test_cms_update_query_match_ref
@pytest.mark.parametrize("depth,log2w,n", [(4, 12, 512), (2, 10, 300),
                                           (3, 8, 64), (4, 12, 1000)])
def test_update_query_match_jax_and_pallas(depth, log2w, n):
    rng = np.random.RandomState(depth * n)
    counts = rng.randint(0, 5, (depth, 1 << log2w)).astype(np.int32)
    ids = rng.randint(0, 10 ** 6, n).astype(np.int32)
    up_r = jref.cms_update_ref(jnp.asarray(counts), jnp.asarray(ids))
    up_p = pallas_update(jnp.asarray(counts), jnp.asarray(ids),
                         interpret=True)
    tc = T(counts)
    got = K.cms_update(tc, T(ids))
    assert got.data_ptr() == tc.data_ptr(), "cms_update is in place"
    eq(got, up_r)
    eq(got, up_p)
    q_r = jref.cms_query_ref(up_r, jnp.asarray(ids))
    q = K.cms_query(got, T(ids))
    assert q.dtype == torch.int32
    eq(q, q_r)
    eq(q, pallas_query(up_p, jnp.asarray(ids), interpret=True))


@pytest.mark.parametrize("log2w", [0, 4])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_width_one_and_negative_ids(log2w, dtype):
    """k = 0 puts every id in bin 0; negative ids hash as their uint32
    bits; int64 ids count by their low 32 bits, as int32 ids do."""
    ids = np.array([-5, -1, -2 ** 31, 7, -5, 2 ** 31 - 1], np.int32)
    counts = np.zeros((4, 1 << log2w), np.int32)
    want = jref.cms_update_ref(jnp.asarray(counts), jnp.asarray(ids))
    got = K.cms_update(T(counts), T(ids).to(dtype))
    eq(got, want)
    eq(K.cms_query(got, T(ids).to(dtype)),
       jref.cms_query_ref(want, jnp.asarray(ids)))
    if log2w == 0:
        assert got[:, 0].tolist() == [len(ids)] * 4


@pytest.mark.parametrize("n", [0, 1, 255, 1000])
def test_masked_update_counts_only_unmasked_ids(n):
    """K5's mask is a per-id predicate: equal to the JAX oracle over the
    unmasked ids alone. n = 0 leaves the counts as they are."""
    rng = np.random.RandomState(n)
    counts = rng.randint(0, 3, (3, 1 << 8)).astype(np.int32)
    ids = rng.randint(-10 ** 6, 10 ** 6, n).astype(np.int32)
    mask = rng.rand(n) > 0.4
    want = jref.cms_update_ref(jnp.asarray(counts), jnp.asarray(ids[mask]))
    eq(K.cms_update(T(counts), T(ids), T(mask)), want)
    eq(K.cms_update_ref(T(counts), T(ids), T(mask)), want)


@pytest.mark.parametrize("n", [64, 256, 300, 1000])
def test_kernel_matches_oracle_and_monitor(n):
    """Port of test_cms_parity.py's first property: kernel == oracle ==
    CMSMonitor, over three seeds."""
    for seed in seeds(3):
        ids = _ids(seed, n, 0, 1 << 20)
        counts = np.zeros((4, 1 << 10), np.int32)
        up = K.cms_update(T(counts), T(ids))
        eq(up, jref.cms_update_ref(jnp.asarray(counts), jnp.asarray(ids)))
        mon = tmon.CMSMonitor(depth=4, log2_width=10)
        st = mon.update(mon.init(device="cpu"), T(ids))
        assert torch.equal(st.counts, up)
        assert torch.equal(mon.query(st, T(ids)), K.cms_query(up, T(ids)))


def test_sketch_equals_exact_counts_on_sparse_universe():
    for seed in seeds(3):
        ids = T(_ids(seed, 512, 0, 16))
        exact = tmon.ExactMonitor(n_regions=16)
        est_exact = exact.query(exact.update(exact.init(device="cpu"), ids),
                                torch.arange(16))
        counts = K.cms_update(torch.zeros((4, 1 << 12), dtype=torch.int32),
                              ids)
        est = K.cms_query(counts, torch.arange(16))
        assert est.tolist() == est_exact.tolist()


def test_cms_never_undercounts():
    for seed in seeds(3):
        ids = T(_ids(seed, 1024, 0, 1 << 16))
        counts = K.cms_update(torch.zeros((2, 1 << 6), dtype=torch.int32),
                              ids)
        est = K.cms_query(counts, ids)
        true = torch.bincount(ids.long(), minlength=1 << 16)[ids.long()]
        assert bool((est.long() >= true).all())


def test_colliding_ids_stack():
    """256 equal ids count 256; distinct ids that share a bucket of a
    narrow row stack there (found against the real hash)."""
    ids = torch.full((256,), 12345, dtype=torch.int32)
    counts = K.cms_update(torch.zeros((4, 1 << 10), dtype=torch.int32), ids)
    assert int(K.cms_query(counts, ids[:1])[0]) == 256
    eq(counts, jref.cms_update_ref(jnp.zeros((4, 1 << 10), jnp.int32),
                                   jnp.asarray(ids.numpy())))
    h = cms_hash(torch.arange(2048), 0, 4)
    bucket = torch.nonzero(h == h[0]).flatten()[:8]
    assert len(bucket) == 8
    counts = K.cms_update(torch.zeros((1, 16), dtype=torch.int32), bucket)
    assert int(counts[0, int(h[0])]) == 8


def test_wrappers_refuse_what_the_kernel_does_not_take():
    c = torch.zeros((4, 16), dtype=torch.int32)
    ids = torch.arange(5)
    with pytest.raises(TypeError, match="int32"):
        K.cms_update(c.long(), ids)
    with pytest.raises(ValueError, match="power of two"):
        K.cms_query(torch.zeros((2, 12), dtype=torch.int32), ids)
    with pytest.raises(ValueError, match="depth"):
        K.cms_update(torch.zeros((5, 16), dtype=torch.int32), ids)
    with pytest.raises(TypeError, match="ids"):
        K.cms_query(c, ids.float())
    with pytest.raises(TypeError, match="mask"):
        K.cms_update(c, ids, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("decay", [0, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_cms_monitor_matches_jax(decay, masked):
    """Several batches through both monitors, masked and decaying: counts,
    totals and estimates equal after every batch."""
    rng = np.random.RandomState(decay + masked)
    jm = jmon.CMSMonitor(depth=3, log2_width=5, decay_every=decay)
    tm = tmon.CMSMonitor(depth=3, log2_width=5, decay_every=decay)
    js, ts = jm.init(), tm.init(device="cpu")
    assert ts.counts.dtype == torch.int32
    for _ in range(8):
        ids = rng.randint(0, 200, 9).astype(np.int32)
        mask = (rng.rand(9) > 0.3) if masked else None
        js = jm.update(js, jnp.asarray(ids),
                       None if mask is None else jnp.asarray(mask))
        ts = tm.update(ts, T(ids), None if mask is None else T(mask))
        eq(ts.counts, js.counts)
        assert int(ts.total) == int(js.total)
        q = rng.randint(0, 200, 6).astype(np.int32)
        eq(tm.query(ts, T(q)), jm.query(js, jnp.asarray(q)))


@pytest.mark.parametrize("k", [0, 3, 10])
def test_calibrate_threshold_matches_jax(k):
    counts = np.random.RandomState(k).permutation(40).astype(np.int32)
    want = int(jmon.calibrate_threshold(jnp.asarray(counts), k))
    assert int(tmon.calibrate_threshold(T(counts), k)) == want


@pytest.mark.parametrize("k", [0, 3, 10])
def test_calibrate_threshold_matches_jax_on_a_sketch(k):
    """The 2-D counts of a sketch, where JAX caps k at the depth; and
    ``page_threshold``, which calls it."""
    counts = (np.random.RandomState(k).permutation(4 * 64).reshape(4, 64)
              .astype(np.int32))
    want = int(jmon.calibrate_threshold(jnp.asarray(counts), k))
    assert int(tmon.calibrate_threshold(T(counts), k)) == want
    want = int(jdec.page_threshold(jnp.asarray(counts), k))
    assert int(tdec.page_threshold(T(counts), k)) == want


# ---------------------------------------------------------------------------
# the fused monitor step, cms_update_query
# ---------------------------------------------------------------------------

# (depth, k, n per batch, decay_every): decay off, firing inside most
# batches (7 < n), and configured but never firing over the run (1000)
FUSED_CASES = [(1, 0, 9, 0), (2, 3, 9, 7), (3, 5, 9, 1000), (4, 6, 9, 7),
               (4, 2, 33, 7), (2, 6, 33, 0), (3, 1, 1, 7), (4, 4, 33, 1000)]


def _fused_batches(seed, n, n_batches=6, wide=False):
    """Per batch: int32 ids over the whole int32 range (negatives too) and
    a mask; with ``wide`` the port gets int64 ids past 2^32 whose low 32
    bits are the int32 ids JAX gets."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        ids = rng.randint(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        ids[: n // 2] %= 97          # repeats, so buckets stack
        j_ids = ids.astype(np.int32)
        t_ids = (ids + (3 << 32)) if wide else j_ids
        out.append((j_ids, T(t_ids), rng.rand(n) > 0.35))
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("depth,k,n,decay", FUSED_CASES)
def test_fused_step_matches_jax_monitor(depth, k, n, decay, masked, wide):
    """The wrapper (CPU: the plain version) and the plain version, batch
    after batch, against JAX's ``CMSMonitor.update`` then ``.query`` of the
    same ids: counts, total and every id's estimate (masked ids too)."""
    jm = jmon.CMSMonitor(depth=depth, log2_width=k, decay_every=decay)
    js = jm.init()
    counts = torch.zeros((depth, 1 << k), dtype=torch.int32)
    total = torch.zeros((), dtype=torch.int64)
    ref_counts, ref_total = counts.clone(), total.clone()
    fired = 0
    for j_ids, t_ids, mask in _fused_batches(depth * 31 + k, n, wide=wide):
        m = mask if masked else None
        before = int(js.total)
        js = jm.update(js, jnp.asarray(j_ids),
                       None if m is None else jnp.asarray(m))
        want = jm.query(js, jnp.asarray(j_ids))
        if decay and int(js.total) % decay < before % decay:
            fired += 1
        tm = None if m is None else T(m)
        got_c, total, est = K.cms_update_query(counts, total, t_ids, tm,
                                               decay)
        assert got_c.data_ptr() == counts.data_ptr(), "updated in place"
        ref_counts, ref_total, ref_est = K.cms_update_query_ref(
            ref_counts, ref_total, t_ids, tm, decay)
        for c, t, e in ((counts, total, est),
                        (ref_counts, ref_total, ref_est)):
            eq(c, js.counts)
            assert t.dtype == torch.int64 and t.dim() == 0
            assert int(t) == int(js.total)
            assert e.dtype == torch.int32
            eq(e, want)
    if decay == 7 and n > 1:
        assert fired > 0, "the decay never fired"
    if decay == 1000:
        assert fired == 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("depth,k,decay", [(4, 6, 7), (2, 4, 0), (3, 5, 50)])
def test_fused_step_matches_pallas(depth, k, decay, masked):
    """The same inputs through the Pallas ``cms_update`` (unmasked ids
    only: it takes no mask) and ``cms_query`` in interpret mode, with the
    total and the decay applied in jnp between them."""
    counts = np.zeros((depth, 1 << k), np.int32)
    j_counts, j_total = jnp.asarray(counts), 0
    t_counts, t_total = T(counts), torch.zeros((), dtype=torch.int64)
    for j_ids, t_ids, mask in _fused_batches(depth + k, 40, n_batches=3):
        keep = mask if masked else np.ones_like(mask)
        j_counts = pallas_update(j_counts, jnp.asarray(j_ids[keep]),
                                 interpret=True)
        before, j_total = j_total, j_total + int(keep.sum())
        if decay:
            j_counts = jnp.where(j_total % decay < before % decay,
                                 j_counts // 2, j_counts)
        want = pallas_query(j_counts, jnp.asarray(j_ids), interpret=True)
        _, t_total, est = K.cms_update_query(
            t_counts, t_total, t_ids, T(mask) if masked else None, decay)
        eq(t_counts, j_counts)
        assert int(t_total) == j_total
        eq(est, want)


def test_fused_step_empty_batch():
    """n = 0 keeps the counts and the total (a fresh tensor) as they are,
    halves nothing and estimates nothing."""
    counts = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    total = torch.tensor(6, dtype=torch.int64)
    c, t, e = K.cms_update_query(counts.clone(), total,
                                 torch.zeros(0, dtype=torch.int64), None, 7)
    assert torch.equal(c, counts) and int(t) == 6 and e.shape == (0,)
    assert t.data_ptr() != total.data_ptr()


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    c = torch.zeros((4, 16), dtype=torch.int32)
    tot = torch.zeros((), dtype=torch.int64)
    ids = torch.arange(5)
    with pytest.raises(TypeError, match="int32"):
        K.cms_update_query(c.long(), tot, ids)
    with pytest.raises(ValueError, match="power of two"):
        K.cms_update_query(torch.zeros((2, 12), dtype=torch.int32), tot, ids)
    with pytest.raises(ValueError, match="depth"):
        K.cms_update_query(torch.zeros((5, 16), dtype=torch.int32), tot, ids)
    with pytest.raises(ValueError, match="contiguous"):
        K.cms_update_query(torch.zeros((16, 4), dtype=torch.int32).t(), tot,
                           ids)
    with pytest.raises(TypeError, match="ids"):
        K.cms_update_query(c, tot, ids.float())
    with pytest.raises(TypeError, match="ids"):
        K.cms_update_query(c, tot, ids.reshape(5, 1))
    with pytest.raises(TypeError, match="mask"):
        K.cms_update_query(c, tot, ids, torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="mask"):
        K.cms_update_query(c, tot, ids, torch.ones(5, dtype=torch.int32))
    with pytest.raises(TypeError, match="total"):
        K.cms_update_query(c, tot.int(), ids)
    with pytest.raises(TypeError, match="total"):
        K.cms_update_query(c, tot.reshape(1), ids)
    with pytest.raises(ValueError, match="decay_every"):
        K.cms_update_query(c, tot, ids, None, -1)
    with pytest.raises(ValueError, match="device"):
        K.cms_update_query(c, tot, ids.to("meta"))
    with pytest.raises(ValueError, match="device"):
        K.cms_update_query(c, tot.to("meta"), ids)


@pytest.mark.parametrize("decay", [0, 7])
def test_monitor_observe_matches_update_then_query(decay):
    """Both monitors' ``observe`` equals their ``update`` then ``query`` of
    the same ids and JAX's, masked ids queried too."""
    rng = np.random.RandomState(decay)
    mons = [(tmon.CMSMonitor(depth=3, log2_width=5, decay_every=decay),
             jmon.CMSMonitor(depth=3, log2_width=5, decay_every=decay)),
            (tmon.ExactMonitor(64, decay_every=decay),
             jmon.ExactMonitor(64, decay_every=decay))]
    for tm, jm in mons:
        ts, js = tm.init(device="cpu"), jm.init()
        for _ in range(5):
            ids = rng.randint(0, 64, 11).astype(np.int32)
            mask = rng.rand(11) > 0.3
            plain = tm.update(tmon.MonitorState(ts.counts.clone(), ts.total),
                              T(ids), T(mask))
            ts, est = tm.observe(ts, T(ids), T(mask))
            js = jm.update(js, jnp.asarray(ids), jnp.asarray(mask))
            assert torch.equal(ts.counts, plain.counts)
            assert int(ts.total) == int(plain.total) == int(js.total)
            eq(ts.counts, js.counts)
            eq(est, jm.query(js, jnp.asarray(ids)))
            assert torch.equal(est, tm.query(ts, T(ids)))


def _spy(monkeypatch, cls):
    """Count ``cls``'s ``observe`` and ``update`` calls."""
    calls = {"observe": 0, "update": 0}
    for name in calls:
        orig = getattr(cls, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(cls, name, wrapped)
    return calls


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("active", [False, True])
def test_decision_module_fuses_only_its_own_monitor(monkeypatch, same,
                                                    active):
    """``DecisionModule`` with a frequency policy over a sketch: where the
    policy's monitor is the module's, one ``observe`` a batch (the fused
    step); where it is another (here: another decay), the module's
    ``update`` then the policy's own query. Both match JAX batch by
    batch: unload mask, stats, counts and total."""
    mod_mon = dict(depth=3, log2_width=5, decay_every=11)
    pol_mon = mod_mon if same else dict(mod_mon, decay_every=0)

    def make(mon_mod, pol_mod, dec_mod):
        return dec_mod.DecisionModule(
            policy=pol_mod.FrequencyPolicy(
                monitor=mon_mod.CMSMonitor(**pol_mon), threshold=3),
            monitor=mon_mod.CMSMonitor(**mod_mon))

    td, jd = make(tmon, tpol, tdec), make(jmon, jpol, jdec)
    calls = _spy(monkeypatch, tmon.CMSMonitor)
    ts, js = td.init_state(device="cpu"), jd.init_state()
    rng = np.random.RandomState(int(same) + 2 * int(active))
    steps = 8
    for _ in range(steps):
        region = rng.randint(0, 40, 7).astype(np.int32)
        size = rng.choice([16, 9000], 7).astype(np.int32)
        act = rng.rand(7) > 0.3 if active else None
        tu, ts, tst = td(ts, ttypes.make_write_batch(T(region), size=T(size)),
                         active=None if act is None else T(act))
        ju, js, jst = jd(js, jtypes.make_write_batch(
            jnp.asarray(region), size=jnp.asarray(size)),
            active=None if act is None else jnp.asarray(act))
        eq(tu, ju)
        assert [int(x) for x in tst] == [int(x) for x in jst]
        eq(ts.counts, js.counts)
        assert int(ts.total) == int(js.total)
    if same:
        assert calls == {"observe": steps, "update": 0}, calls
    else:
        assert calls == {"observe": 0, "update": steps}, calls


@pytest.mark.parametrize("n", [1, 63, 64, 255, 1000, 4096, 5000, 16384,
                               1 << 20])
def test_fused_grid_is_one_cluster_with_a_thread_an_id(n):
    """The fused launch's grid: one cluster of at most 16 blocks, a whole
    number of warps a block, one id a thread until 16 x 1024 ids; an engine
    batch of 4096 ids takes 16 blocks of 256."""
    from repro_torch.kernels.cms import fused_grid
    blocks, threads = fused_grid(n)
    assert 1 <= blocks <= 16 and 64 <= threads <= 1024 and threads % 32 == 0
    assert blocks * threads >= min(n, 16 * 1024)
    assert (blocks - 1) * threads < n
    if n == 4096:
        assert (blocks, threads) == (16, 256)
