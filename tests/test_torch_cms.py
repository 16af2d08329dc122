"""K5 ``cms_update`` and K6 ``cms_query`` of the port on the CPU, where their
wrappers run the plain PyTorch versions, held bit for bit against the JAX
package's oracle (``kernels/ref.py``) and its Pallas kernels in interpret
mode on the same numpy inputs; and the port's ``CMSMonitor`` against the JAX
one (masked, decaying, several batches). All integer work: exact. The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import seeds
from repro.core import decision as jdec
from repro.core import monitor as jmon
from repro.kernels import ref as jref
from repro.kernels.cms import cms_query as pallas_query
from repro.kernels.cms import cms_update as pallas_update
from repro_torch import kernels as K
from repro_torch.core import decision as tdec
from repro_torch.core import monitor as tmon
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
