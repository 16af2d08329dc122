"""The port's two kernels on the CPU: each wrapper runs its plain PyTorch
version there, held against the JAX package's oracle (``kernels/ref.py``) and
against the Pallas kernel in interpret mode, on the same numpy inputs.
``staged_scatter`` is a copy: exact. ``flash_decode_paged``: atol 2e-6, rtol
1e-4, the bound of the JAX package's own kernel-vs-oracle test (fp32, sums in
another order). The CUDA kernels themselves are held against the same plain
versions on the GPU by ``chip_smoke.py``, over the same case list."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_paged as pallas_paged
from repro.kernels.staged_scatter import staged_scatter as pallas_scatter
from repro_torch import kernels as K

torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# staged_scatter
# ---------------------------------------------------------------------------

def _scatter_inputs(seed, r, w, n, kind, dtype=np.float32):
    rng = np.random.RandomState(seed)
    dest = rng.randn(r, w).astype(dtype)
    staging = rng.randn(n, w).astype(dtype)
    rows = rng.permutation(r)[:n].astype(np.int32)   # unique destinations
    valid = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
             "mixed": rng.rand(n) > 0.4}[kind]
    return dest, staging, rows, valid


SCATTER_CASES = [(r, w, n, kind)
                 for (r, w, n) in ((64, 256, 16), (40, 24, 9), (33, 7, 12))
                 for kind in ("none", "all", "mixed")]


@pytest.mark.parametrize("r,w,n,kind", SCATTER_CASES)
def test_staged_scatter_matches_jax_oracle(r, w, n, kind):
    dest, staging, rows, valid = _scatter_inputs(r + n, r, w, n, kind)
    want = np.asarray(jref.staged_scatter_ref(
        jnp.asarray(dest), jnp.asarray(staging), jnp.asarray(rows),
        jnp.asarray(valid)))
    t = [torch.from_numpy(a.copy()) for a in (dest, staging, rows, valid)]
    got_ref = K.staged_scatter_ref(*t)
    np.testing.assert_array_equal(got_ref.numpy(), want)
    assert torch.equal(t[0], torch.from_numpy(dest)), "ref must not mutate"
    got = K.staged_scatter(*t)          # the wrapper is in place
    assert got.data_ptr() == t[0].data_ptr()
    np.testing.assert_array_equal(t[0].numpy(), want)


@pytest.mark.parametrize("kind", ["none", "all", "mixed"])
def test_staged_scatter_matches_pallas_interpret(kind):
    dest, staging, rows, valid = _scatter_inputs(5, 48, 128, 12, kind)
    want = np.asarray(pallas_scatter(
        jnp.asarray(dest), jnp.asarray(staging), jnp.asarray(rows),
        jnp.asarray(valid), interpret=True))
    got = K.staged_scatter_ref(*[torch.from_numpy(a) for a in
                                 (dest, staging, rows, valid)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_staged_scatter_bf16_and_out_of_range_rows():
    dest, staging, rows, valid = _scatter_inputs(2, 20, 16, 8, "all")
    rows = rows.copy()
    rows[0], rows[1] = 20, -1            # out of range: dropped
    d = torch.from_numpy(dest).to(torch.bfloat16)
    s = torch.from_numpy(staging).to(torch.bfloat16)
    out = K.staged_scatter_ref(d, s, torch.from_numpy(rows),
                               torch.from_numpy(valid))
    want = d.clone()
    for i in range(2, 8):
        want[rows[i]] = s[i]
    assert torch.equal(out, want)


def test_staged_scatter_layers_is_per_layer_scatter():
    rng = np.random.RandomState(3)
    store = torch.from_numpy(rng.randn(3, 24 + 4, 8).astype(np.float32))
    dest = store[:, :24]                 # layers strided apart (spare rows)
    staging = torch.from_numpy(rng.randn(3, 6, 8).astype(np.float32))
    rows = torch.from_numpy(rng.permutation(24)[:6])
    valid = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)
    want = torch.stack([K.staged_scatter_ref(dest[l], staging[l], rows, valid)
                        for l in range(3)])
    spare = store[:, 24:].clone()
    K.staged_scatter_layers(dest, staging, rows, valid)
    assert torch.equal(dest, want)
    assert torch.equal(store[:, 24:], spare)


def test_staged_scatter_rejects_bad_operands():
    d = torch.zeros(4, 8)
    s = torch.zeros(2, 8)
    rows, ok = torch.zeros(2, dtype=torch.int64), torch.ones(2, dtype=torch.bool)
    with pytest.raises(TypeError):
        K.staged_scatter(d, s.to(torch.bfloat16), rows, ok)
    with pytest.raises(ValueError):
        K.staged_scatter(torch.zeros(4, 16)[:, ::2], s, rows, ok)
    with pytest.raises(ValueError):
        K.staged_scatter(d, s, rows[:1], ok)
    with pytest.raises(TypeError):
        K.staged_scatter(d.double(), s.double(), rows, ok)


# ---------------------------------------------------------------------------
# flash_decode_paged
# ---------------------------------------------------------------------------

def _paged_inputs(seed, b, c, hq, hkv, d, nb, ps, p, r, ring_kind, hard):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, c, hq, d).astype(np.float32)
    pk = rng.randn(nb, ps, hkv, d).astype(np.float32)
    pv = rng.randn(nb, ps, hkv, d).astype(np.float32)
    blocks = rng.randint(0, nb, (b, p)).astype(np.int32)
    view_ok = rng.rand(b, c, p * ps) > 0.35
    ring = (None, None, None)
    if r:
        ring_ok = {"empty": np.zeros((b, r), bool),
                   "partial": np.broadcast_to(np.arange(r)[None] < r // 2,
                                              (b, r)).copy(),
                   "full": np.ones((b, r), bool)}[ring_kind]
        ring = (rng.randn(b, r, hkv, d).astype(np.float32),
                rng.randn(b, r, hkv, d).astype(np.float32), ring_ok)
    if hard:
        blocks[0] = 0                    # a dead slot: clamped page table,
        view_ok[0] = False               # nothing valid anywhere
        view_ok[-1, -1] = False          # and one all-masked query column
        if r:
            ring[2][0] = False
            ring[2][-1] = False
    return (q, pk, pv, blocks, view_ok) + ring


def _paged_shapes():
    shapes = []   # b, c, hq, hkv, d, nb, ps, p, r
    for d in (16, 64):
        for c in (1, 8):
            for (hq, hkv) in ((4, 4), (8, 2)):
                shapes.append((3, c, hq, hkv, d, 12, 4, 5, 6))
    shapes += [(2, 1, 8, 1, 128, 6, 8, 3, 4),
               (2, 3, 6, 3, 32, 9, 2, 6, 0),
               (2, 1, 4, 4, 64, 40, 16, 20, 8)]
    return shapes


PAGED_CASES = [(shp, kind, hard)
               for shp in _paged_shapes()
               for kind in (("empty", "partial", "full") if shp[-1]
                            else ("none",))
               for hard in (False, True)]


def _ids(case):
    shp, kind, hard = case
    return "-".join(map(str, shp)) + f"-{kind}" + ("-dead" if hard else "")


def _j(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _t(args):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in args]


@pytest.mark.parametrize("case", PAGED_CASES, ids=_ids)
def test_flash_decode_paged_matches_jax_oracle(case):
    shp, kind, hard = case
    args = _paged_inputs(sum(shp), *shp, kind, hard)
    want = np.asarray(jref.flash_decode_paged_ref(*_j(args)))
    got = K.flash_decode_paged(*_t(args))    # CPU tensor -> plain version
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if hard:   # all-masked rows: the uniform mean over EVERY row and lane
        b, c, hq, hkv, d, nb, ps, p, r = shp
        rows = (args[3][0][:, None] * ps + np.arange(ps)[None]).reshape(-1)
        v = args[2].reshape(-1, hkv, d)[rows]
        if r:
            v = np.concatenate([v, args[6][0]], 0)
        mean = np.repeat(v.mean(0), hq // hkv, axis=0)
        np.testing.assert_allclose(got.numpy()[0, 0], mean, atol=1e-5,
                                   rtol=1e-4)


PALLAS_CASES = [c for c in PAGED_CASES
                if c[0] in (_paged_shapes()[0], _paged_shapes()[3],
                            _paged_shapes()[6], _paged_shapes()[9])
                and c[1] in ("partial", "none")]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=_ids)
def test_flash_decode_paged_matches_pallas_interpret(case):
    shp, kind, hard = case
    args = _paged_inputs(sum(shp) + 1, *shp, kind, hard)
    want = np.asarray(pallas_paged(*_j(args), interpret=True))
    got = K.flash_decode_paged_ref(*_t(args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_decode_paged_bf16_casts_probabilities():
    """bf16: the softmax is fp32, the probabilities are cast to q.dtype
    before the weighted sum, and the output has q's dtype."""
    shp = (2, 1, 4, 2, 16, 8, 4, 4, 4)
    args = _paged_inputs(11, *shp, "partial", False)
    t = [a.to(torch.bfloat16) if a is not None and a.dtype == torch.float32
         else a for a in _t(args)]
    got = K.flash_decode_paged(*t)
    assert got.dtype == torch.bfloat16
    jargs = [a.astype(jnp.bfloat16) if a is not None
             and a.dtype == jnp.float32 else a for a in _j(args)]
    want = np.asarray(jref.flash_decode_paged_ref(*jargs).astype(jnp.float32))
    # one bf16 ulp (2^-8 relative) of room: the two frameworks round the
    # bf16 score product at different points
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3,
                               rtol=1.6e-2)


def test_flash_decode_paged_rejects_bad_operands():
    args = _t(_paged_inputs(1, 2, 1, 4, 2, 16, 8, 4, 4, 4, "full", False))
    bad = list(args)
    bad[4] = bad[4][:, :, :-1]
    with pytest.raises(ValueError):
        K.flash_decode_paged(*bad)
    bad = list(args)
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        K.flash_decode_paged(*bad)
    bad = list(args)
    bad[7] = None
    with pytest.raises(ValueError):
        K.flash_decode_paged(*bad)


def test_launch_counters_count_kernel_launches_only():
    """On the CPU the plain version runs and no launch is counted."""
    K.reset_launch_counts()
    args = _t(_paged_inputs(1, 2, 1, 4, 2, 16, 8, 4, 4, 4, "full", False))
    K.flash_decode_paged(*args)
    K.staged_scatter(torch.zeros(4, 8), torch.ones(2, 8),
                     torch.tensor([1, 2]), torch.tensor([True, True]))
    K.flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 1, 4, 8),
                      torch.zeros(1, 1, 4, 8))
    K.flash_decode(torch.zeros(1, 2, 8), torch.zeros(1, 4, 1, 8),
                   torch.zeros(1, 4, 1, 8), torch.ones(1, 4, dtype=torch.bool))
    counts = K.cms_update(torch.zeros(2, 8, dtype=torch.int32),
                          torch.arange(3))
    K.cms_query(counts, torch.arange(3))
    K.cms_update_query(counts, torch.zeros((), dtype=torch.int64),
                       torch.arange(3))
    from repro_torch.distributed import Mesh
    K.flash_decode_paged_sharded(Mesh([torch.device("cpu")] * 2, (2,),
                                      ("model",)), *args)
    K.lru_scan(torch.arange(5), torch.tensor([0, 1, 0, 1, 0]).bool())
    assert K.launch_counts() == {"staged_scatter": 0, "flash_decode_paged": 0,
                                 "flash_attention": 0, "flash_decode": 0,
                                 "cms_update": 0, "cms_query": 0,
                                 "cms_update_query": 0, "lru_scan": 0}
