"""The drain (K1) as a table of planes and the sharded read (K2s) grouped by
device, against the JAX package. CPU, exact unless a tolerance is stated.

* ``staged_scatter_planes``' plain path (a table of ``(dest, staging)``
  planes over one routing list) against JAX's ``staged_scatter`` (the Pallas
  kernel in interpret mode) and ``ref.staged_scatter_ref`` plane by plane
  and layer by layer: int32 and int64 rows, sentinel and negative rows,
  all-dead and empty tables, fp32 and bf16, planes of differing width.
* ``device_groups``: which shards of a mesh axis share a device, in which
  order; on virtual CPU meshes of tp 1, 2 and 4 one group holds every shard
  and the read gets q whole and each shard's head slice; a forced grouping
  over several devices reads each group's q heads and joins the outputs in
  shard order.
* ``flash_decode_paged_sharded_ref`` on that grouping: exact against
  unsharded K2's plain version, and within the tolerance of
  ``tests/test_torch_sharding.py`` (atol 2e-6, rtol 1e-4) of JAX's
  ``flash_decode_paged_sharded`` in interpret mode, run at tp 1, 2 and 4 in
  a child process with four host devices."""
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.staged_scatter import staged_scatter as jax_scatter
from repro_torch import kernels as K
from repro_torch.distributed import Mesh, NamedSharding, ShardedTensor

# the module of K2 (the package exports the wrappers under its name)
FD = importlib.import_module("repro_torch.kernels.flash_decode")

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ---------------------------------------------------------------------------
# K1: a table of planes over one routing list
# ---------------------------------------------------------------------------

def _routing(rng, r, n, kind):
    """Rows (distinct) and the valid mask: ``mixed`` (in range, some
    valid), ``dead`` (none valid), ``sentinel`` (valid rows at ``r``, past
    ``r`` and negative among them)."""
    rows = rng.permutation(r)[:n].astype(np.int64)
    valid = rng.random(n) < 0.6
    if kind == "dead":
        valid[:] = False
    if kind == "sentinel":
        valid[:] = True
        rows[: min(3, n)] = [r, -1, r + 5][: min(3, n)]
    return rows, valid


def _planes(rng, widths, layers, r, n):
    out = []
    for w in widths:
        store = rng.standard_normal((layers, r + 3, w)).astype(np.float32)
        staging = rng.standard_normal((layers, n, w)).astype(np.float32)
        out.append((store, staging))
    return out


def _jax_want(store, staging, rows, valid, r, dtype):
    """Plane by plane and layer by layer: JAX's reference (a negative row
    marked dead: the port drops it, where the reference's index would wrap,
    ``test_negative_rows_are_dropped_where_the_jax_reference_wraps``) and,
    with every out-of-range entry marked dead (dropped either way), the
    Pallas kernel in interpret mode. Both must agree."""
    jd = JDT[dtype]
    in_range = (rows >= 0) & (rows < r)
    out = []
    for l in range(store.shape[0]):
        dest = jnp.asarray(store[l, :r]).astype(jd)
        st = jnp.asarray(staging[l]).astype(jd)
        a = jref.staged_scatter_ref(dest, st, jnp.asarray(rows, jnp.int32),
                                    jnp.asarray(valid & (rows >= 0)))
        b = jax_scatter(dest, st, jnp.asarray(np.clip(rows, 0, r - 1),
                                              jnp.int32),
                        jnp.asarray(valid & in_range), interpret=True)
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))
        out.append(np.asarray(a.astype(jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("widths", [(8,), (8, 24), (16, 8, 40)])
@pytest.mark.parametrize("kind", ["mixed", "dead", "sentinel"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_plane_table_plain_path_matches_jax(idx, dtype, kind, widths):
    rng = np.random.default_rng(len(widths) * 7 + len(kind))
    r, n, layers = 12, 6, 2
    rows, valid = _routing(rng, r, n, kind)
    planes = _planes(rng, widths, layers, r, n)
    stores = [torch.from_numpy(s).to(dtype) for s, _ in planes]
    table = [(st[:, :r], torch.from_numpy(sg).to(dtype))
             for st, (_, sg) in zip(stores, planes)]
    spare = [st[:, r:].clone() for st in stores]
    K.reset_launch_counts()
    K.staged_scatter_planes(table, torch.from_numpy(rows).to(idx),
                            torch.from_numpy(valid))
    assert K.launch_counts()["staged_scatter"] == 0      # plain version here
    for (store, staging), st, sp in zip(planes, stores, spare):
        want = _jax_want(store, staging, rows, valid, r, dtype)
        np.testing.assert_array_equal(st[:, :r].float().numpy(), want)
        assert torch.equal(st[:, r:], sp)


@pytest.mark.parametrize("row", [-1, -5])
def test_negative_rows_are_dropped_where_the_jax_reference_wraps(row):
    # a known difference on an input no caller makes (the sentinel is R):
    # the JAX reference's ``.at[row].set(mode="drop")`` normalises a
    # negative index first (row -1 lands on the last row); the port, and
    # its kernel, drop every row outside [0, R)
    dest = np.zeros((6, 4), np.float32)
    staging = np.ones((1, 4), np.float32)
    valid = np.ones(1, bool)
    port = torch.from_numpy(dest.copy())
    K.staged_scatter_planes([(port[None], torch.from_numpy(staging)[None])],
                            torch.tensor([row]), torch.from_numpy(valid))
    assert not port.any()
    jx = np.asarray(jref.staged_scatter_ref(
        jnp.asarray(dest), jnp.asarray(staging),
        jnp.asarray([row], jnp.int32), jnp.asarray(valid)))
    assert jx[row].all() and jx.sum() == 4


@pytest.mark.parametrize("what", ["no planes", "no entries"])
def test_empty_plane_tables_change_nothing(what):
    dest = torch.arange(24.0).view(1, 4, 6)
    before = dest.clone()
    if what == "no planes":
        K.staged_scatter_planes([], torch.zeros(2, dtype=torch.int64),
                                torch.ones(2, dtype=torch.bool))
    else:
        K.staged_scatter_planes([(dest, torch.zeros(1, 0, 6))],
                                torch.zeros(0, dtype=torch.int32),
                                torch.zeros(0, dtype=torch.bool))
    assert torch.equal(dest, before)


@pytest.mark.parametrize("single", ["staged_scatter", "staged_scatter_layers"])
def test_tables_of_one_are_the_single_plane_entries(single):
    rng = np.random.default_rng(5)
    rows, valid = _routing(rng, 10, 4, "sentinel")
    store = torch.from_numpy(rng.standard_normal((3, 10, 8)).astype(
        np.float32))
    staging = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(
        np.float32))
    a, b = store.clone(), store.clone()
    rows_t, valid_t = torch.from_numpy(rows), torch.from_numpy(valid)
    if single == "staged_scatter":
        K.staged_scatter(a[0], staging[0], rows_t, valid_t)
        K.staged_scatter_planes([(b[:1], staging[:1])], rows_t, valid_t)
    else:
        K.staged_scatter_layers(a, staging, rows_t, valid_t)
        K.staged_scatter_planes([(b, staging)], rows_t, valid_t)
    assert torch.equal(a, b)


def test_plane_table_refuses_planes_on_two_devices():
    dest = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="device"):
        K.staged_scatter_planes(
            [(dest, torch.zeros(1, 2, 8)),
             (torch.zeros(1, 4, 8, device="meta"),
              torch.zeros(1, 2, 8, device="meta"))],
            torch.zeros(2, dtype=torch.int64), torch.ones(2, dtype=torch.bool))


# ---------------------------------------------------------------------------
# K2s: the shards of a mesh axis grouped by device
# ---------------------------------------------------------------------------

def _cards(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("devices,shape,axes,want", [
    ([CPU], (1,), ("model",), [(CPU, [0])]),
    ([CPU] * 2, (2,), ("model",), [(CPU, [0, 1])]),
    ([CPU] * 4, (4,), ("model",), [(CPU, [0, 1, 2, 3])]),
    ([CPU] * 2, (2,), ("data",), [(CPU, [0])]),
    (_cards(0, 1, 2, 3), (4,), ("model",),
     [(torch.device("cuda", i), [i]) for i in range(4)]),
    (_cards(0, 1, 0, 1), (4,), ("model",),
     [(torch.device("cuda", 0), [0, 2]), (torch.device("cuda", 1), [1, 3])]),
    (_cards(1, 1, 0, 0), (4,), ("model",),
     [(torch.device("cuda", 1), [0, 1]), (torch.device("cuda", 0), [2, 3])]),
    (_cards(0, 1, 2, 3), (2, 2), ("data", "model"),
     [(torch.device("cuda", 0), [0]), (torch.device("cuda", 1), [1])]),
    (_cards(0, 1, 2, 3), (2, 2), ("model", "data"),
     [(torch.device("cuda", 0), [0]), (torch.device("cuda", 2), [1])]),
])
def test_device_groups(devices, shape, axes, want):
    assert FD.device_groups(Mesh(devices, shape, axes), "model") == want


def _read_inputs(seed, b, c, hq, hkv, d, nb, ps, npg, r):
    """K2's operands (numpy, float32), the cases of the JAX child too."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, hq, d)).astype(np.float32)
    pk = rng.standard_normal((nb, ps, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((nb, ps, hkv, d)).astype(np.float32)
    blocks = rng.integers(0, nb, (b, npg)).astype(np.int32)
    ok = rng.random((b, c, npg * ps)) < 0.7
    ok[:, :, 0] = True
    if not r:
        return [q, pk, pv, blocks, ok]
    rk = rng.standard_normal((b, r, hkv, d)).astype(np.float32)
    rv = rng.standard_normal((b, r, hkv, d)).astype(np.float32)
    rok = rng.random((b, r)) < 0.5
    return [q, pk, pv, blocks, ok, rk, rv, rok]


# (seed, b, c, hq, hkv, d, nb, ps, npg, r): MHA with the ring, GQA group 2
# at C = 3 without it, GQA group 2 with the ring
READ_CASES = [(0, 2, 1, 4, 4, 8, 6, 4, 3, 4),
              (1, 2, 3, 8, 4, 8, 7, 4, 3, 0),
              (2, 3, 1, 8, 4, 16, 8, 2, 4, 2)]
TPS = (1, 2, 4)

_CHILD = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.kernels.flash_decode import flash_decode_paged_sharded
assert jax.device_count() == 4, jax.devices()
exec(sys.argv[1])
out = {}
for case in json.loads(sys.argv[2]):
    args = _read_inputs(*case)
    for tp in (1, 2, 4):
        mesh = Mesh(np.array(jax.devices()[:tp]), ("model",))
        got = flash_decode_paged_sharded(mesh, *args, interpret=True)
        out[f"{case[0]}_{tp}"] = np.asarray(got)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's ``flash_decode_paged_sharded`` (Pallas in interpret mode under
    ``shard_map``) at tp 1, 2 and 4 on four host devices, per read case."""
    import inspect
    path = str(tmp_path_factory.mktemp("jax_k2s") / "out.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    src = "import numpy as np\n" + inspect.getsource(_read_inputs)
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, src, json.dumps(READ_CASES), path],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def _torch_read(case, mesh, placed):
    args = [torch.from_numpy(np.asarray(a)) for a in _read_inputs(*case)]
    if placed:
        sh = NamedSharding(mesh, (None, None, "model", None))
        args = [ShardedTensor.place(t, sh) if i in (1, 2, 5, 6) else t
                for i, t in enumerate(args)]
    return args


@pytest.mark.parametrize("placed", [True, False])
@pytest.mark.parametrize("tp", TPS)
def test_virtual_mesh_reads_q_whole_and_each_shards_heads(tp, placed):
    case = READ_CASES[2]
    mesh = Mesh([CPU] * tp, (tp,), ("model",))
    args = _torch_read(case, mesh, placed)
    whole = [torch.from_numpy(np.asarray(a)) for a in _read_inputs(*case)]
    calls = []

    def record(q, shards, blocks, view_ok, ring_ok):
        calls.append((q, shards, blocks, view_ok, ring_ok))
        return q
    FD._per_device(record, mesh, "model", *args)
    assert len(calls) == 1                      # one read a device
    q, shards, blocks, view_ok, ring_ok = calls[0]
    assert q.data_ptr() == args[0].data_ptr()   # q whole, not sliced
    assert blocks is args[3] and view_ok is args[4] and ring_ok is args[7]
    hs = whole[1].shape[2] // tp
    assert len(shards) == tp
    for j, planes in enumerate(shards):         # shard j: heads [j hs, ..)
        for x, w in zip(planes, (whole[1], whole[2], whole[5], whole[6])):
            assert torch.equal(x, w[..., j * hs:(j + 1) * hs, :])


@pytest.mark.parametrize("groups", [[[0, 2], [1, 3]], [[0, 1], [2, 3]],
                                    [[3], [2], [1], [0]]])
def test_several_devices_read_their_q_heads_and_join_in_shard_order(
        monkeypatch, groups):
    case = READ_CASES[2]
    mesh = Mesh([CPU] * 4, (4,), ("model",))
    args = _torch_read(case, mesh, True)
    monkeypatch.setattr(FD, "device_groups",
                        lambda mesh, axis: [(CPU, js) for js in groups])
    seen = []

    def read(q, shards, blocks, view_ok, ring_ok):
        seen.append(q.shape[2])
        return FD._plain_read(q, shards, blocks, view_ok, ring_ok)
    got = FD._per_device(read, mesh, "model", *args)
    hq = args[0].shape[2]
    assert seen == [len(js) * hq // 4 for js in groups]
    whole = [torch.from_numpy(np.asarray(a)) for a in _read_inputs(*case)]
    assert torch.equal(got, K.flash_decode_paged_ref(*whole))


@pytest.mark.parametrize("placed", [True, False])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", READ_CASES, ids=lambda c: f"case{c[0]}")
def test_sharded_plain_read_equals_unsharded_and_jax(jax_sharded, case, tp,
                                                     placed):
    mesh = Mesh([CPU] * tp, (tp,), ("model",))
    args = _torch_read(case, mesh, placed)
    whole = [torch.from_numpy(np.asarray(a)) for a in _read_inputs(*case)]
    plain = K.flash_decode_paged_sharded_ref(mesh, *args)
    assert torch.equal(plain, K.flash_decode_paged_ref(*whole))
    assert torch.equal(K.flash_decode_paged_sharded(mesh, *args), plain)
    np.testing.assert_allclose(plain.numpy(),
                               jax_sharded[f"{case[0]}_{tp}"],
                               atol=2e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# One rule for both kernels past one launch: K2s takes 16 head shards a
# launch and K1 32 planes, the K and V of the same 16 shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,hkv_s", [(1, 32), (4, 8), (16, 2), (17, 1),
                                            (32, 1), (33, 2)])
def test_shard_launches_take_at_most_max_shards_a_launch(n_shards, hkv_s):
    launches = FD.shard_launches(n_shards, hkv_s)
    assert len(launches) == -(-n_shards // FD.MAX_SHARDS)
    assert [lo for lo, _, _ in launches] == list(
        range(0, n_shards, FD.MAX_SHARDS))
    assert launches[-1][1] == n_shards
    for lo, hi, h0 in launches:
        assert 0 < hi - lo <= FD.MAX_SHARDS and h0 == lo * hkv_s
    ss = importlib.import_module("repro_torch.kernels.staged_scatter")
    assert ss.MAX_PLANES == 2 * FD.MAX_SHARDS


@pytest.mark.parametrize("tp", [16, 32])
def test_sharded_plain_read_past_one_launch_equals_unsharded(tp):
    # stablelm's 32 KV heads (one a shard at tp 32), GQA group 1, the ring
    case = (3, 2, 2, 32, 32, 8, 6, 4, 3, 2)
    mesh = Mesh([CPU] * tp, (tp,), ("model",))
    assert FD.device_groups(mesh) == [(CPU, list(range(tp)))]
    args = _torch_read(case, mesh, True)
    whole = [torch.from_numpy(np.asarray(a)) for a in _read_inputs(*case)]
    plain = K.flash_decode_paged_sharded_ref(mesh, *args)
    assert torch.equal(plain, K.flash_decode_paged_ref(*whole))
    assert torch.equal(K.flash_decode_paged_sharded(mesh, *args), plain)
