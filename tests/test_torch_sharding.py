"""The serve half of ``repro_torch.distributed`` against the JAX package.

``ParallelConfig`` (fields, errors word for word, ``tensor``, ``tp``,
``enabled``), ``validate``'s mesh branch (the twins of
``tests/test_grouped_config.py``'s parallel cases), ``attention_scheme`` and
``serve_cache_pspec`` equal to JAX's on abstract meshes for the four ported
archs at tp 1 / 2 / 4 / 8, the mesh (virtual devices through
``REPRO_TORCH_VIRTUAL_DEVICES``, set with ``monkeypatch``; too few devices
raise), placed tensors, the per-shard writes, drains and block moves of the
paged cache against the unsharded cache, and the sharded plain K2 against
the unsharded one and JAX's Pallas kernel in interpret mode. CPU, exact
unless a tolerance is stated."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_abstract_mesh
from repro.configs import get_config as jget
from repro.core.paths import AttentionConfig as JaxAttentionConfig
from repro.core.paths import validate as jax_validate
from repro.distributed import ParallelConfig as JaxParallelConfig
from repro.distributed.sharding import attention_scheme as jax_scheme
from repro.distributed.sharding import serve_cache_pspec as jax_pspec
from repro.kernels.flash_decode import flash_decode_paged as jax_paged
from repro_torch import kernels as K
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.paths import AttentionConfig, ResolvedPlan, validate
from repro_torch.distributed import (VIRTUAL_DEVICES_ENV, Mesh,
                                     NamedSharding, ParallelConfig,
                                     ShardedTensor,
                                     attention_scheme, pieces, replicated,
                                     serve_cache_pspec, serve_cache_shardings)
from repro_torch.kvcache import paged as PG

torch.set_num_threads(1)
CPU = torch.device("cpu")
TPS = (1, 2, 4, 8)


def _cfg(**kw):
    base = dict(max_seq=64, device="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


def _jcfg(**kw):
    base = dict(max_seq=64)
    base.update(kw)
    return SimpleNamespace(**base)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# ParallelConfig (twins of tests/test_grouped_config.py:36-57)
# ---------------------------------------------------------------------------


def test_parallel_config_defaults_are_trivial():
    p = ParallelConfig()
    assert p.n_devices == 1 and p.tp == 1 and not p.enabled
    assert p.build_mesh() is None
    assert p.cache_shardings(None, {}) is None


def test_parallel_config_tensor_and_validation():
    p = ParallelConfig.tensor(4)
    assert p.mesh_shape == (4,) and p.axis_names == ("model",)
    assert p.tp == 4 and p.enabled
    with pytest.raises(ValueError, match="rank"):
        ParallelConfig(mesh_shape=(2, 2), axis_names=("model",))
    with pytest.raises(ValueError, match="duplicate"):
        ParallelConfig(mesh_shape=(2, 2), axis_names=("model", "model"))
    with pytest.raises(ValueError, match="unknown axis"):
        ParallelConfig(mesh_shape=(2,), axis_names=("tensor",))


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(2, 2), axis_names=("model",)),
    dict(mesh_shape=(2, 2), axis_names=("model", "model")),
    dict(mesh_shape=(2,), axis_names=("tensor",)),
    dict(mesh_shape=(0,), axis_names=("model",)),
    dict(mesh_shape=(2, 4), axis_names=("data", "model")),
    dict(mesh_shape=(3,), axis_names=("data",)),
])
def test_parallel_config_fields_and_errors_equal_jax(kw):
    got = _error(lambda: ParallelConfig(**kw))
    want = _error(lambda: JaxParallelConfig(**kw))
    assert got == want
    if got is None:
        t, j = ParallelConfig(**kw), JaxParallelConfig(**kw)
        assert (t.mesh_shape, t.axis_names, t.n_devices, t.tp, t.enabled) \
            == (j.mesh_shape, j.axis_names, j.n_devices, j.tp, j.enabled)


def test_parallel_config_too_few_devices_message_names_the_variable():
    # one CPU device: an 8-way mesh must fail and say how to get more
    with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
        ParallelConfig.tensor(8).build_mesh(devices=[CPU])
    with pytest.raises(ValueError, match="needs 8 devices"):
        ParallelConfig.tensor(8).build_mesh(device="cpu")


def test_build_mesh_virtual_devices(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    mesh = ParallelConfig.tensor(4).build_mesh(device="cpu")
    assert mesh.devices == (CPU,) * 4 and mesh.shape == {"model": 4}
    assert mesh.axis_names == ("model",) and mesh.lead == CPU
    with pytest.raises(ValueError, match="needs 16 devices"):
        ParallelConfig.tensor(16).build_mesh(device="cpu")   # never shrunk
    mesh2 = ParallelConfig((2, 2), ("data", "model")).build_mesh(
        device="cpu")
    assert [mesh2.coords(i) for i in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]


def test_build_mesh_starts_at_the_engines_card(monkeypatch):
    # several distinct cards: the mesh's lead is the engine's own card, so
    # the parameters, the decision plane and the joined reads share it
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(4)]
    mesh = ParallelConfig.tensor(4).build_mesh(device="cuda:1")
    assert mesh.devices == (cuda[1], cuda[2], cuda[3], cuda[0])
    assert ParallelConfig.tensor(2).build_mesh(device="cuda").devices == (
        cuda[2], cuda[3])
    with pytest.raises(ValueError, match="needs 8 devices"):
        ParallelConfig.tensor(8).build_mesh(device="cuda:0")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    assert ParallelConfig.tensor(4).build_mesh(
        device="cuda:3").devices == (cuda[3],) * 4
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 2 devices"):
        ParallelConfig.tensor(2).build_mesh(device="cuda")


# ---------------------------------------------------------------------------
# validate's mesh branch (twins of tests/test_grouped_config.py:186-210)
# ---------------------------------------------------------------------------


def test_validate_rejects_mesh_x_lanes():
    kw = dict(kv_layout="lanes")
    got = _error(lambda: validate(_cfg(parallel=ParallelConfig.tensor(2),
                                       **kw)))
    want = _error(lambda: jax_validate(_jcfg(
        parallel=JaxParallelConfig.tensor(2), **kw)))
    assert got == want and "kv_layout='lanes'" in got[1]


def test_validate_rejects_fused_x_indivisible_heads():
    got = _error(lambda: validate(
        _cfg(attention=AttentionConfig(impl="fused"),
             parallel=ParallelConfig.tensor(8)),
        n_heads=28, n_kv_heads=4, arch_name="qwen2-7b"))
    want = _error(lambda: jax_validate(
        _jcfg(attention=JaxAttentionConfig(impl="fused"),
              parallel=JaxParallelConfig.tensor(8)),
        n_heads=28, n_kv_heads=4, arch_name="qwen2-7b"))
    assert got == want and "Hq=28, Hkv=4" in got[1]


def test_validate_fused_divisible_heads_pass_head_check(monkeypatch):
    # Hq=8, Hkv=4, tp=2 divides both: the head check passes and the mesh
    # needs its devices. One device: both packages refuse; with virtual
    # devices the port resolves the plan
    cfg = dict(attention="fused", parallel=ParallelConfig.tensor(2))
    with pytest.raises(ValueError, match="needs 2 devices"):
        validate(_cfg(**cfg), n_heads=8, n_kv_heads=4)
    assert jax.device_count() == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        jax_validate(_jcfg(attention=JaxAttentionConfig(impl="fused"),
                           parallel=JaxParallelConfig.tensor(2)),
                     n_heads=8, n_kv_heads=4)
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    plan = validate(_cfg(attention=AttentionConfig(impl="fused"),
                         parallel=ParallelConfig.tensor(2)),
                    n_heads=8, n_kv_heads=4)
    assert isinstance(plan, ResolvedPlan)
    assert plan.attention == "fused" and plan.mesh is not None
    assert plan.parallel == ParallelConfig.tensor(2)
    assert plan.mesh.devices == (CPU, CPU)


def test_validate_trivial_spec_has_no_mesh():
    plan = validate(_cfg(path="adaptive"))
    assert plan.parallel == ParallelConfig() and plan.mesh is None


# ---------------------------------------------------------------------------
# the rules, against JAX's on abstract meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_scheme_and_serve_pspec_equal_jax(arch, reduced):
    tcfg, jcfg = get_config(arch), jget(arch)
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    h, dh = tcfg.n_kv_heads, tcfg.resolved_head_dim
    leaves = {"pages_k": (2, 17, 8, h, dh), "pages_v": (2, 17, 8, h, dh),
              "ring_k": (2, 4, 3, h, dh), "ring_v": (2, 4, 3, h, dh),
              "page_table": (4, 8), "ring_pos": (4, 3), "ring_fill": ()}
    for tp in TPS:
        jmesh = make_abstract_mesh((tp,), ("model",))
        tmesh = Mesh([CPU] * tp, (tp,), ("model",))
        assert attention_scheme(tcfg, tmesh) == jax_scheme(jcfg, jmesh)
        for name, shape in leaves.items():
            assert serve_cache_pspec(tcfg, tmesh, name, shape) == tuple(
                jax_pspec(jcfg, jmesh, name, shape)), (arch, tp, name)


def test_serve_cache_shardings_and_replicated():
    mesh = Mesh([CPU] * 2, (2,), ("model",))
    cache = PG.make_paged_kv(2, 6, 4, 2, 3, 4, 8, ring_size=3,
                             device="cpu", mesh=mesh)
    sh = serve_cache_shardings(None, mesh, cache)
    assert sh["pages_k"].spec == (None, None, None, "model", None)
    assert not sh["pages_k"].is_fully_replicated
    assert sh["page_table"].is_fully_replicated
    assert replicated(mesh).is_fully_replicated
    assert ParallelConfig.tensor(2).cache_shardings(
        None, cache, devices=[CPU, CPU])["ring_v"].spec == sh["ring_v"].spec


# ---------------------------------------------------------------------------
# placed tensors
# ---------------------------------------------------------------------------


def test_sharded_tensor_place_gather_and_layers():
    mesh = Mesh([CPU] * 4, (4,), ("model",))
    x = torch.randn(3, 5, 8, 2, generator=torch.Generator().manual_seed(0))
    st = ShardedTensor.place(x, NamedSharding(mesh,
                                              (None, None, "model", None)))
    assert st.shape == x.shape and st.dtype == x.dtype
    assert [tuple(p.shape) for p in st.shards] == [(3, 5, 2, 2)] * 4
    assert all(p.is_contiguous() for p in st.shards)
    assert torch.equal(st.gather(), x)
    assert torch.equal(st[1].gather(), x[1]) and st[1].shape == x[1].shape
    st.shards[0].zero_()             # pieces never alias the source
    assert x.abs().sum() > 0 and not torch.equal(st.gather(), x)
    rep = ShardedTensor.place(x, NamedSharding(mesh, (None,) * 4))
    assert rep.axis is None and len(rep.read_group()) == 1
    assert all(torch.equal(p, x) for p in rep.shards)
    assert len({p.data_ptr() for p in rep.shards}) == 4
    assert pieces(x) == (x,) and pieces(st) == st.shards


def test_sharded_tensor_splits_one_axis_only():
    # each MESH axis splits one tensor axis only (a train spec splits two
    # tensor axes, each over its own mesh axes: tests/test_torch_sharding_
    # train.py); naming one mesh axis twice raises
    mesh = Mesh([CPU] * 4, (2, 2), ("data", "model"))
    x = torch.zeros(2, 4)
    for spec in (("model", "model"), (("data", "model"), "data")):
        with pytest.raises(ValueError, match="one tensor axis"):
            ShardedTensor.place(x, NamedSharding(mesh, spec))
    z = ShardedTensor.zeros((3, 4), NamedSharding(mesh, (None, "model")),
                            torch.float32)
    assert [tuple(p.shape) for p in z.shards] == [(3, 2)] * 4
    assert z.shape == (3, 4) and z.sharding.spec == (None, "model")
    assert z[1].sharding.spec == ("model",) and z[1].axis == 0


def test_sharded_tensor_on_a_two_axis_mesh():
    mesh = Mesh([CPU] * 4, (2, 2), ("data", "model"))
    x = torch.arange(2 * 4 * 3.).reshape(2, 4, 3)
    st = ShardedTensor.place(x, NamedSharding(mesh, (None, "model", None)))
    # device (d, m) holds head slice m; a read takes the data-0 replicas
    assert [torch.equal(p, x[:, 2 * (i % 2):2 * (i % 2) + 2])
            for i, p in enumerate(st.shards)] == [True] * 4
    assert [i for i, _ in st.read_group()] == [0, 1]
    assert torch.equal(st.gather(), x)


# ---------------------------------------------------------------------------
# the paged cache under a mesh: every move equals the unsharded one
# ---------------------------------------------------------------------------

L_, NB, PS, S, MP, DH, R = 2, 9, 4, 3, 3, 8, 4


def _caches(h, tp):
    """An unsharded cache with random planes and its placed twin."""
    mesh = Mesh([CPU] * tp, (tp,), ("model",))
    base = PG.make_paged_kv(L_, NB, PS, S, MP, h, DH, ring_size=R,
                            device="cpu")
    gen = torch.Generator().manual_seed(tp * 10 + h)
    for name in ("pages_k", "pages_v", "ring_k", "ring_v"):
        base[name].copy_(torch.randn(base[name].shape, generator=gen))
    base["page_table"].copy_(torch.tensor([[0, 3, -1], [5, 1, 2],
                                           [4, -1, -1]]))
    base["ring_pos"].copy_(torch.tensor([[1, 2, -1, -1], [-1, 6, 7, -1],
                                         [0, -1, -1, -1]]))
    base["ring_fill"] = torch.tensor(3)
    placed = PG.make_paged_kv(L_, NB, PS, S, MP, h, DH, ring_size=R,
                              device="cpu", mesh=mesh)
    for name in ("pages_k", "pages_v", "ring_k", "ring_v"):
        spec = serve_cache_pspec(None, mesh, name, base[name].shape)
        placed[name] = ShardedTensor.place(base[name],
                                           NamedSharding(mesh, spec))
    for name in ("page_table", "ring_pos"):
        placed[name].copy_(base[name])
    placed["ring_fill"] = base["ring_fill"].clone()
    return base, placed, mesh


def _same(base, placed):
    for name in ("pages_k", "pages_v", "ring_k", "ring_v"):
        assert torch.equal(PG.whole(placed[name]), base[name]), name
        if placed[name].axis is None:   # every copy took every write
            assert all(torch.equal(p, base[name])
                       for p in placed[name].shards), name
    for name in ("page_table", "ring_pos", "ring_fill"):
        assert torch.equal(placed[name], base[name]), name


@pytest.mark.parametrize("h,tp", [(4, 2), (4, 4), (2, 4), (1, 2)])
def test_placed_cache_shapes_and_devices(h, tp):
    _, placed, mesh = _caches(h, tp)
    split = h % tp == 0
    for name in ("pages_k", "ring_v"):
        x = placed[name]
        assert x.shape == (placed[name].shards[0].shape[:3]
                           + (h,) + (DH,))
        assert len(x.shards) == tp
        for i, p in enumerate(x.shards):
            assert p.device == mesh.devices[i]
            assert p.shape[3] == (h // tp if split else h)
    assert PG.n_blocks(placed) == NB and PG.pool_rows(placed) == NB * PS
    assert PG.view_len(placed) == MP * PS
    assert isinstance(placed["page_table"], torch.Tensor)


@pytest.mark.parametrize("h,tp", [(4, 2), (4, 4), (2, 4), (1, 2)])
def test_placed_writes_and_drains_equal_unsharded(h, tp):
    base, placed, _ = _caches(h, tp)
    gen = torch.Generator().manual_seed(1)
    tile = torch.randn(S, h, DH, generator=gen)
    tiles = torch.randn(S, 2, h, DH, generator=gen)
    dest = torch.tensor([5, PG.pool_rows(base), 17])
    dest2 = torch.tensor([[3, 4], [30, 31], [PG.pool_rows(base)] * 2])
    cur = torch.tensor(3)
    for c in (base, placed):
        PG.scatter_token(c["pages_k"][1], dest, tile)
        PG.scatter_chunk(c["pages_v"][0], dest2, tiles)
        PG.stage_tile(c["ring_k"][0], tile, cur)
        PG.stage_tile(c["ring_v"][1], tile, cur)
        PG.scatter_prefill(c["pages_k"], torch.tensor([8, 9]),
                           torch.randn(L_, 2, h, DH,
                                       generator=torch.Generator()
                                       .manual_seed(2)))
    _same(base, placed)
    rows = torch.tensor([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]] * S)
    for side in (base, placed):
        view = PG.gather_view(side["pages_k"][0], rows)
        assert torch.equal(view, PG.gather_view(base["pages_k"][0], rows))
    gate = torch.tensor(False)
    for c in (base, placed):
        PG._drain(c, gate)                 # gated off: nothing moves
    _same(base, placed)
    K.reset_launch_counts()
    for c in (base, placed):
        PG.drain_ring(c)
    _same(base, placed)
    assert K.launch_counts()["staged_scatter"] == 0    # plain version here


@pytest.mark.parametrize("h,tp", [(4, 2), (4, 4), (1, 2)])
def test_placed_block_moves_keep_the_unsharded_layout(h, tp):
    base, placed, _ = _caches(h, tp)
    blocks = [5, 1, 2]
    hk, hv = PG.unload_blocks(base, blocks)
    sk, sv = PG.unload_blocks(placed, blocks)
    assert torch.equal(hk, sk) and torch.equal(hv, sv)
    assert sk.shape == (L_, 3, PS, h, DH)
    for c in (base, placed):
        PG.load_blocks(c, [7, 8, 0], hk, hv)
        PG.copy_block(c, 3, 6)
    _same(base, placed)


# ---------------------------------------------------------------------------
# the sharded read: plain K2 per shard against the unsharded one and JAX
# ---------------------------------------------------------------------------


def _jax_case_inputs():
    """The inputs of tests/test_sharded_serving.py:264-285."""
    rng = np.random.default_rng(0)
    b, c, hq, hkv, d, nb, ps, npg, r = 2, 1, 4, 2, 8, 6, 4, 3, 4
    q = rng.standard_normal((b, c, hq, d)).astype(np.float32)
    pk = rng.standard_normal((nb, ps, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((nb, ps, hkv, d)).astype(np.float32)
    blocks = rng.integers(0, nb, (b, npg)).astype(np.int32)
    ok = rng.random((b, c, npg * ps)) < 0.7
    rk = rng.standard_normal((b, r, hkv, d)).astype(np.float32)
    rv = rng.standard_normal((b, r, hkv, d)).astype(np.float32)
    rok = rng.random((b, r)) < 0.5
    ok[:, :, 0] = True
    return q, pk, pv, blocks, ok, rk, rv, rok


@pytest.mark.parametrize("placed", [False, True])
def test_sharded_plain_k2_matches_unsharded_and_jax(placed):
    args = _jax_case_inputs()
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    mesh = Mesh([CPU] * 2, (2,), ("model",))
    if placed:
        sh = NamedSharding(mesh, (None, None, "model", None))
        targs = tuple(ShardedTensor.place(t, sh) if i in (1, 2, 5, 6)
                      else t for i, t in enumerate(targs))
    K.reset_launch_counts()
    got = K.flash_decode_paged_sharded(mesh, *targs)
    plain = K.flash_decode_paged_sharded_ref(mesh, *targs)
    whole = K.flash_decode_paged_ref(*(torch.from_numpy(np.asarray(a))
                                       for a in args))
    assert torch.equal(got, plain) and torch.equal(got, whole)
    ref = np.asarray(jax_paged(*args, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=1e-4)
    assert K.launch_counts()["flash_decode_paged"] == 0
    with pytest.raises(ValueError, match="divide"):
        K.flash_decode_paged_sharded(
            mesh, torch.from_numpy(args[0][:, :, :3]),
            *(torch.from_numpy(np.asarray(a)) for a in args[1:]))


def test_sharded_k2_on_a_trivial_axis_is_k2():
    args = tuple(torch.from_numpy(np.asarray(a)) for a in _jax_case_inputs())
    mesh = Mesh([CPU], (1,), ("model",))
    assert torch.equal(K.flash_decode_paged_sharded(mesh, *args),
                       K.flash_decode_paged(*args))


@pytest.mark.parametrize("mesh_shape,axes", [((2,), ("data",)),
                                              ((2, 2), ("data", "model"))])
def test_sharded_k2_on_a_mesh_with_a_data_axis(mesh_shape, axes):
    # the planes as the serve rule places them on such a mesh: whole copies
    # where there is no model axis, head slices over "model" otherwise
    args = tuple(torch.from_numpy(np.asarray(a)) for a in _jax_case_inputs())
    mesh = Mesh([CPU] * int(np.prod(mesh_shape)), mesh_shape, axes)
    targs = tuple(
        ShardedTensor.place(t, NamedSharding(mesh, serve_cache_pspec(
            None, mesh, "pages_k", (1,) + tuple(t.shape))[1:]))
        if i in (1, 2, 5, 6) else t for i, t in enumerate(args))
    assert torch.equal(K.flash_decode_paged_sharded(mesh, *targs),
                       K.flash_decode_paged(*args))
