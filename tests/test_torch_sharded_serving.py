"""Mesh-sharded serving in the port: the twins of
``tests/test_sharded_serving.py`` (all but the train-state test) on the CPU.

``EngineConfig(parallel=ParallelConfig.tensor(tp))`` over virtual devices
(``REPRO_TORCH_VIRTUAL_DEVICES=8``, set with ``monkeypatch``): the paged
pool and the staging ring split on the head axis, the decision plane whole
on the lead device. On the reduced stablelm-1.6b (Hq = Hkv = 4) and qwen2-7b
(4 / 1: its KV planes are whole copies at every tp), fp32, with the JAX
package's weights carried across as numpy, every sharded payload (streams,
per-request path counts, every counter) equals the port's unsharded engine
AND the JAX unsharded engine on the same weights, across the write paths,
tp 2 / 4 / 8, chunked prefill, the fused read, the prefix cache and the host
tier. One test runs the JAX package's own tp-2 engine in a child process
with two virtual XLA devices and holds the port's tp-2 payload to it."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic_requests as jax_requests
from repro.models.sampling import SamplingParams as JaxParams
from repro.serve import AttentionConfig as JaxAttentionConfig
from repro.serve import Engine as JaxEngine
from repro.serve import EngineConfig as JaxConfig
from repro.serve import MemoryConfig as JaxMemoryConfig
from repro.serve import build_model_and_params as jax_build
from repro_torch import kernels as K
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import synthetic_requests
from repro_torch.distributed import (VIRTUAL_DEVICES_ENV, ParallelConfig,
                                     ShardedTensor, serve_cache_pspec)
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 8, 7, 6, 5], [2, 4, 6]]
MAX_SEQ = 48
_MODELS, _JAX = {}, {}


@pytest.fixture(autouse=True)
def _virtual_devices(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")


def _models(arch):
    """(JAX model, JAX params, port model with the same weights): the JAX
    engine's own ``init_seed`` 0 weights."""
    if arch not in _MODELS:
        _, jmodel, jparams = jax_build(arch, MAX_SEQ, seed=0)
        tmodel = params_from_numpy(
            jax.tree.map(np.asarray, jparams),
            build_model(get_config(arch).reduced(), device="cpu"))
        _MODELS[arch] = (jmodel, jparams, tmodel)
    return _MODELS[arch]


def _shape(path="adaptive", chunked=False, n_slots=4, max_seq=MAX_SEQ,
           segment_len=4):
    return dict(max_seq=max_seq, n_slots=n_slots, segment_len=segment_len,
                page_size=4, ring_size=4, path=path, chunked=chunked,
                chunk_size=4)


def _serve(arch, tp, *, attention=None, max_tokens=10, **kw):
    eng = Engine.from_config(EngineConfig(
        **_shape(**kw), attention=attention, device="cpu",
        parallel=ParallelConfig.tensor(tp) if tp > 1 else None),
        _models(arch)[2])
    comps = eng.generate(list(PROMPTS), SamplingParams(max_tokens=max_tokens))
    return eng, comps


def _payload(eng, comps):
    return ([c.tokens.tolist() for c in comps],
            [c.path_counts for c in comps], dict(eng.stats))


def _jax_payload(arch, *, attention=None, max_tokens=10, **kw):
    """The JAX unsharded engine's payload on the same weights, its stats cut
    to the port's counters."""
    key = (arch, attention, max_tokens, tuple(sorted(kw.items())))
    if key not in _JAX:
        jmodel, jparams, _ = _models(arch)
        jattn = None if attention is None else JaxAttentionConfig(
            impl=attention)
        eng = JaxEngine.from_config(JaxConfig(**_shape(**kw),
                                              attention=jattn),
                                    jmodel, jparams)
        comps = eng.generate(list(PROMPTS), JaxParams(max_tokens=max_tokens))
        _JAX[key] = ([np.asarray(c.tokens).tolist() for c in comps],
                     [c.path_counts for c in comps], dict(eng.stats))
    return _JAX[key]


def _held(arch, tp, **kw):
    """The tp payload equals the port's unsharded one and JAX's."""
    got = _payload(*_serve(arch, tp, **kw))
    ref = _payload(*_serve(arch, 1, **kw))
    assert got == ref
    jtok, jpc, jst = _jax_payload(arch, **kw)
    assert got[0] == jtok and got[1] == jpc
    assert got[2] == {k: jst[k] for k in got[2]}
    return got


# ---------------------------------------------------------------------------
# bit-parity: sharded == unsharded (port and JAX) across the paged matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
@pytest.mark.parametrize("path", ["direct", "staged", "adaptive"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_bit_parity_write_modes(arch, path, tp):
    _held(arch, tp, path=path)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-7b"])
def test_sharded_bit_parity_chunked(arch):
    _held(arch, 4, chunked=True)


def test_sharded_bit_parity_indivisible_heads_fall_back_replicated():
    # tp=8 does not divide stablelm's reduced Hkv of 4: the pool replicates
    # (serve_cache_pspec's rule) and every copy takes every write
    eng, comps = _serve("stablelm-1.6b", 8)
    pool = eng.scheduler.cache["pages_k"]
    assert pool.axis is None and len(pool.shards) == 8
    assert all(torch.equal(p, pool.shards[0]) for p in pool.shards)
    _held("stablelm-1.6b", 8)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("chunked", [False, True])
def test_sharded_bit_parity_fused_attention(tp, chunked):
    # the head-sharded fused read: Hq = Hkv = 4 divide tp, so validate
    # admits attention='fused'; on the CPU each shard runs K2's plain
    # version and the heads are joined on the lead device
    K.reset_launch_counts()
    eng, _ = _serve("stablelm-1.6b", tp, attention="fused", max_tokens=6,
                    chunked=chunked)
    assert eng.attention == "fused"
    assert K.launch_counts()["flash_decode_paged"] == 0
    _held("stablelm-1.6b", tp, attention="fused", max_tokens=6,
          chunked=chunked)


@pytest.mark.parametrize("mesh_shape,axes", [((2,), ("data",)),
                                              ((2, 2), ("data", "model"))])
def test_sharded_bit_parity_fused_on_a_mesh_with_a_data_axis(mesh_shape,
                                                             axes):
    # a replica axis: on ("data",) there is no model axis, so the planes are
    # whole copies on both devices and the fused read runs once on the
    # lead's copy; on ("data", "model") the heads split over "model" and
    # each split is held twice, once per data coordinate
    par = ParallelConfig(mesh_shape, axes)
    eng = Engine.from_config(EngineConfig(
        **_shape(), attention="fused", device="cpu", parallel=par),
        _models("stablelm-1.6b")[2])
    got = _payload(eng, eng.generate(list(PROMPTS),
                                     SamplingParams(max_tokens=6)))
    pool = eng.scheduler.cache["pages_k"]
    assert eng.attention == "fused" and len(pool.shards) == par.n_devices
    assert pool.mesh_axis == ("model" if par.tp > 1 else None)
    assert pool.shards[0].shape[3] == pool.shape[3] // par.tp
    assert got == _payload(*_serve("stablelm-1.6b", 1, attention="fused",
                                   max_tokens=6))
    jtok, jpc, jst = _jax_payload("stablelm-1.6b", attention="fused",
                                  max_tokens=6)
    assert got[0] == jtok and got[1] == jpc
    assert got[2] == {k: jst[k] for k in got[2]}


def test_fused_attention_refused_on_indivisible_heads():
    with pytest.raises(ValueError, match="Hq=4, Hkv=1"):
        _serve("qwen2-7b", 2, attention="fused")


def _prefix_run(tp):
    cfg = EngineConfig(
        max_seq=32, n_slots=2, segment_len=2, page_size=4, ring_size=3,
        path="adaptive", chunked=True, chunk_size=3, device="cpu",
        memory=MemoryConfig(prefix_cache=True),
        parallel=ParallelConfig.tensor(tp) if tp > 1 else None)
    eng = Engine.from_config(cfg, _models("stablelm-1.6b")[2])

    def mk():
        return synthetic_requests(3, 8, 64, 5, seed=3, shared_prefix=8)
    cold = eng.serve(mk())
    eng.reset(keep_cache=True)
    warm = eng.serve(mk())
    assert all(np.array_equal(warm[r], cold[r]) for r in cold)
    return {r: v.tolist() for r, v in warm.items()}, dict(eng.stats)


def test_sharded_bit_parity_prefix_cache():
    # cold serve, warm restart over the kept (sharded) pool, the same queue
    # again: the warm pass HITS the prefix index and equals the unsharded
    # engine's and the JAX engine's same dance
    got_out, got_stats = _prefix_run(2)
    ref_out, ref_stats = _prefix_run(1)
    assert got_out == ref_out and got_stats == ref_stats
    assert got_stats["prefix_hit_rows"] > 0
    jmodel, jparams, _ = _models("stablelm-1.6b")
    jeng = JaxEngine.from_config(JaxConfig(
        max_seq=32, n_slots=2, segment_len=2, page_size=4, ring_size=3,
        path="adaptive", chunked=True, chunk_size=3,
        memory=JaxMemoryConfig(prefix_cache=True)), jmodel, jparams)

    def mk():
        return jax_requests(3, 8, 64, 5, seed=3, shared_prefix=8)
    jeng.serve(mk())
    jeng.reset(keep_cache=True)
    jwarm = jeng.serve(mk())
    assert got_out == {r: np.asarray(v).tolist() for r, v in jwarm.items()}
    assert got_stats == {k: jeng.stats[k] for k in got_stats}


def _host_run(tp):
    cfg = EngineConfig(
        max_seq=32, n_slots=4, segment_len=4, page_size=4, ring_size=3,
        path="adaptive", n_blocks=5, device="cpu",
        memory=MemoryConfig(host_tier=True),
        parallel=ParallelConfig.tensor(tp) if tp > 1 else None)
    eng = Engine.from_config(cfg, _models("stablelm-1.6b")[2])
    out = eng.serve(synthetic_requests(8, 8, 64, 9, seed=2))
    return {k: v.tolist() for k, v in out.items()}, dict(eng.stats)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_bit_parity_host_tier(tp):
    # 8 requests x 4 pages over a 5-block pool: parking must trigger
    got_out, got_stats = _host_run(tp)
    ref_out, ref_stats = _host_run(1)
    assert got_out == ref_out and got_stats == ref_stats
    assert got_stats["host_unloads"] > 0     # the tier actually engaged
    jmodel, jparams, _ = _models("stablelm-1.6b")
    jeng = JaxEngine.from_config(JaxConfig(
        max_seq=32, n_slots=4, segment_len=4, page_size=4, ring_size=3,
        path="adaptive", n_blocks=5,
        memory=JaxMemoryConfig(host_tier=True)), jmodel, jparams)
    jout = jeng.serve(jax_requests(8, 8, 64, 9, seed=2))
    assert got_out == {k: np.asarray(v).tolist() for k, v in jout.items()}
    assert got_stats == {k: jeng.stats[k] for k in got_stats}


# ---------------------------------------------------------------------------
# placement invariants: what is sharded, what stays whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_pool_and_ring_are_head_sharded_decision_plane_replicated(tp):
    eng, _ = _serve("stablelm-1.6b", tp, path="adaptive")
    sch = eng.scheduler
    cache, mesh = sch.cache, sch.mesh
    h = cache["pages_k"].shape[3]
    assert h % tp == 0 and mesh.devices == (torch.device("cpu"),) * tp
    for name in ("pages_k", "pages_v", "ring_k", "ring_v"):
        arr = cache[name]
        assert isinstance(arr, ShardedTensor) and arr.mesh_axis == "model"
        assert len(arr.shards) == tp
        for i, shard in enumerate(arr.shards):
            assert shard.shape[3] == h // tp, (name, shard.shape)
            assert shard.device == mesh.devices[i]
    for name in ("page_table", "ring_pos", "ring_fill"):
        arr = cache[name]
        assert isinstance(arr, torch.Tensor), name
        assert arr.device == mesh.lead


def test_per_shard_drain_volumes_sum_to_unsharded():
    # keep-the-unload-local: each shard drains exactly its own head slice,
    # per-shard drained volumes sum to the unsharded drain volume, the
    # drain COUNT telemetry is identical, and each drain is one K1 call per
    # device holding the K and V planes of every shard there (a virtual
    # mesh: one device, so as many calls as unsharded, with 2 x tp planes).
    # ring_size (4) < segment_len (8): full-ring drains fire inside the
    # segment
    import repro_torch.core.ring as R
    calls = []
    orig = R.scatter_rows_layers

    def spy(planes, rows, ok):
        assert all(d.device == rows.device == ok.device for d, _ in planes)
        calls.append([tuple(staging.shape) for _, staging in planes])
        return orig(planes, rows, ok)

    R.scatter_rows_layers = spy
    try:
        e1, _ = _serve("stablelm-1.6b", 1, path="staged", segment_len=8)
        n1 = len(calls)
        vol1 = sum(np.prod(s) for c in calls for s in c)
        e2, _ = _serve("stablelm-1.6b", 2, path="staged", segment_len=8)
    finally:
        R.scatter_rows_layers = orig
    sharded = calls[n1:]
    assert e1.stats["drains"] > 0
    assert e2.stats["drains"] == e1.stats["drains"]
    assert len(sharded) == n1
    assert all(len(c) == 2 for c in calls[:n1])
    assert all(len(c) == 2 * 2 for c in sharded)
    assert sum(np.prod(s) for c in sharded for s in c) == vol1
    l, s, r, h, dh = e1.scheduler.cache["ring_k"].shape
    ring = e2.scheduler.cache["ring_k"]
    shard_vols = [p.numel() for p in ring.shards]
    assert sum(shard_vols) == l * s * r * h * dh
    assert all(v == l * s * r * h * dh // 2 for v in shard_vols)


def test_telemetry_readback_is_on_the_lead():
    # the decision plane (monitor, slot state) is whole on the lead device,
    # where the segment-end readback reads it; the per-request write counts
    # it feeds are exactly the unsharded engine's
    eng, comps = _serve("stablelm-1.6b", 2, path="adaptive")
    sch = eng.scheduler
    leaves = [t for t in list(sch.mon_state) + list(sch.slots)
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device == sch.mesh.lead for t in leaves)
    _, ref_comps = _serve("stablelm-1.6b", 1, path="adaptive")
    assert [c.path_counts for c in comps] == \
        [c.path_counts for c in ref_comps]


def test_serve_cache_pspec_divisibility_rule():
    cfg = get_config("stablelm-1.6b").reduced()
    mesh = ParallelConfig.tensor(2).build_mesh(device="cpu")
    ps = serve_cache_pspec(cfg, mesh, "pages_k", (2, 16, 4, 4, 16))
    assert ps[3] == "model"
    ps = serve_cache_pspec(cfg, mesh, "pages_k", (2, 16, 4, 3, 16))
    assert ps[3] is None                       # indivisible: replicate
    ps = serve_cache_pspec(cfg, mesh, "page_table", (4, 8))
    assert all(a is None for a in ps)


def test_engine_plan_carries_the_parallel_config():
    eng, _ = _serve("stablelm-1.6b", 2)
    pc = ParallelConfig.tensor(2)
    assert eng.scheduler.plan.parallel == pc
    assert eng.scheduler.mesh.shape == {"model": 2}


# ---------------------------------------------------------------------------
# the head-sharded kernel wrapper
# ---------------------------------------------------------------------------


def test_flash_decode_paged_sharded_matches_unsharded():
    from repro_torch.distributed import Mesh
    mesh = Mesh([torch.device("cpu")] * 2, (2,), ("model",))
    rng = np.random.default_rng(0)
    b, c, hq, hkv, d, nb, ps, npg, r = 2, 1, 4, 2, 8, 6, 4, 3, 4
    t = torch.from_numpy
    q = t(rng.standard_normal((b, c, hq, d)).astype(np.float32))
    pk = t(rng.standard_normal((nb, ps, hkv, d)).astype(np.float32))
    pv = t(rng.standard_normal((nb, ps, hkv, d)).astype(np.float32))
    blocks = t(rng.integers(0, nb, (b, npg)).astype(np.int32))
    ok = rng.random((b, c, npg * ps)) < 0.7
    rk = t(rng.standard_normal((b, r, hkv, d)).astype(np.float32))
    rv = t(rng.standard_normal((b, r, hkv, d)).astype(np.float32))
    rok = t(rng.random((b, r)) < 0.5)
    ok[:, :, 0] = True
    ok = t(ok)
    ref = K.flash_decode_paged(q, pk, pv, blocks, ok, rk, rv, rok)
    got = K.flash_decode_paged_sharded(mesh, q, pk, pv, blocks, ok, rk, rv,
                                       rok)
    assert torch.equal(ref, got)
    with pytest.raises(ValueError, match="divide"):
        K.flash_decode_paged_sharded(mesh, q[:, :, :3], pk, pv, blocks, ok,
                                     rk, rv, rok)


# ---------------------------------------------------------------------------
# error surface
# ---------------------------------------------------------------------------


def test_mesh_x_lanes_rejected_at_engine_build():
    with pytest.raises(ValueError, match="kv_layout"):
        Engine.from_config(EngineConfig(
            arch="stablelm-1.6b", max_seq=32, kv_layout="lanes",
            device="cpu", parallel=ParallelConfig.tensor(2)))


def test_too_many_devices_rejected_at_engine_build(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
        Engine.from_config(EngineConfig(
            arch="stablelm-1.6b", max_seq=32, device="cpu",
            parallel=ParallelConfig.tensor(2)))


def test_warm_reset_keeps_sharded_cache():
    eng, _ = _serve("stablelm-1.6b", 2, path="adaptive")
    arr = eng.scheduler.cache["pages_k"]
    eng.reset(keep_cache=True)
    assert eng.scheduler.cache["pages_k"] is arr
    eng.reset()
    arr = eng.scheduler.cache["pages_k"]
    assert arr.shards[0].shape[3] == arr.shape[3] // 2


# ---------------------------------------------------------------------------
# the JAX package's own sharded engine
# ---------------------------------------------------------------------------

_CHILD = """
import json, sys
import numpy as np
from repro.distributed import ParallelConfig
from repro.models.sampling import SamplingParams
from repro.serve import Engine, EngineConfig
import jax
assert jax.device_count() == 2, jax.devices()
eng = Engine.from_config(EngineConfig(
    arch="stablelm-1.6b", max_seq=48, n_slots=4, segment_len=4, page_size=4,
    ring_size=4, path="adaptive", parallel=ParallelConfig.tensor(2)))
assert eng.scheduler.mesh is not None
prompts = json.loads(sys.argv[1])
comps = eng.generate(prompts, SamplingParams(max_tokens=10))
print(json.dumps([[np.asarray(c.tokens).tolist() for c in comps],
                  [c.path_counts for c in comps],
                  {k: int(v) for k, v in eng.stats.items()}]))
"""


def test_port_tp2_equals_the_jax_sharded_engine():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(PROMPTS)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    jtok, jpc, jst = json.loads(res.stdout.strip().splitlines()[-1])
    got = _payload(*_serve("stablelm-1.6b", 2, path="adaptive"))
    assert got[0] == jtok and got[1] == jpc
    assert got[2] == {k: jst[k] for k in got[2]}
