"""The port's write plane and decision plane against the JAX package, element
for element: ``core/ring.py`` functions, ``ExactMonitor``, the three default
policies, ``DecisionModule`` (with ``active=`` and phase tags), the write-path
and policy registries, and ``validate``'s loud errors for what is not ported
yet. All integer / boolean / copy logic: parity is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monitor as jmon
from repro.core import paths as jpaths
from repro.core import policy as jpolicy
from repro.core import ring as jring
from repro.core import types as jtypes
from repro.distributed import ParallelConfig as JaxParallelConfig
from repro.models.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import BatchConfig as JaxBatchConfig
from repro_torch.core import monitor as tmon
from repro_torch.core import paths as tpaths
from repro_torch.core import policy as tpolicy
from repro_torch.core import ring as tring
from repro_torch.core import types as ttypes
from repro_torch.distributed import VIRTUAL_DEVICES_ENV, ParallelConfig
from repro_torch.models.sampling import SamplingParams
from repro_torch.serve import EngineConfig
from repro_torch.serve.scheduler import BatchConfig

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", [0, 3, 6])
def test_dense_state_and_full(fill):
    rng = np.random.RandomState(fill)
    meta = rng.randint(-1, 20, (4, 6)).astype(np.int32)
    js = jring.dense_state(jnp.asarray(meta), jnp.int32(fill))
    ts = tring.dense_state(T(meta).long(), torch.tensor(fill))
    eq(ts.live, js.live)
    assert int(ts.head) == int(js.head)
    assert bool(tring.full(ts)) == bool(jring.full(js, wrap=False))
    assert int(tring.free_ahead(ts)) == int(jring.free_ahead(js))
    assert tring.capacity(ts) == jring.capacity(js)


@pytest.mark.parametrize("axis,shape", [(-1, (3, 5)), (1, (3, 5, 2, 4)),
                                        (0, (5, 3))])
@pytest.mark.parametrize("head", [0, 2, 4])
def test_push_column(axis, shape, head):
    rng = np.random.RandomState(head)
    buf = rng.randn(*shape).astype(np.float32)
    col_shape = list(shape)
    del col_shape[axis % len(shape)]
    col = rng.randn(*col_shape).astype(np.float32)
    want = jring.push_column(jnp.asarray(buf), jnp.int32(head),
                             jnp.asarray(col), axis=axis)
    tb = T(buf.copy())
    got = tring.push_column(tb, torch.tensor(head), T(col), axis=axis)
    assert got.data_ptr() == tb.data_ptr()      # in place
    eq(got, want)


@pytest.mark.parametrize("extra", [False, True])
def test_shadow_mask(extra):
    rng = np.random.RandomState(1)
    lanes, cap, width = 4, 6, 17
    live = rng.rand(lanes, cap) > 0.5
    rows = rng.randint(0, width, (lanes, cap)).astype(np.int32)
    ex = np.array([3, width, 16, width], np.int32) if extra else None
    want = jring.shadow_mask(jnp.asarray(live), jnp.asarray(rows), width,
                             None if ex is None else jnp.asarray(ex))
    got = tring.shadow_mask(T(live), T(rows), width,
                            None if ex is None else T(ex))
    eq(got, want)


def test_merge_lanes_and_conflicts():
    rng = np.random.RandomState(2)
    meta = rng.randint(-1, 9, (3, 5)).astype(np.int32)
    js = jring.dense_state(jnp.asarray(meta), jnp.int32(4))
    ts = tring.dense_state(T(meta).long(), torch.tensor(4))
    jr, jo = jring.merge_lanes(js, jnp.asarray(meta))
    tr, to = tring.merge_lanes(ts, T(meta))
    eq(tr, jr)
    eq(to, jo)
    for trial in range(12):
        inc = rng.randint(-1, 9, (3, 1)).astype(np.int32)
        want = bool(jring.conflicts(js, (jnp.asarray(meta),),
                                    (jnp.asarray(inc),)))
        got = bool(tring.conflicts(ts, (T(meta).long(),), (T(inc).long(),)))
        assert got == want, (trial, inc.ravel())


def test_scatter_rows_matches_jax_and_is_in_place():
    rng = np.random.RandomState(3)
    dest = rng.randn(12, 8).astype(np.float32)
    staging = rng.randn(5, 8).astype(np.float32)
    rows = np.array([3, 12, 0, 7, 11], np.int32)     # 12 = dropped sentinel
    ok = np.array([1, 1, 0, 1, 1], bool)
    want = jring.scatter_rows(jnp.asarray(dest), jnp.asarray(staging),
                              jnp.asarray(rows), jnp.asarray(ok))
    td = T(dest.copy())
    got = tring.scatter_rows(td, T(staging), T(rows), T(ok))
    assert got.data_ptr() == td.data_ptr()
    eq(got, want)


# ---------------------------------------------------------------------------
# monitor / policies / decision module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [0, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_exact_monitor(decay, masked):
    rng = np.random.RandomState(decay + masked)
    jm = jmon.ExactMonitor(16, decay_every=decay)
    tm = tmon.ExactMonitor(16, decay_every=decay)
    js, ts = jm.init(), tm.init(device="cpu")
    for _ in range(6):
        ids = rng.randint(0, 16, 7).astype(np.int32)   # repeated ids add up
        mask = (rng.rand(7) > 0.3) if masked else None
        js = jm.update(js, jnp.asarray(ids),
                       None if mask is None else jnp.asarray(mask))
        ts = tm.update(ts, T(ids), None if mask is None else T(mask))
        eq(ts.counts, js.counts)
        assert int(ts.total) == int(js.total)
    q = rng.randint(0, 16, 9).astype(np.int32)
    eq(tm.query(ts, T(q)), jm.query(js, jnp.asarray(q)))


def _decisions(path, n_regions=12, thr=3, steps=8, use_active=True,
               phases=False):
    """Run both DecisionModules over one random write stream."""
    rng = np.random.RandomState(len(path) + thr)
    _, jd = jpaths.build_decision(path, n_regions=n_regions,
                                  hot_threshold=thr)
    _, td = tpaths.build_decision(path, n_regions=n_regions,
                                  hot_threshold=thr)
    js, ts = jd.init_state(), td.init_state(device="cpu")
    out = []
    for _ in range(steps):
        region = rng.randint(0, n_regions, 6).astype(np.int32)
        active = (rng.rand(6) > 0.3) if use_active else None
        phase = rng.randint(0, 2, 6).astype(np.int32) if phases else None
        ju, js, jst = jd(js, jtypes.make_write_batch(
            jnp.asarray(region),
            phase=None if phase is None else jnp.asarray(phase)),
            active=None if active is None else jnp.asarray(active))
        tu, ts, tst = td(ts, ttypes.make_write_batch(
            T(region), phase=None if phase is None else T(phase)),
            active=None if active is None else T(active))
        out.append((tu, ju, tst, jst, ts, js))
    return out, (td, ts), (jd, js)


@pytest.mark.parametrize("path", ["direct", "staged", "adaptive"])
@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("phases", [False, True])
def test_decision_module_matches_jax(path, use_active, phases):
    out, _, _ = _decisions(path, use_active=use_active, phases=phases)
    for tu, ju, tst, jst, ts, js in out:
        eq(tu, ju)
        for a, b in zip(tst, jst):
            assert int(a) == int(b)
        if ts is not None:
            eq(ts.counts, js.counts)
            assert int(ts.total) == int(js.total)
        else:
            assert js is None


def test_decision_heat_matches_jax():
    _, (td, ts), (jd, js) = _decisions("adaptive")
    regions = np.array([1, 1, 4, 9, 9, 9], np.int32)
    ts = td.heat(ts, regions)
    js = jd.heat(js, regions)
    eq(ts.counts, js.counts)
    assert int(ts.total) == int(js.total)


def test_frequency_policy_rel_threshold():
    mon = tmon.ExactMonitor(8)
    pol = tpolicy.FrequencyPolicy(monitor=mon, rel=2.0)
    st = mon.update(mon.init(device="cpu"),
                    torch.tensor([0, 0, 0, 0, 1, 2, 3, 3]))
    batch = ttypes.make_write_batch(torch.tensor([0, 1, 3, 5]),
                                    size=torch.tensor([16, 16, 16, 9999]))
    # thr = int(2.0 * 8 / 8) = 2: unload iff count < 2 and the write is small
    eq(pol.decide(st, batch), np.array([False, True, False, False]))
    with pytest.raises(ValueError):
        tpolicy.FrequencyPolicy(monitor=mon).decide(st, batch)


def test_registries():
    assert tpaths.available_paths() == jpaths.available_paths()
    for name in tpaths.available_paths():
        t, j = tpaths.get_path(name), jpaths.get_path(name)
        assert repr(t) == repr(j)
    assert tpolicy.available_policies() == jpolicy.available_policies()
    with pytest.raises(ValueError, match="unknown write path"):
        tpaths.get_path("nope")
    with pytest.raises(ValueError, match="unknown policy"):
        tpolicy.get_policy_factory("nope")
    # hint and hysteresis are ported: their factories build what JAX's do
    for name in ("hint", "hysteresis"):
        t = tpolicy.get_policy_factory(name)(n_regions=8, hot_threshold=6)
        j = jpolicy.get_policy_factory(name)(n_regions=8, hot_threshold=6)
        assert type(t).__name__ == type(j).__name__
        for field in ("lo", "hi", "n_regions", "max_unload_size"):
            assert getattr(t, field, None) == getattr(j, field, None), field


@pytest.mark.parametrize("path,policy", [("direct", "always-unload"),
                                         ("staged", "always-offload"),
                                         ("direct", "frequency")])
def test_negotiate_rejects_like_jax(path, policy):
    with pytest.raises(ValueError):
        jpaths.build_decision(path, policy, n_regions=8)
    with pytest.raises(ValueError):
        tpaths.build_decision(path, policy, n_regions=8)


# ---------------------------------------------------------------------------
# resolve_attention / validate
# ---------------------------------------------------------------------------

def test_resolve_attention(monkeypatch):
    monkeypatch.delenv("REPRO_ATTENTION", raising=False)
    ra = tpaths.resolve_attention
    assert ra("auto", layout="paged", device="cpu") == "reference"
    assert ra("auto", layout="paged", device="cuda") == "fused"
    assert ra("fused", layout="paged", device="cpu") == "fused"
    assert ra("reference", layout="paged", device="cuda") == "reference"
    assert ra("auto", layout="lanes", device="cuda") == "reference"
    with pytest.raises(ValueError, match="needs the paged KV layout"):
        ra("fused", layout="lanes")
    with pytest.raises(ValueError, match="unknown attention"):
        ra("flash")
    monkeypatch.setenv("REPRO_ATTENTION", "fused")
    assert ra("auto", layout="paged", device="cpu") == "fused"


def test_validate_resolves_a_plan():
    plan = tpaths.validate(BatchConfig(max_seq=64, n_slots=3, page_size=8,
                                       path="adaptive", device="cpu"))
    jplan = jpaths.validate(__import__("repro.serve", fromlist=["x"])
                            .BatchConfig(max_seq=64, n_slots=3, page_size=8,
                                         path="adaptive"))
    assert (plan.layout, plan.n_blocks, plan.max_pages, plan.n_regions) == (
        jplan.layout, jplan.n_blocks, jplan.max_pages, jplan.n_regions)
    assert plan.path.name == "adaptive" and plan.attention == "reference"
    assert plan.device == torch.device("cpu")
    assert plan.sched.name == "fifo"


NOT_PORTED = {
    "chunked": dict(chunked=True),
    # the lanes layout's host-side chunked prefill
    "lanes": dict(kv_layout="lanes", chunked=True),
    "sched-priority": dict(sched="sched/priority"),
    "sched-deadline": dict(sched="sched/deadline"),
    "sched-preempt": dict(sched="sched/preempt"),
    # the prefix cache needs chunked prefill (``negotiate_memory``)
    "prefix-cache": dict(chunked=True,
                         memory=tpaths.MemoryConfig(prefix_cache=True)),
    "host-tier": dict(memory=tpaths.MemoryConfig(host_tier=True)),
    "parallel": dict(parallel=ParallelConfig.tensor(2)),
    "spec": dict(spec=tpaths.SpecConfig(enabled=True)),
    "drain-kernel": dict(attention=tpaths.AttentionConfig(drain_kernel=True)),
    "sampled": dict(default_params=SamplingParams(temperature=0.7)),
    "policy-hysteresis": dict(path="adaptive", policy="hysteresis"),
}
# once raised, now ported: validate resolves them as the JAX package does
NOW_PORTED = {"policy-hysteresis", "chunked", "lanes", "prefix-cache",
              "host-tier", "sched-priority", "sched-deadline",
              "sched-preempt", "sampled", "parallel", "spec"}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_validate_raises_on_unported_feature(name, monkeypatch):
    kw = dict(NOT_PORTED[name])
    if name == "parallel":
        # a 2-device mesh on one device: both packages refuse it alike;
        # over virtual devices the port resolves it, the rest of the plan
        # as JAX resolves the same config without the mesh
        monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
        cfg = EngineConfig(max_seq=32, device="cpu", **kw).batch_config()
        with pytest.raises(ValueError, match="needs 2 devices"):
            tpaths.validate(cfg)
        with pytest.raises(ValueError, match="needs 2 devices"):
            jpaths.validate(JaxBatchConfig(
                max_seq=32, parallel=JaxParallelConfig.tensor(2)))
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
        plan = tpaths.validate(cfg)
        jplan = jpaths.validate(JaxBatchConfig(max_seq=32))
        assert plan.parallel == ParallelConfig.tensor(2)
        assert plan.mesh.devices == (torch.device("cpu"),) * 2
        assert (plan.layout, plan.path.name, plan.n_regions) == (
            jplan.layout, jplan.path.name, jplan.n_regions)
        return
    if name == "spec":
        # both refuse a self-draft whose target arch is unknown alike, and
        # resolve it against the target's arch and vocabulary alike
        cfg = EngineConfig(max_seq=32, device="cpu", **kw).batch_config()
        jcfg = JaxBatchConfig(max_seq=32, spec=jpaths.SpecConfig(
            enabled=True))
        with pytest.raises(ValueError, match="draft_arch is unset"):
            tpaths.validate(cfg)
        with pytest.raises(ValueError, match="draft_arch is unset"):
            jpaths.validate(jcfg)
        plan = tpaths.validate(cfg, arch_name="stablelm-1.6b", vocab=256)
        jplan = jpaths.validate(jcfg, arch_name="stablelm-1.6b", vocab=256)
        assert (plan.spec.enabled, plan.spec.k) == (jplan.spec.enabled,
                                                     jplan.spec.k)
        assert (plan.draft_cfg.name, plan.draft_cfg.n_layers) == (
            jplan.draft_cfg.name, jplan.draft_cfg.n_layers)
        assert (plan.layout, plan.path.name, plan.n_regions) == (
            jplan.layout, jplan.path.name, jplan.n_regions)
        return
    if name == "sched-preempt":
        # preemption parks through the host tier: both refuse it without
        with pytest.raises(ValueError, match="host_tier"):
            tpaths.validate(EngineConfig(max_seq=32, device="cpu",
                                         **kw).batch_config())
        with pytest.raises(ValueError, match="host_tier"):
            jpaths.validate(JaxBatchConfig(max_seq=32, **kw))
        kw["memory"] = tpaths.MemoryConfig(host_tier=True)
    cfg = EngineConfig(max_seq=32, device="cpu", **kw)
    if name in NOW_PORTED:
        plan = tpaths.validate(cfg.batch_config())
        jkw = dict(kw)
        if "memory" in jkw:     # the JAX package's own MemoryConfig
            jkw["memory"] = jpaths.MemoryConfig(
                prefix_cache=jkw["memory"].prefix_cache,
                host_tier=jkw["memory"].host_tier)
        if "default_params" in jkw:  # and its own SamplingParams
            jkw["default_params"] = JaxSamplingParams(
                temperature=jkw["default_params"].temperature)
        jplan = jpaths.validate(JaxBatchConfig(max_seq=32, **jkw))
        assert plan.sched.name == jplan.sched.name
        t, j = plan.decision.policy, jplan.decision.policy
        assert type(t).__name__ == type(j).__name__
        assert (plan.layout, plan.path.name, plan.n_regions) == (
            jplan.layout, jplan.path.name, jplan.n_regions)
        assert (plan.memory.prefix_cache, plan.memory.host_tier) == (
            jplan.memory.prefix_cache, jplan.memory.host_tier)
        if name == "policy-hysteresis":
            assert (t.lo, t.hi, t.n_regions) == (j.lo, j.hi, j.n_regions)
            assert plan.decision.monitor is None
            assert jplan.decision.monitor is None
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tpaths.validate(cfg.batch_config())


@pytest.mark.parametrize("layout", ["paged", "lanes"])
def test_validate_checks_chunk_size(layout):
    kw = dict(max_seq=32, kv_layout=layout, chunked=True, chunk_size=0)
    with pytest.raises(ValueError, match="chunk_size must be >= 1"):
        tpaths.validate(BatchConfig(device="cpu", **kw))
    with pytest.raises(ValueError, match="chunk_size must be >= 1"):
        jpaths.validate(JaxBatchConfig(**kw))


def test_validate_rejects_unknown_layout_and_unpaged_model():
    with pytest.raises(ValueError, match="unknown kv_layout"):
        tpaths.validate(BatchConfig(max_seq=32, kv_layout="rows",
                                    device="cpu"))
    # an unpaged model resolves to the lanes layout, direct-only, one
    # region per (slot, page-sized span of its lane), as in the JAX package
    plan = tpaths.validate(BatchConfig(max_seq=32, device="cpu"),
                           paged_capable=False)
    jplan = jpaths.validate(JaxBatchConfig(max_seq=32), paged_capable=False)
    assert (plan.layout, plan.attention, plan.n_regions) == (
        jplan.layout, jplan.attention, jplan.n_regions) == (
        "lanes", "reference", 8 * 4)
    with pytest.raises(ValueError, match="direct-only"):
        tpaths.validate(BatchConfig(max_seq=32, path="staged", device="cpu"),
                        paged_capable=False)
    with pytest.raises(ValueError, match="needs kv_layout='lanes'"):
        tpaths.validate(BatchConfig(max_seq=32, kv_layout="paged",
                                    device="cpu"), paged_capable=False)
