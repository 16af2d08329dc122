"""The port's flat write engine against the JAX package, on the CPU: the uMTT,
the wrap-mode staging ring (slot assignment, append, record, drain
eligibility, the partial-row scatter, drop sentinels), ``HintPolicy`` and
``HysteresisPolicy``, and the slice as a whole: one numpy write stream
through JAX's and the port's ``RemoteWriteEngine`` for five decision planes
gives identical memory bits, telemetry and ring state after every batch.
Then ports of the sequential last-write-wins properties of
``tests/test_unload_engine.py``, and the device rule: state is made on the
card unless the caller passes ``device="cpu"``. All integer / boolean / copy
logic: parity is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decision as jdec
from repro.core import monitor as jmon
from repro.core import policy as jpol
from repro.core import ring as jring
from repro.core import staged_write as jsw
from repro.core import types as jtypes
from repro.core import umtt as jumtt
from repro.core import unload as jul
from repro_torch.core import decision as tdec
from repro_torch.core import monitor as tmon
from repro_torch.core import policy as tpol
from repro_torch.core import ring as tring
from repro_torch.core import simulator as tsim
from repro_torch.core import staged_write as tsw
from repro_torch.core import types as ttypes
from repro_torch.core import umtt as tumtt
from repro_torch.core import unload as tul

torch.set_num_threads(1)
CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _tables(cap, regs):
    """The same registrations in both uMTTs: regs = [(base, n, stag, perm)]."""
    jt, tt = jumtt.make_umtt(cap), tumtt.make_umtt(cap, device=CPU)
    for base, n, stag, perm in regs:
        jt = jumtt.register(jt, base, n, stag, perm)
        tt = tumtt.register(tt, base, n, stag, perm)
    return jt, tt


def _same_table(tt, jt):
    for a, b in zip(tt, jt):
        eq(a, b)


# ---------------------------------------------------------------------------
# uMTT
# ---------------------------------------------------------------------------

W_, R_ = jumtt.PERM_WRITE, jumtt.PERM_READ
UMTT_CASES = {
    "one": [(0, 10, 42, W_)],
    "several": [(0, 4, 1, W_), (100, 4, 2, W_), (50, 8, 3, R_ | W_)],
    "read-only": [(0, 4, 1, R_)],
    # a full table: the third registration writes nothing new
    "full": [(0, 4, 1, W_), (10, 4, 2, W_), (20, 4, 3, W_)],
}


@pytest.mark.parametrize("name", sorted(UMTT_CASES))
def test_umtt_matches_jax(name):
    cap = 2 if name == "full" else 8
    jt, tt = _tables(cap, UMTT_CASES[name])
    _same_table(tt, jt)
    assert int(tumtt.occupancy(tt)[0]) == int(jumtt.occupancy(jt)[0])
    rng = np.random.RandomState(len(name))
    region = rng.randint(-2, 110, 64).astype(np.int32)
    stag = rng.randint(0, 5, 64).astype(np.int32)
    for perm in (R_, W_):
        eq(tumtt.validate(tt, T(region), T(stag), perm),
           jumtt.validate(jt, jnp.asarray(region), jnp.asarray(stag), perm))
    jt, tt = jumtt.deregister(jt, 2), tumtt.deregister(tt, 2)
    _same_table(tt, jt)
    eq(tumtt.validate(tt, T(region), T(stag)),
       jumtt.validate(jt, jnp.asarray(region), jnp.asarray(stag)))


def test_umtt_range_stag_and_deregistration():
    _, t = _tables(8, [(0, 10, 42, W_)])
    assert tumtt.validate(t, torch.tensor([0, 9, 10]),
                          torch.tensor([42, 42, 42])).tolist() == [
        True, True, False]
    assert tumtt.validate(t, torch.tensor([5]),
                          torch.tensor([7])).tolist() == [False]
    t = tumtt.deregister(t, 42)
    assert tumtt.validate(t, torch.tensor([5]),
                          torch.tensor([42])).tolist() == [False]


# ---------------------------------------------------------------------------
# wrap-mode ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", [0, 5, 7])
@pytest.mark.parametrize("kind", ["none", "some", "all"])
def test_assign_and_append_match_jax(head, kind):
    rng = np.random.RandomState(head + len(kind))
    cap, n = 8, 6
    live = rng.rand(cap) > 0.6
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "some": rng.rand(n) > 0.5}[kind]
    js = jring.RingState(jnp.asarray(live), jnp.int32(head))
    ts = tring.RingState(T(live), torch.tensor(head))
    eq(tring.assign_slots(ts, T(mask)),
       jring.assign_slots(js, jnp.asarray(mask)))
    assert int(tring.free_slots(ts)) == int(jring.free_slots(js))
    for incoming in (1, 3, 6):
        assert bool(tring.need_drain(ts, incoming)) == bool(
            jring.need_drain(js, incoming))
    js, jslot = jring.append(js, jnp.asarray(mask))
    ts2, tslot = tring.append(ts, T(mask))
    assert ts2.live.data_ptr() == ts.live.data_ptr(), "append is in place"
    eq(tslot, jslot)
    eq(ts2.live, js.live)
    assert int(ts2.head) == int(js.head)


def test_record_drops_the_sentinel_lanes():
    """Lanes with the sentinel slot (cap) never land, also where no lane is
    kept at all and where a dropped lane's payload differs."""
    rng = np.random.RandomState(0)
    cap, n, w = 6, 5, 3
    for slots in ([6, 2, 6, 0, 6], [6, 6, 6, 6, 6], [1, 2, 3, 4, 5]):
        buf = rng.randn(cap, w).astype(np.float32)
        meta = rng.randint(0, 50, cap).astype(np.int32)
        vals = rng.randn(n, w).astype(np.float32)
        vmeta = rng.randint(50, 99, n).astype(np.int32)
        jb, jm = jring.record((jnp.asarray(buf), jnp.asarray(meta)),
                              jnp.asarray(slots),
                              (jnp.asarray(vals), jnp.asarray(vmeta)))
        tb, tm = T(buf), T(meta).long()
        tring.record((tb, tm), T(slots), (T(vals), T(vmeta)))
        eq(tb, jb)
        eq(tm, jm)


@pytest.mark.parametrize("seed", range(4))
def test_put_never_lands_a_dropped_lane(seed):
    """``put_`` against a sequential loop: kept lanes land, dropped lanes
    (whose indices may collide with kept ones, or be out of range) never
    do. Kept indices are unique."""
    rng = np.random.RandomState(seed)
    buf = rng.randn(10).astype(np.float32)
    idx = rng.permutation(10)[:7]
    keep = rng.rand(7) > 0.5
    idx = np.where(keep, idx, rng.randint(-3, 14, 7))
    vals = rng.randn(7).astype(np.float32)
    want = buf.copy()
    for i in range(7):
        if keep[i]:
            want[idx[i]] = vals[i]
    got = tring.put_(T(buf), T(idx), T(vals), T(keep))
    np.testing.assert_array_equal(got.numpy(), want)


def test_drain_mask_matches_jax():
    jt, tt = _tables(8, [(0, 6, 7, W_), (8, 2, 9, R_)])
    rng = np.random.RandomState(3)
    live = rng.rand(12) > 0.3
    region = rng.randint(0, 12, 12).astype(np.int32)
    stag = rng.choice([7, 9, 1], 12).astype(np.int32)
    jok, jrej = jring.drain_mask(
        jring.RingState(jnp.asarray(live), jnp.int32(0)), jt,
        jnp.asarray(region), jnp.asarray(stag))
    tok, trej = tring.drain_mask(tring.RingState(T(live), torch.tensor(0)),
                                 tt, T(region), T(stag))
    eq(tok, jok)
    assert int(trej) == int(jrej)


@pytest.mark.parametrize("seed", range(3))
def test_scatter_elems_matches_jax(seed):
    """Partial rows, dropped lanes and destinations past the end of memory
    (dropped by JAX's sentinel, and by the port)."""
    rng = np.random.RandomState(seed)
    mem = rng.randn(6, 8).astype(np.float32)
    n = 7
    pairs = rng.permutation(12)[:n]
    region = (pairs // 2).astype(np.int32)
    region[0] = 9                                     # past the end
    offset = ((pairs % 2) * 4).astype(np.int32)
    size = rng.randint(0, 5, n).astype(np.int32)
    ok = rng.rand(n) > 0.3
    payload = rng.randn(n, 4).astype(np.float32)
    want = jring.scatter_elems(jnp.asarray(mem), jnp.asarray(payload),
                               jnp.asarray(region), jnp.asarray(offset),
                               jnp.asarray(size), jnp.asarray(ok))
    tm = T(mem)
    got = tring.scatter_elems(tm, T(payload), T(region), T(offset), T(size),
                              T(ok))
    assert got.data_ptr() == tm.data_ptr(), "scatter_elems is in place"
    eq(got, want)


def test_reset_gate_keeps_the_cursor():
    live = torch.tensor([True, False, True])
    st = tring.RingState(live.clone(), torch.tensor(2))
    assert tring.reset(st, gate=torch.tensor(False)).live.tolist() == [
        True, False, True]
    st2 = tring.reset(st, gate=torch.tensor(True))
    assert not st2.live.any() and int(st2.head) == 2
    st3 = tring.reset(tring.RingState(live.clone(), torch.tensor(2)))
    assert not st3.live.any() and int(st3.head) == 2  # wrap: cursor stays


def test_flat_ring_append_drain_match_jax():
    jt, tt = _tables(8, [(0, 4, 7, W_)])
    jr, tr = jul.make_ring(4, 4), tul.make_ring(4, 4, device=CPU)
    pay = np.ones((3, 4), np.float32) * np.arange(1, 4)[:, None]
    args = (np.array([2, 3, 1]), np.zeros(3, np.int32), np.full(3, 4),
            np.array([7, 99, 7]))
    mask = np.array([True, True, False])
    jr, jslot = jul.append(jr, jnp.asarray(pay),
                           *(jnp.asarray(a, jnp.int32) for a in args),
                           jnp.asarray(mask))
    tr, tslot = tul.append(tr, T(pay), *(T(a) for a in args), T(mask))
    eq(tslot, jslot)
    for f in ("payload", "region", "offset", "size", "stag", "live"):
        eq(getattr(tr, f), getattr(jr, f))
    assert bool(tul.need_drain(tr, 3)) == bool(jul.need_drain(jr, 3))
    assert bool(tul.conflicts(tr, T([3]), T([0]))) == bool(
        jul.conflicts(jr, jnp.asarray([3]), jnp.asarray([0])))
    jr, jm, jrej = jul.drain(jr, jnp.zeros((4, 4)), jt)
    tr, tm, trej = tul.drain(tr, torch.zeros((4, 4)), tt)
    eq(tm, jm)
    assert int(trej) == int(jrej) == 1
    eq(tr.live, jr.live)
    assert int(tr.head) == int(jr.head) == 2


def test_gated_drain_does_nothing_when_not_due():
    _, tt = _tables(8, [(0, 4, 7, W_)])
    tr = tul.make_ring(4, 4, device=CPU)
    tr, _ = tul.append(tr, torch.ones((2, 4)), T([1, 2]), T([0, 0]),
                       T([4, 4]), T([7, 99]), T([True, True]))
    mem = torch.zeros((4, 4))
    tr, mem, rej = tul.drain(tr, mem, tt, gate=torch.tensor(False))
    assert int(rej) == 0 and not mem.any() and tr.live.sum() == 2
    tr, mem, rej = tul.drain(tr, mem, tt, gate=torch.tensor(True))
    assert int(rej) == 1 and mem[1].tolist() == [1.0] * 4 and not mem[2].any()
    assert not tr.live.any()


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def _jb(region, size=None, hint=None):
    return jtypes.make_write_batch(
        jnp.asarray(region, jnp.int32),
        size=None if size is None else jnp.asarray(size, jnp.int32),
        hint=None if hint is None else jnp.asarray(hint, jnp.int32))


def _tb(region, size=None, hint=None):
    return ttypes.make_write_batch(
        T(region), size=None if size is None else T(size),
        hint=None if hint is None else T(hint))


def test_hint_policy_matches_jax():
    rng = np.random.RandomState(1)
    region = rng.randint(0, 16, 12)
    size = rng.choice([16, 5000], 12)
    hint = rng.randint(0, 2, 12)
    hot = rng.rand(16) > 0.5
    for jp, tp in ((jpol.HintPolicy(), tpol.HintPolicy()),
                   (jpol.HintPolicy(hot_regions=jnp.asarray(hot)),
                    tpol.HintPolicy(hot_regions=T(hot)))):
        eq(tp.decide(None, _tb(region, size, hint)),
           jp.decide(None, _jb(region, size, hint)))


@pytest.mark.parametrize("k", [0, 2, 5])
def test_top_k_hot_table_matches_jax(k):
    counts = np.random.RandomState(k).permutation(9).astype(np.int32)
    eq(tpol.top_k_hot_table(T(counts), k),
       jpol.top_k_hot_table(jnp.asarray(counts), k))


def test_hysteresis_carries_last_decision_through_midband():
    mon = tmon.ExactMonitor(n_regions=8)
    pol = tpol.HysteresisPolicy(monitor=mon, lo=2, hi=6)
    st = pol.init_state(CPU)
    un, st = pol.route(st, _tb([3]))
    assert un.tolist() == [True]
    for count in (2, 3, 4, 5):
        un, st = pol.route(st, _tb([3]))
        assert int(mon.query(st.mon, torch.tensor([3]))[0]) == count
        assert un.tolist() == [True], count
    un, st = pol.route(st, _tb([3]))
    assert un.tolist() == [False]
    un, st = pol.route(st, _tb([3]))
    assert un.tolist() == [False]


def test_hysteresis_buckets_regions_beyond_table():
    """test_policy.py's case over a CMSMonitor: region 100 of a table of 8
    keeps its hysteresis in bucket 100 % 8, as in JAX."""
    jp = jpol.HysteresisPolicy(monitor=jmon.CMSMonitor(depth=2, log2_width=6),
                               lo=2, hi=5, n_regions=8)
    tp = tpol.HysteresisPolicy(monitor=tmon.CMSMonitor(depth=2, log2_width=6),
                               lo=2, hi=5, n_regions=8)
    js, ts = jp.init_state(), tp.init_state(CPU)
    for expect in (True, True, True, True, False):
        ju, js = jp.route(js, _jb([100]))
        tu, ts = tp.route(ts, _tb([100]))
        assert tu.tolist() == ju.tolist() == [expect]
        eq(ts.last_unload, js.last_unload)
        eq(ts.mon.counts, js.mon.counts)
    assert bool(ts.last_unload[100 % 8]) is False
    # read-only decide, from the whole state and from bare counters
    region = [100, 3, 108, 7]
    eq(tp.decide(ts, _tb(region)), jp.decide(js, _jb(region)))
    eq(tp.decide(ts.mon, _tb(region)), jp.decide(js.mon, _jb(region)))


def _planes(mod_pol, mod_mon, mod_dec, n_regions, cms=(3, 5), decay=0):
    """Five decision planes: always offload, always unload, frequency over
    an exact monitor, frequency and hysteresis over a count-min sketch."""
    ex = mod_mon.ExactMonitor(n_regions, decay_every=decay)
    cm = mod_mon.CMSMonitor(depth=cms[0], log2_width=cms[1],
                            decay_every=decay)
    D = mod_dec.DecisionModule
    return {
        "offload": D(policy=mod_pol.AlwaysOffload()),
        "unload": D(policy=mod_pol.AlwaysUnload()),
        "frequency-exact": D(policy=mod_pol.FrequencyPolicy(
            monitor=ex, threshold=3), monitor=ex),
        "frequency-cms": D(policy=mod_pol.FrequencyPolicy(
            monitor=cm, threshold=3), monitor=cm),
        "hysteresis-cms": D(policy=mod_pol.HysteresisPolicy(
            monitor=cm, lo=2, hi=4, n_regions=n_regions // 2)),
    }


@pytest.mark.parametrize("plane", ["frequency-cms", "hysteresis-cms",
                                   "frequency-exact"])
def test_decision_module_with_active_mask_matches_jax(plane):
    """Masked lanes update neither counters nor decision memory; unload
    masks, stats and the whole routing state equal JAX's per batch."""
    jd = _planes(jpol, jmon, jdec, 16, decay=11)[plane]
    td = _planes(tpol, tmon, tdec, 16, decay=11)[plane]
    js, ts = jd.init_state(), td.init_state(CPU)
    rng = np.random.RandomState(len(plane))
    universe = 16 if plane == "frequency-exact" else 40
    for _ in range(10):
        region = rng.randint(0, universe, 7)
        active = rng.rand(7) > 0.3
        ju, js, jst = jd(js, _jb(region), active=jnp.asarray(active))
        tu, ts, tst = td(ts, _tb(region), active=T(active))
        eq(tu, ju)
        assert [int(x) for x in tst] == [int(x) for x in jst]
        if plane == "hysteresis-cms":
            eq(ts.last_unload, js.last_unload)
            ts_mon, js_mon = ts.mon, js.mon
        else:
            ts_mon, js_mon = ts, js
        eq(ts_mon.counts, js_mon.counts)
        assert int(ts_mon.total) == int(js_mon.total)
    regions = np.array([1, 1, 5, 12], np.int32)
    ts, js = td.heat(ts, regions), jd.heat(js, regions)
    eq((ts.mon if plane == "hysteresis-cms" else ts).counts,
       (js.mon if plane == "hysteresis-cms" else js).counts)


@pytest.mark.parametrize("policy,path", [("hint", "adaptive"),
                                         ("hysteresis", "adaptive"),
                                         ("frequency", "adaptive")])
def test_from_names_matches_jax(policy, path):
    jd = jdec.DecisionModule.from_names(policy, path, n_regions=8,
                                        hot_threshold=3)
    td = tdec.DecisionModule.from_names(policy, path, n_regions=8,
                                        hot_threshold=3)
    assert type(td.policy).__name__ == type(jd.policy).__name__
    js, ts = jd.init_state(), td.init_state(CPU)
    rng = np.random.RandomState(2)
    for _ in range(6):
        region, hint = rng.randint(0, 8, 5), rng.randint(0, 2, 5)
        ju, js, _ = jd(js, _jb(region, hint=hint))
        tu, ts, _ = td(ts, _tb(region, hint=hint))
        eq(tu, ju)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

R, W, N, BATCHES, RING = 24, 8, 6, 12, 8
PLANES = ("offload", "unload", "frequency-exact", "frequency-cms",
          "hysteresis-cms")
REGS = [(0, 10, 7, W_), (10, 10, 8, W_)]  # regions 20..23 unregistered


def _stream():
    """Unique (region, offset) within a batch for half of the batches and
    repeated keys in the other half (last-wins suppression), lane-disjoint
    offsets, partial sizes, hot low regions so destinations repeat across
    batches (conflict drains), about 1 in 6 stags wrong."""
    rng = np.random.RandomState(11)
    out = []
    for b in range(BATCHES):
        if b % 2:
            pairs = rng.permutation(R * 2)[:N]
        else:
            pairs = rng.choice([0, 0, 1, 2, 3, *range(4, 16)], N)
        region = (pairs // 2).astype(np.int32)
        offset = ((pairs % 2) * 4).astype(np.int32)
        size = rng.randint(1, 5, N).astype(np.int32)
        stag = np.where(region < 10, 7, 8).astype(np.int32)
        stag = np.where(rng.rand(N) < 0.17, 99, stag).astype(np.int32)
        payload = rng.randn(N, W).astype(np.float32)
        out.append((region, offset, size, stag, payload))
    return out


def _snapshot(st, mem):
    return dict(mem=np.asarray(mem).copy(),
                live=np.asarray(st.ring.live).copy(),
                head=int(st.ring.head),
                payload=np.asarray(st.ring.payload).copy(),
                tel=(int(st.n_offloaded), int(st.n_unloaded),
                     int(st.n_rejected)))


@pytest.fixture(scope="module")
def jax_runs():
    """{plane: [snapshot after each batch, then after the flush]} from the
    JAX engine, one run per decision plane."""
    jt, _ = _tables(8, REGS)
    runs = {}
    for name, dm in _planes(jpol, jmon, jdec, R).items():
        eng = jsw.RemoteWriteEngine(decision=dm, ring_capacity=RING, width=W)
        st, mem = eng.init_state(jt), jnp.zeros((R, W))
        snaps = []
        for region, offset, size, stag, payload in _stream():
            batch = jtypes.make_write_batch(
                jnp.asarray(region), offset=jnp.asarray(offset),
                size=jnp.asarray(size))
            st, mem = eng.write(st, mem, batch, jnp.asarray(payload),
                                jnp.asarray(stag))
            snaps.append(_snapshot(st, mem))
        st, mem = eng.flush(st, mem)
        snaps.append(_snapshot(st, mem))
        runs[name] = snaps
    return runs


@pytest.mark.parametrize("plane", PLANES)
def test_engine_matches_jax_batch_by_batch(jax_runs, plane):
    _, tt = _tables(8, REGS)
    eng = tsw.RemoteWriteEngine(decision=_planes(tpol, tmon, tdec, R)[plane],
                                ring_capacity=RING, width=W)
    st, mem = eng.init_state(tt, device=CPU), torch.zeros((R, W))
    snaps = []
    for region, offset, size, stag, payload in _stream():
        batch = ttypes.make_write_batch(T(region), offset=T(offset),
                                        size=T(size))
        st, mem2 = eng.write(st, mem, batch, T(payload), T(stag))
        assert mem2.data_ptr() == mem.data_ptr(), "write is in place"
        snaps.append(_snapshot(st, mem))
    st, mem = eng.flush(st, mem)
    snaps.append(_snapshot(st, mem))
    want = jax_runs[plane]
    for i, (got, exp) in enumerate(zip(snaps, want)):
        for key in ("mem", "live", "payload"):
            np.testing.assert_array_equal(got[key], exp[key],
                                          err_msg=f"{plane} {key} {i}")
        assert got["head"] == exp["head"], (plane, i)
        assert got["tel"] == exp["tel"], (plane, i, got["tel"], exp["tel"])


def test_stream_crosses_every_path(jax_runs):
    """The stream exercises what it is meant to: rejects on the unload
    path, a mix of paths in the sketch engines, and identical memories
    where no write is rejected (the rejects of the unload path are exactly
    the writes whose stag is wrong)."""
    tel = {k: v[-1]["tel"] for k, v in jax_runs.items()}
    assert tel["unload"][2] > 0 and tel["offload"][2] == 0
    for name in ("frequency-cms", "hysteresis-cms", "frequency-exact"):
        assert tel[name][0] > 0 and tel[name][1] > 0, (name, tel[name])


# ---------------------------------------------------------------------------
# the sequential last-write-wins oracle (ports of test_unload_engine.py)
# ---------------------------------------------------------------------------

def _table(n_regions, cap=8):
    return tumtt.register(tumtt.make_umtt(cap, device=CPU), 0, n_regions,
                          stag=7)


def _engine(policy, monitor=None, ring=32, width=8):
    return tsw.RemoteWriteEngine(
        decision=tdec.DecisionModule(policy=policy, monitor=monitor),
        ring_capacity=ring, width=width)


def _py_oracle(shape, writes):
    ref = np.zeros(shape, np.float32)
    for region, offset, size, ok, payload in writes:
        if ok:
            ref[region, offset:offset + size] = payload[:size]
    return ref


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["offload", "unload", "adaptive",
                                  "adaptive-cms"])
def test_engine_parity_against_python_oracle(seed, mode):
    r, w = 32, 8
    mon = (tmon.CMSMonitor(depth=2, log2_width=4) if mode == "adaptive-cms"
           else tmon.ExactMonitor(n_regions=r))
    policy = {"offload": tpol.AlwaysOffload(), "unload": tpol.AlwaysUnload(),
              }.get(mode) or tpol.FrequencyPolicy(monitor=mon, threshold=3)
    eng = _engine(policy, mon if mode.startswith("adaptive") else None,
                  ring=16, width=w)
    state, mem = eng.init_state(_table(r), device=CPU), torch.zeros((r, w))
    rng = np.random.RandomState(seed)
    ref = np.zeros((r, w), np.float32)
    for _ in range(12):
        regions = rng.choice([0, 0, 1, *range(4, 16)], size=8)
        payload = rng.randn(8, w).astype(np.float32)
        batch = ttypes.make_write_batch(T(regions), size=torch.full((8,), w))
        state, mem = eng.write(state, mem, batch, T(payload),
                               torch.full((8,), 7))
        for i in range(8):
            ref[regions[i]] = payload[i]
    state, mem = eng.flush(state, mem)
    np.testing.assert_array_equal(mem.numpy(), ref)


def test_engine_rejects_bad_stag_on_unload_path():
    eng = _engine(tpol.AlwaysUnload(), ring=8, width=4)
    st = eng.init_state(_table(8), device=CPU)
    batch = ttypes.make_write_batch(T([3]), size=T([4]))
    st, mem = eng.write(st, torch.zeros((8, 4)), batch, torch.ones((1, 4)),
                        T([99]))
    st, mem = eng.flush(st, mem)
    assert int(st.n_rejected) == 1
    assert not mem.any()


def test_engine_telemetry_counts():
    mon = tmon.ExactMonitor(n_regions=8)
    eng = _engine(tpol.FrequencyPolicy(monitor=mon, threshold=100), mon,
                  width=4)
    st = eng.init_state(_table(8), device=CPU)
    batch = ttypes.make_write_batch(T([0, 1, 2]), size=torch.full((3,), 4))
    st, _ = eng.write(st, torch.zeros((8, 4)), batch, torch.zeros((3, 4)),
                      torch.full((3,), 7))
    assert int(st.n_unloaded) == 3 and int(st.n_offloaded) == 0


@pytest.mark.parametrize("seed", range(6))
def test_unload_path_bit_identical_to_direct_oracle(seed):
    """Ring wrap (capacity 8), conflict-forced drains, partial sizes,
    sub-region offsets, bad stags and unregistered regions (12..15)."""
    r, w, n = 16, 8, 6
    table = tumtt.register(tumtt.make_umtt(8, device=CPU), 0, 12, stag=7)
    eng = _engine(tpol.AlwaysUnload(), ring=8, width=w)
    state, mem = eng.init_state(table, device=CPU), torch.zeros((r, w))
    rng = np.random.RandomState(seed)
    writes = []
    for _ in range(10):
        pairs = rng.permutation(r * 2)[:n]
        regions, offsets = pairs // 2, (pairs % 2) * 4
        sizes = rng.randint(1, 5, size=n)
        stags = np.where(rng.rand(n) < 0.8, 7, 99)
        payload = rng.randn(n, w).astype(np.float32)
        batch = ttypes.make_write_batch(T(regions), offset=T(offsets),
                                        size=T(sizes))
        state, mem = eng.write(state, mem, batch, T(payload), T(stags))
        for i in range(n):
            ok = regions[i] < 12 and stags[i] == 7
            writes.append((regions[i], offsets[i], sizes[i], ok, payload[i]))
    state, mem = eng.flush(state, mem)
    np.testing.assert_array_equal(mem.numpy(), _py_oracle((r, w), writes))
    assert int(state.n_rejected) == sum(1 for x in writes if not x[3])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("monitor", ["exact", "cms"])
def test_adaptive_mix_bit_identical_to_direct_oracle(seed, monitor):
    r, w = 16, 4
    mon = (tmon.ExactMonitor(n_regions=r) if monitor == "exact"
           else tmon.CMSMonitor(depth=2, log2_width=3))
    eng = _engine(tpol.FrequencyPolicy(monitor=mon, threshold=4), mon,
                  ring=8, width=w)
    state, mem = eng.init_state(_table(r), device=CPU), torch.zeros((r, w))
    rng = np.random.RandomState(seed)
    writes = []
    for _ in range(10):
        regions = rng.permutation(np.concatenate(
            [np.arange(4), 4 + rng.permutation(r - 4)[:4]]))[:5]
        sizes = rng.randint(1, w + 1, size=5)
        payload = rng.randn(5, w).astype(np.float32)
        batch = ttypes.make_write_batch(T(regions), size=T(sizes))
        state, mem = eng.write(state, mem, batch, T(payload),
                               torch.full((5,), 7))
        for i in range(5):
            writes.append((regions[i], 0, sizes[i], True, payload[i]))
    state, mem = eng.flush(state, mem)
    np.testing.assert_array_equal(mem.numpy(), _py_oracle((r, w), writes))


def test_partial_write_sizes():
    eng = _engine(tpol.AlwaysOffload(), width=8)
    st = eng.init_state(_table(4), device=CPU)
    mem = torch.full((4, 8), -1.0)
    batch = ttypes.make_write_batch(T([1]), size=T([3]))
    st, mem = eng.write(st, mem, batch, torch.ones((1, 8)), T([7]))
    assert mem[1].tolist() == [1, 1, 1, -1, -1, -1, -1, -1]


# ---------------------------------------------------------------------------
# the workload generator and the device rule
# ---------------------------------------------------------------------------

def test_zipf_regions_match_jax():
    """The same uniforms give the same regions as JAX's inverse CDF."""
    u = np.random.RandomState(0).rand(5000).astype(np.float32)
    n_regions = 1 << 12
    ranks = jnp.arange(1, n_regions + 1, dtype=jnp.float32)
    cdf = jnp.cumsum(ranks ** -0.5)
    want = jnp.searchsorted(cdf / cdf[-1], jnp.asarray(u))
    got = tsim.zipf_regions(5000, n_regions, 0.5, u=T(u))
    eq(got, want)
    g = torch.Generator().manual_seed(0)
    r = tsim.zipf_regions(4096, n_regions, generator=g, device="cpu")
    assert r.min() >= 0 and r.max() < n_regions


def _no_device_makers():
    cms = tmon.CMSMonitor()
    return {
        "ExactMonitor.init": lambda: tmon.ExactMonitor(8).init(),
        "CMSMonitor.init": lambda: cms.init(),
        "DecisionModule.init_state": lambda: tdec.DecisionModule(
            policy=tpol.AlwaysOffload()).init_state(),
        "FrequencyPolicy.init_state": lambda: tpol.FrequencyPolicy(
            monitor=cms, threshold=2).init_state(),
        "HysteresisPolicy.init_state": lambda: tpol.HysteresisPolicy(
            monitor=cms, n_regions=8).init_state(),
        "make_umtt": lambda: tumtt.make_umtt(4),
        "zipf_regions": lambda: tsim.zipf_regions(8, 16),
        "make_ring": lambda: tul.make_ring(4, 2),
        "RemoteWriteEngine.init_state": lambda: _engine(
            tpol.AlwaysUnload()).init_state(_table(4)),
    }


@pytest.mark.parametrize("name", sorted(_no_device_makers()))
def test_state_defaults_to_the_card(monkeypatch, name):
    """With ``device`` left out, state goes to the card: without CUDA that
    raises and names ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _no_device_makers()[name]()
