"""The paper's Fig. 3 simulator of the port against the JAX package.

* The scan: ``kernels.lru_scan``'s plain version (what ``RDMASimulator.run``
  runs on a CPU tensor) against JAX's ``lax.scan`` over ``cache_access`` on
  the same regions and masks, with small caches (4 x 2 MTT, 2 x 4 TLB and
  others) so evictions and empty-way fills happen all the time: hit flags,
  ``mtt_hits``, ``n_offloaded``, ``n_unloaded`` and per-write
  ``latency_us`` EQUAL.
* ``sweep_point`` against JAX's for the same seed at 1, 2^12 and 2^20
  regions, for AlwaysOffload / AlwaysUnload / HintPolicy(top-4096) /
  FrequencyPolicy over an ExactMonitor (threshold 3) and over a CMSMonitor:
  averages within 1e-5 us (the means sum in different orders), the Zipf
  CDF and so the regions bit-equal.
* The twins of ``tests/test_simulator.py`` and
  ``tests/test_fig3_regression.py`` on the port alone (60 000 writes,
  warm-up 6 000, the same bounds against ``FIG3_CLAIMS``).
* ``top_k_hot_table`` against JAX's with tied counts.

The microseconds are the paper's model constants, not device times.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import policy as JP
from repro.core import simulator as JS
from repro.core.monitor import CMSMonitor as JaxCMS
from repro.core.monitor import ExactMonitor as JaxExact
from repro.core.types import CPUTLBConfig as JaxTLB
from repro.core.types import MTTConfig as JaxMTT
from repro_torch.configs import FIG3_CLAIMS, PAPER_WORKLOAD
from repro_torch.core import (AlwaysOffload, AlwaysUnload, CMSMonitor,
                              CPUTLBConfig, ExactMonitor, FrequencyPolicy,
                              HintPolicy, MTTConfig, RDMASimulator,
                              sweep_point, top_k_hot_table)
from repro_torch.core import simulator as TS
from repro_torch.kernels import lru_scan, lru_scan_ref
from repro_torch.kernels.lru_scan import longest_chain
from repro_torch.models import prng

torch.set_num_threads(1)

N, W = 60_000, 6_000   # reduced from the paper's 5M; steady-state average
REGIONS = (1, 2 ** 12, 2 ** 20)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# the scan, bit for bit
# ---------------------------------------------------------------------------


def _jax_flags(regions, unload, mtt, tlb):
    """Per-write hit flags of JAX's two-cache scan (MTT for offloaded
    writes, TLB for unloaded ones)."""
    def step(carry, xs):
        m, t = carry
        r, u = xs
        m, mh = JS.cache_access(m, r, ~u)
        t, th = JS.cache_access(t, r, u)
        return (m, t), mh | th

    _, hit = lax.scan(step, (JS.make_cache(*mtt), JS.make_cache(*tlb)),
                      (jnp.asarray(regions), jnp.asarray(unload)))
    return np.asarray(hit)


def _stream(seed, n, n_regions, mask):
    rng = np.random.RandomState(seed)
    regions = rng.randint(0, n_regions, n).astype(np.int32)
    unload = {"mixed": rng.rand(n) < 0.5, "offload": np.zeros(n, bool),
              "unload": np.ones(n, bool),
              "runs": (np.arange(n) // 37) % 2 == 1}[mask]
    return regions, unload


@pytest.mark.parametrize("mtt,tlb", [((4, 2), (2, 4)), ((3, 3), (5, 1)),
                                     ((1, 8), (7, 2)), ((512, 8), (256, 8))])
@pytest.mark.parametrize("mask", ["mixed", "offload", "unload", "runs"])
def test_scan_equals_jax_lax_scan(mtt, tlb, mask):
    regions, unload = _stream(sum(mtt) * 7 + sum(tlb), 2500, 48, mask)
    want = _jax_flags(regions, unload, mtt, tlb)
    got = lru_scan(T(regions).long(), T(unload), mtt=mtt, tlb=tlb)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    jres = JS.RDMASimulator(mtt=JaxMTT(*mtt), cpu_tlb=JaxTLB(*tlb)).run(
        jnp.asarray(regions), jnp.asarray(unload))
    tres = RDMASimulator(mtt=MTTConfig(*mtt), cpu_tlb=CPUTLBConfig(*tlb)).run(
        T(regions).long(), T(unload))
    np.testing.assert_array_equal(tres.latency_us.numpy(),
                                  np.asarray(jres.latency_us))
    for f in ("mtt_hits", "n_offloaded", "n_unloaded"):
        assert int(getattr(tres, f)) == int(getattr(jres, f)), f


def test_cache_access_step_equals_jax():
    """The one-write reference step, state and flag, over a stream that
    disables the cache now and then (the clock must not move then)."""
    regions, unload = _stream(3, 200, 9, "mixed")
    js, ts = JS.make_cache(3, 2), TS.make_cache(3, 2, device="cpu")
    for r, u in zip(regions, unload):
        js, jh = JS.cache_access(js, jnp.int32(r), jnp.bool_(u))
        ts, th = TS.cache_access(ts, int(r), bool(u))
        assert bool(th) == bool(jh)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scan_edges_and_chain():
    empty = torch.zeros((0,), dtype=torch.int64)
    assert lru_scan(empty, empty.bool()).shape == (0,)
    r = torch.tensor([5, 5, 5, 5])
    assert lru_scan_ref(r, torch.zeros(4, dtype=torch.bool)).tolist() == [
        False, True, True, True]
    assert longest_chain(r, torch.tensor([0, 1, 0, 0]).bool()) == 3
    with pytest.raises(ValueError, match="1-32 ways"):
        lru_scan(r, r.bool(), mtt=(4, 33))
    with pytest.raises(TypeError, match="integers"):
        lru_scan(r.float(), r.bool())


def test_unload_writes_bypass_mtt():
    """Twin of ``test_simulator.py::test_unload_writes_bypass_mtt``."""
    sim = RDMASimulator()
    regions = torch.tensor([5, 5, 5, 5])
    assert int(sim.run(regions, torch.ones(4, dtype=torch.bool)).mtt_hits) == 0
    assert int(sim.run(regions, torch.zeros(4, dtype=torch.bool)).mtt_hits) == 3


# ---------------------------------------------------------------------------
# sweep_point against JAX
# ---------------------------------------------------------------------------


def _hot(r):
    hot = np.zeros((r,), bool)
    hot[: min(PAPER_WORKLOAD.adaptive_top_k, r)] = True
    return hot


ARMS = ("offload", "unload", "hint", "freq_exact", "freq_cms")


def _jax_arm(arm, r):
    if arm == "offload":
        return JP.AlwaysOffload(), None
    if arm == "unload":
        return JP.AlwaysUnload(), None
    if arm == "hint":
        return JP.HintPolicy(hot_regions=jnp.asarray(_hot(r))), None
    mon = JaxExact(n_regions=r) if arm == "freq_exact" else JaxCMS(4, 12)
    return JP.FrequencyPolicy(monitor=mon, threshold=3), mon


def _port_arm(arm, r):
    if arm == "offload":
        return AlwaysOffload(), None
    if arm == "unload":
        return AlwaysUnload(), None
    if arm == "hint":
        return HintPolicy(hot_regions=T(_hot(r))), None
    mon = ExactMonitor(n_regions=r) if arm == "freq_exact" else CMSMonitor(4, 12)
    return FrequencyPolicy(monitor=mon, threshold=3), mon


@pytest.fixture(scope="module")
def jax_sweeps():
    """JAX's averages at 60 000 writes, seed 0: {(arm, regions): us}."""
    out = {}
    for r in REGIONS:
        for arm in ARMS:
            pol, mon = _jax_arm(arm, r)
            out[arm, r] = JS.sweep_point(jax.random.key(0), r, N, W, pol,
                                         mon)[0]
    return out


@pytest.mark.parametrize("r", REGIONS)
@pytest.mark.parametrize("arm", ARMS)
def test_sweep_point_matches_jax(jax_sweeps, arm, r):
    pol, mon = _port_arm(arm, r)
    avg, res = sweep_point(prng.key(0), r, N, W, pol, mon, device="cpu")
    assert abs(avg - jax_sweeps[arm, r]) < 1e-5, (arm, r, avg,
                                                   jax_sweeps[arm, r])
    assert res.latency_us.shape == (N,)
    assert int(res.n_offloaded) + int(res.n_unloaded) == N


@pytest.mark.parametrize("r", PAPER_WORKLOAD.region_counts)
def test_zipf_cdf_is_jax_bit_for_bit(r):
    """The Zipf CDF (and so every region drawn from the same uniforms)
    equals the JAX package's at the paper's skew, at each region count of
    the sweep, 2^20 included."""
    ranks = jnp.arange(1, r + 1, dtype=jnp.float32)
    cdf = jnp.cumsum(ranks ** -0.5)
    np.testing.assert_array_equal(TS._zipf_cdf(r, 0.5).numpy(),
                                  np.asarray(cdf / cdf[-1]))


def test_zipf_regions_at_2e20_equal_jax():
    n = PAPER_WORKLOAD.sim_writes
    want = np.asarray(JS.zipf_regions(jax.random.key(5), n, 2 ** 20))
    got = TS.zipf_regions(n, 2 ** 20, u=prng.uniform(prng.key(5), n))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_point(prng.key(0), 16, 64, 8, AlwaysOffload())


@pytest.mark.parametrize("k", [0, 2, 5, 9])
def test_top_k_hot_table_ties_match_jax(k):
    counts = np.array([3, 7, 3, 7, 0, 3, 7, 1, 3], np.int32)
    np.testing.assert_array_equal(
        top_k_hot_table(T(counts).long(), k).numpy(),
        np.asarray(JP.top_k_hot_table(jnp.asarray(counts), k)))


# ---------------------------------------------------------------------------
# twins of the Fig. 3 claim tests, on the port alone
# ---------------------------------------------------------------------------


def _avg(policy, n_regions, monitor=None, seed=0):
    return sweep_point(prng.key(seed), n_regions, N, W, policy, monitor,
                       device="cpu")[0]


def _adaptive(r):
    return HintPolicy(hot_regions=T(_hot(r)))


@pytest.fixture(scope="module")
def endpoints():
    out = {}
    for r in (1, 2 ** 20):
        mon = ExactMonitor(n_regions=r)
        out[r] = {"offload": _avg(AlwaysOffload(), r),
                  "unload": _avg(AlwaysUnload(), r),
                  "adaptive_hint": _avg(_adaptive(r), r),
                  "adaptive_freq": _avg(FrequencyPolicy(monitor=mon,
                                                        threshold=3), r, mon)}
    return out


def test_fixed_paths_sit_on_the_paper_calibration(endpoints):
    assert abs(endpoints[1]["offload"]
               - FIG3_CLAIMS["offload_rtt_1_region"]) < 0.1
    assert abs(endpoints[2 ** 20]["offload"]
               - FIG3_CLAIMS["offload_rtt_2e20_regions"]) < 0.3
    assert abs(endpoints[1]["unload"] - FIG3_CLAIMS["unload_rtt_flat"]) < 0.2
    assert abs(endpoints[2 ** 20]["unload"]
               - FIG3_CLAIMS["unload_rtt_2e20_regions"]) < 0.2


@pytest.mark.parametrize("variant", ["adaptive_hint", "adaptive_freq"])
def test_adaptive_no_slower_than_best_fixed_path_at_endpoints(endpoints,
                                                              variant):
    for r in (1, 2 ** 20):
        best = min(endpoints[r]["offload"], endpoints[r]["unload"])
        assert endpoints[r][variant] <= best + 0.15, (r, variant)


def test_adaptive_tracks_paper_endpoint_values(endpoints):
    assert abs(endpoints[1]["adaptive_hint"]
               - FIG3_CLAIMS["offload_rtt_1_region"]) < 0.15
    assert abs(endpoints[2 ** 20]["adaptive_hint"]
               - FIG3_CLAIMS["unload_rtt_2e20_regions"]) < 0.25


def test_unload_flat_and_improvement_at_2e20(endpoints):
    lats = [endpoints[1]["unload"], _avg(AlwaysUnload(), 2 ** 10),
            endpoints[2 ** 20]["unload"]]
    assert all(abs(x - FIG3_CLAIMS["unload_rtt_flat"]) < 0.2 for x in lats)
    assert max(lats) - min(lats) < 0.25
    imp = 1.0 - endpoints[2 ** 20]["unload"] / endpoints[2 ** 20]["offload"]
    assert abs(imp - FIG3_CLAIMS["improvement_at_2e20"]) < 0.05


@pytest.mark.parametrize("r", [2 ** 12, 2 ** 14, 2 ** 17])
def test_adaptive_matches_best_of_both(r):
    ad = _avg(_adaptive(r), r)
    best = min(_avg(AlwaysOffload(), r), _avg(AlwaysUnload(), r))
    assert ad <= best + 0.15, (r, ad, best)
    if r == 2 ** 14:   # strictly better in the crossover zone
        assert ad < best - 0.1


def test_frequency_policy_tracks_hint_policy():
    r = 2 ** 16
    mon = ExactMonitor(n_regions=r)
    freq = _avg(FrequencyPolicy(monitor=mon, threshold=3), r, mon)
    assert freq < _avg(_adaptive(r), r) + 0.4


def test_zipf_skew():
    ids = TS.zipf_regions(50_000, 1024, 0.5, u=prng.uniform(prng.key(0),
                                                            50_000))
    counts = np.bincount(ids.numpy(), minlength=1024)
    assert counts[:16].mean() > 4 * counts[-256:].mean()
