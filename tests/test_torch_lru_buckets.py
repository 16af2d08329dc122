"""The logic of ``csrc/lru_scan.cu``'s design, on the CPU, against JAX.

The card runs ``lru_scan`` as a stable counting sort of the writes by
(cache, set) key and one chain a thread over each bucket, the ways in
registers padded to 8, 16 or 32. CUDA does not run here, so this file holds
Python twins of both halves, written step for step as the kernels are, and
checks them:

* ``lru_buckets_ref`` (the bucketing's plain version): a permutation of the
  writes, key-major, time order kept in every bucket, offsets at the
  buckets' starts; and the twin of the three bucketing launches (per-tile
  histogram, the scan in (key, tile) order by slices of tiles, the
  warp-by-warp, round-by-round stable scatter) equal to it at small tile
  geometries.
* The twin of the per-thread chain (the set's regions in recency order,
  8, 16 or 32 deep; by LRU's inclusion an n_ways-way set is the first
  n_ways of them, so a hit is a match below n_ways) run over those buckets,
  its hits packed into a bit map of bucket positions and moved from there
  to the writes' indices as the last two launches do, gives JAX's ``lax.scan`` flags over ``cache_access`` and
  ``lru_scan_ref``'s, bit for bit, at 1, 3, 8, 9 and 32 ways (lists of 8,
  16 and 32), with set counts that are not powers of two, every write in
  one set, and the four routings.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import simulator as JS
from repro_torch.kernels import (kernel_launch_counts, launch_counts,
                                 lru_buckets_ref, lru_scan_ref,
                                 reset_launch_counts)
from repro_torch.kernels.lru_scan import (LRU_KERNELS, bucket_keys,
                                          lru_scan_buckets)

torch.set_num_threads(1)

WAYS = (1, 3, 8, 9, 32)
SETS = ((5, 3), (1, 1), (12, 7))
MASKS = ("mixed", "offload", "unload", "runs")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_flags(regions, unload, mtt, tlb):
    """JAX's two-cache scan (MTT for offloaded writes, TLB for unloaded)."""
    def step(carry, xs):
        m, t = carry
        r, u = xs
        m, mh = JS.cache_access(m, r, ~u)
        t, th = JS.cache_access(t, r, u)
        return (m, t), mh | th

    _, hit = lax.scan(step, (JS.make_cache(*mtt), JS.make_cache(*tlb)),
                      (regions, unload))
    return hit


def _stream(seed, n, n_regions, mask):
    """Skewed regions (small ones far more often, so sets both hit and
    evict) and one of four routings."""
    rng = np.random.RandomState(seed)
    regions = (n_regions * rng.rand(n) ** 2).astype(np.int32)
    unload = {"mixed": rng.rand(n) < 0.5, "offload": np.zeros(n, bool),
              "unload": np.ones(n, bool),
              "runs": (np.arange(n) // 37) % 2 == 1}[mask]
    return regions, unload


def _padded(n_ways):
    return 8 if n_ways <= 8 else 16 if n_ways <= 16 else 32


def chain_twin(regions, n_ways):
    """``lru_chain_kernel``'s thread over one bucket, step for step: the
    set's last ``wp`` distinct regions by recency (way 0 the most recent,
    -1 where there are fewer), the prefix-OR of the matches in chunks of 4,
    ways 1..p taking the way before them; a hit is a match below
    ``n_ways``. Returns the hit flags of the set's writes in time order."""
    wp = _padded(n_ways)
    tag = [-1] * wp
    hits = []
    for r in regions:
        match = [tag[w] == r for w in range(wp)]
        seen, before = [False] * wp, False
        for c in range(0, wp, 4):
            inside = False
            for w in range(c, c + 4):
                inside = inside or match[w]
                seen[w] = before or inside
            before = before or inside
        for w in range(wp - 1, 0, -1):
            tag[w] = tag[w] if seen[w - 1] else tag[w - 1]
        tag[0] = r
        hits.append(seen[wp - 1] if n_ways == wp else any(match[:n_ways]))
    return hits


def scan_twin(regions, unload, mtt, tlb, ahead=16, tile=2048):
    """The card's scan: the buckets, one chain a (cache, set) whose hits go,
    ``ahead`` steps at a time, into a bit map of bucket positions (a word
    ORed at ``start + j``, its overflow into the next word where it has
    bits), then each bit to its write's index. The map has the kernel's
    words, a tile's worth a tile of ``tile`` writes, and no more."""
    order, offsets = lru_buckets_ref(T(regions).long(), T(unload), mtt, tlb)
    order, offsets = order.numpy(), offsets.numpy()
    bits = [0] * (-(-len(regions) // tile) * tile // 32)
    for k in range(mtt[0] + tlb[0]):
        start, end = offsets[k], offsets[k + 1]
        ways = mtt[1] if k < mtt[0] else tlb[1]
        hits = chain_twin(regions[order[start:end]].tolist(), ways)
        for j in range(0, end - start, ahead):
            m = sum(1 << u for u, h in enumerate(hits[j:j + ahead]) if h)
            at = start + j
            sh = at & 31
            bits[at >> 5] |= (m << sh) & 0xFFFFFFFF
            hi = m >> (32 - sh) if sh + ahead > 32 else 0
            if hi:
                bits[(at >> 5) + 1] |= hi
    flags = np.zeros(len(regions), bool)
    for p, i in enumerate(order):
        flags[i] = (bits[p >> 5] >> (p & 31)) & 1
    return flags


def bucket_twin(regions, unload, mtt, tlb, warps, rounds, lanes=32,
                slices=32):
    """The three bucketing launches at a tile of ``warps`` x ``rounds`` x
    ``lanes`` writes (the kernel's is 8 x 8 x 32) and ``slices`` tile slices
    a key in the offsets pass (the kernel's 32): ``(order, offsets,
    sorted, inv)``."""
    key = bucket_keys(T(regions).long(), T(unload), mtt, tlb).numpy()
    n, keys = len(key), mtt[0] + tlb[0]
    per_warp = rounds * lanes
    tile = per_warp * warps
    tiles = -(-n // tile)
    # lru_bucket_count: each tile's histogram
    counts = np.zeros((tiles, keys), np.int64)
    for i in range(n):
        counts[i // tile, key[i]] += 1
    # lru_bucket_offsets: per key, a sum a slice of tiles, the slices'
    # exclusive scan, each slice's tiles in order; then the keys' totals
    per = -(-tiles // slices)
    total = np.zeros(keys, np.int64)
    for k in range(keys):
        bounds = [(min(w * per, tiles), min(min(w * per, tiles) + per, tiles))
                  for w in range(slices)]
        part = [counts[t0:t1, k].sum() for t0, t1 in bounds]
        run = 0
        for w, (t0, t1) in enumerate(bounds):
            start = run
            run += part[w]
            for t in range(t0, t1):
                counts[t, k], start = start, start + counts[t, k]
        total[k] = run
    offsets = np.concatenate([[0], np.cumsum(total)])
    # lru_bucket_scatter: ranks warp by warp, round by round
    order = np.full(n, -1, np.int64)
    sorted_ = np.full(n, -1, np.int64)
    inv = np.full(n, -1, np.int64)
    for t in range(tiles):
        base = np.zeros((warps, keys), np.int64)
        placed = []
        for w in range(warps):
            for rd in range(rounds):
                first = t * tile + w * per_warp + rd * lanes
                lane_keys = [key[i] if i < n else None
                             for i in range(first, first + lanes)]
                for lane, k in enumerate(lane_keys):
                    if k is None:
                        continue
                    earlier = sum(1 for q in lane_keys[:lane] if q == k)
                    placed.append((w, k, base[w, k] + earlier, first + lane))
                for k in set(q for q in lane_keys if q is not None):
                    base[w, k] += lane_keys.count(k)
        for k in range(keys):
            at = offsets[k] + counts[t, k]
            for w in range(warps):
                base[w, k], at = at, at + base[w, k]
        for w, k, rank, i in placed:
            p = base[w, k] + rank
            order[p], sorted_[p], inv[i] = i, regions[i], p
    return order, offsets, sorted_, inv


def _sets_ways(i, sets):
    """MTT (sets[0] x WAYS[i]), TLB (sets[1] x the next way count), so both
    caches of one chain launch pad differently."""
    return (sets[0], WAYS[i]), (sets[1], WAYS[(i + 1) % len(WAYS)])


@pytest.mark.parametrize("sets", SETS)
@pytest.mark.parametrize("mask", MASKS)
def test_buckets_ref_is_stable_and_key_major(sets, mask):
    mtt, tlb = (sets[0], 8), (sets[1], 8)
    regions, unload = _stream(sum(sets), 1500, 60, mask)
    order, offsets = lru_buckets_ref(T(regions).long(), T(unload), mtt, tlb)
    order, offsets = order.numpy(), offsets.numpy()
    assert order.dtype == np.int64 and offsets.dtype == np.int64
    np.testing.assert_array_equal(np.sort(order), np.arange(len(regions)))
    key = bucket_keys(T(regions).long(), T(unload), mtt, tlb).numpy()
    assert offsets[0] == 0 and offsets[-1] == len(regions)
    assert len(offsets) == sum(sets) + 1
    for k in range(sum(sets)):
        idx = order[offsets[k]:offsets[k + 1]]
        assert (key[idx] == k).all()
        assert (np.diff(idx) > 0).all()          # time order in the bucket
        assert len(idx) == (key == k).sum()


@pytest.mark.parametrize("geometry", [(8, 8, 32, 32), (2, 2, 32, 32),
                                      (3, 1, 4, 5), (1, 3, 8, 3)])
@pytest.mark.parametrize("sets", SETS)
def test_bucket_twin_equals_ref(geometry, sets):
    """Tiles of 2048 (the kernel's), and small tiles so that a 1500-write
    stream spans many tiles, warps, rounds, slices of tiles (some empty)
    and a ragged last tile; the regions in bucket order and each write's
    bucket position (``inv``) agree with ``order``."""
    mtt, tlb = (sets[0], 8), (sets[1], 8)
    regions, unload = _stream(7 + sum(sets), 1500, 40, "mixed")
    want_order, want_off = lru_buckets_ref(T(regions).long(), T(unload),
                                           mtt, tlb)
    order, offsets, sorted_, inv = bucket_twin(regions, unload, mtt, tlb,
                                               *geometry)
    np.testing.assert_array_equal(order, want_order.numpy())
    np.testing.assert_array_equal(offsets, want_off.numpy())
    np.testing.assert_array_equal(sorted_, regions[order])
    np.testing.assert_array_equal(inv[order], np.arange(len(regions)))


@pytest.mark.parametrize("sets", SETS)
@pytest.mark.parametrize("i", range(len(WAYS)), ids=[f"w{w}" for w in WAYS])
@pytest.mark.parametrize("mask", MASKS)
def test_chain_twin_equals_jax(sets, i, mask):
    mtt, tlb = _sets_ways(i, sets)
    cap = sets[0] * mtt[1] + sets[1] * tlb[1]
    regions, unload = _stream(31 * i + sum(sets), 1200, 2 * cap + 3, mask)
    want = np.asarray(_jax_flags(jnp.asarray(regions), jnp.asarray(unload),
                                 mtt, tlb))
    got = scan_twin(regions, unload, mtt, tlb)
    np.testing.assert_array_equal(got, want)
    ref = lru_scan_ref(T(regions).long(), T(unload), mtt, tlb)
    np.testing.assert_array_equal(ref.numpy(), want)
    assert 0 < want.sum() < len(want)           # both hits and misses


@pytest.mark.parametrize("mask", MASKS)
def test_chain_twin_at_the_papers_caches(mask):
    """MTT 512 x 8, dTLB 256 x 8 (``MTTConfig``, ``CPUTLBConfig``)."""
    mtt, tlb = (512, 8), (256, 8)
    regions, unload = _stream(5, 4000, 6000, mask)
    want = np.asarray(_jax_flags(jnp.asarray(regions), jnp.asarray(unload),
                                 mtt, tlb))
    np.testing.assert_array_equal(scan_twin(regions, unload, mtt, tlb), want)


def test_chain_twin_one_region():
    """Every write at one region: a single chain, a miss then hits."""
    regions = np.full(300, 11, np.int32)
    unload = np.zeros(300, bool)
    flags = scan_twin(regions, unload, (512, 8), (256, 8))
    assert not flags[0] and flags[1:].all()


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("ahead", [16, 8])
@pytest.mark.parametrize("mask", ["offload", "unload"])
def test_chain_twin_last_word_of_the_bit_map(n, ahead, mask):
    """``n`` a multiple of the tile, so the bit map has no word past the
    writes, and the last bucket (the last MTT set when all are offloaded,
    the last TLB set when all are unloaded) only its last 10 writes: its
    last group starts at bit 22 (16 steps a group, a list of 8 ways) or 30
    (8 steps, 32 ways) of the map's last word and reaches no bit of a next
    word, which the map does not have."""
    ways = 8 if ahead == 16 else 32
    mtt, tlb = (512, ways), (256, ways)
    regions, _ = _stream(n, n, 1 << 20, "offload")
    regions = np.where(regions % 256 == 255, regions - 1, regions)
    regions[-10:] = 511                   # 511 % 512 = 511, 511 % 256 = 255
    unload = np.full(n, mask == "unload")
    want = np.asarray(_jax_flags(jnp.asarray(regions), jnp.asarray(unload),
                                 mtt, tlb))
    got = scan_twin(regions, unload, mtt, tlb, ahead=ahead)
    np.testing.assert_array_equal(got, want)
    assert not got[-10] and got[-9:].all()


def test_lru_buckets_on_cpu_is_the_plain_version():
    """``lru_scan_buckets`` on a CPU tensor: the plain versions' flags and
    bucketing (``inv`` the inverse of ``lru_buckets_ref``'s order), and no
    launch counted."""
    reset_launch_counts()
    regions, unload = _stream(3, 700, 90, "mixed")
    args = (T(regions).long(), T(unload), (5, 3), (7, 2))
    hit, inv, offsets = lru_scan_buckets(*args)
    order, want_offsets = lru_buckets_ref(*args)
    assert torch.equal(hit, lru_scan_ref(*args))
    assert torch.equal(inv[order], torch.arange(len(regions)))
    assert torch.equal(offsets, want_offsets)
    assert launch_counts()["lru_scan"] == 0
    assert kernel_launch_counts() == dict.fromkeys(LRU_KERNELS, 0)
