// lru_scan: the simulator's sequential cache scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as a
// lax.scan, one write a step (src/repro/core/simulator.py, RDMASimulator.run
// over cache_access). Two set-associative LRU caches are probed and filled:
// the MTT by the writes whose unload flag is 0, the CPU dTLB by those whose
// flag is 1. For write i, cache c = unload[i], set s = region[i] % n_sets[c]:
//
//   hit  = some way of set s holds region[i]
//   way  = hit ? that way : the first way with the smallest stamp
//   tags[s][way] = region[i]; stamp[s][way] = ++clock
//   out[i] = hit
//
// A write's outcome depends only on the earlier writes that enabled the same
// set of the same cache, and LRU compares stamps within a set only, so every
// (cache, set) runs its own chain and gives the JAX scan's hit flags
// exactly.
//
// Design: bucket the writes by (cache, set), then one thread a chain. Five
// launches, one lru_scan call.
//
// 1. A stable counting sort by key = unload ? mtt_sets + r % tlb_sets
//    : r % mtt_sets, over tiles of 2048 writes. lru_bucket_count: each
//    tile's histogram (one shared-memory counter a key, one atomic a group
//    of equal keys in a warp). lru_bucket_offsets: the exclusive scan in
//    (key, tile) order, 32 keys a block and a slice of the tiles a warp,
//    so every tile learns where its writes of each key start; the last
//    block to finish scans the keys' totals into the buckets' offsets.
//    lru_bucket_scatter: write i of key k goes to bucket position p, with
//    sorted[p] = region and inv[i] = p. Stable: the scatter ranks a tile's
//    writes warp by warp and round by round (__match_any_sync groups a
//    round's equal keys; a lane's rank is the earlier lanes of its group
//    plus the warp's running count), and warps and tiles follow each other
//    in time order.
// 2. lru_chain: one thread a (cache, set), its ways in registers: the set's
//    last WP distinct regions in recency order (WP = n_ways rounded up to
//    8, 16 or 32). A write that matches way p moves it to the front, ways
//    1..p taking the way before them; a miss shifts every way and drops the
//    last. The JAX step's stamps order a set's filled ways by recency and
//    fill empty ways first, so its victim is the least recent region and
//    its hit flags are this list's; by LRU's inclusion the first n_ways
//    ways are an n_ways-way set's content, so one update serves every
//    n_ways <= WP and a hit is a match below n_ways. The step is WP
//    compares, a prefix-OR in chunks of 4 and WP - 1 selects: no branch and
//    no way index in a register, so the 32 chains of a warp advance
//    together and a warp lasts as long as its longest chain. A thread reads
//    its bucket 16 regions ahead of the chain (8 at 32 ways; two register
//    buffers) and ORs each 16 steps' hits into a bit map of bucket
//    positions: a byte store a step, scattered to the writes' indices, cost
//    more than the step (PERF.md).
// 3. lru_flags: hit_out[i] = bit inv[i], coalesced.
//
// Bound. Bytes: read each region and flag once, write one flag. Operations:
// the longest (cache, set)'s chain of dependent steps (all writes at one
// region fall into one set), at the faster of the steps timed alone:
// lru_chain_probe (this design's step, one thread) and lru_step_probe (the
// first design's warp step: one warp a set, the ways on lanes, probe by a
// ballot and LRU by a warp min-reduce). The bucketing's traffic counts
// against the kernel's time, not into its bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileWarps = 8;                     // warps a bucketing block
constexpr int kRounds = 8;                        // 32-write rounds a warp
constexpr int kWarpWrites = 32 * kRounds;         // 256
constexpr int kTile = kWarpWrites * kTileWarps;   // 2048 writes a tile
constexpr int kScanThreads = 1024;                // the key scan's block
constexpr int kSliceWarps = 32;                   // offsets: tile slices
constexpr int kMaxKeys = 4096;                    // scatter: 8 x 16 KB shared
constexpr unsigned kNoKey = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned set_key(long long r, unsigned char u,
                                            int mtt_sets, int tlb_sets) {
  const unsigned ru = (unsigned)r;
  return u ? (unsigned)mtt_sets + ru % (unsigned)tlb_sets
           : ru % (unsigned)mtt_sets;
}

// A tile's writes in registers, lane-interleaved (coalesced): round rd of
// warp w holds write tile0 + w * 256 + rd * 32 + lane.
__device__ __forceinline__ void load_keys(
    const long long* __restrict__ region, const unsigned char* __restrict__ unload,
    long long n, int mtt_sets, int tlb_sets, long long first,
    long long (&r)[kRounds], unsigned (&key)[kRounds]) {
  const int lane = threadIdx.x & 31;
  unsigned char u[kRounds];
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const long long i = first + rd * 32 + lane;
    r[rd] = i < n ? region[i] : 0;
    u[rd] = i < n ? unload[i] : 0;
  }
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const long long i = first + rd * 32 + lane;
    key[rd] = i < n ? set_key(r[rd], u[rd], mtt_sets, tlb_sets) : kNoKey;
  }
}

// counts[tile * keys + k] = the tile's writes of key k.
__global__ void __launch_bounds__(32 * kTileWarps) lru_bucket_count_kernel(
    const long long* __restrict__ region, const unsigned char* __restrict__ unload,
    long long n, int mtt_sets, int tlb_sets, int* __restrict__ counts,
    unsigned* __restrict__ ticket) {
  extern __shared__ int hist[];
  const int keys = mtt_sets + tlb_sets;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0u;
  for (int k = threadIdx.x; k < keys; k += blockDim.x) hist[k] = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long r[kRounds];
  unsigned key[kRounds];
  load_keys(region, unload, n, mtt_sets, tlb_sets,
            (long long)blockIdx.x * kTile + warp * kWarpWrites, r, key);
  __syncthreads();
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[rd]);
    if (key[rd] != kNoKey && lane == __ffs(peers) - 1)
      atomicAdd(&hist[key[rd]], __popc(peers));
  }
  __syncthreads();
  int* out = counts + (long long)blockIdx.x * keys;
  for (int k = threadIdx.x; k < keys; k += blockDim.x) out[k] = hist[k];
}

// offsets[k] = in[0] + ... + in[k-1] for k <= keys, by one block of
// kScanThreads threads, kScanThreads keys at a time.
__device__ void block_exclusive_scan(const volatile int* in, int keys,
                                     int* __restrict__ offsets) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int k0 = 0; k0 < keys; k0 += kScanThreads) {
    const int k = k0 + threadIdx.x;
    const int v = k < keys ? in[k] : 0;
    int x = v;  // inclusive over the block's threads
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
    if (k < keys) offsets[k] = before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[keys] = carry;
}

// Blocks of 32 keys (a lane each) x kSliceWarps warps, each warp a slice
// of the tiles, all loads coalesced across the keys. counts[t][k] becomes
// key k's writes in the tiles before t and totals[k] its writes; the last
// block to finish (ticket) turns the totals into the buckets' offsets.
__global__ void __launch_bounds__(32 * kSliceWarps) lru_bucket_offsets_kernel(
    int* __restrict__ counts, int tiles, int keys, int* totals,
    int* __restrict__ offsets, unsigned* __restrict__ ticket) {
  __shared__ int part[kSliceWarps][33];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const int per = (tiles + kSliceWarps - 1) / kSliceWarps;
  const int t0 = min(warp * per, tiles), t1 = min(t0 + per, tiles);
  int sum = 0;
  if (k < keys) {
#pragma unroll 4
    for (int t = t0; t < t1; ++t) sum += counts[(long long)t * keys + k];
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int w = 0; w < kSliceWarps; ++w) {
      const int c = part[w][lane];
      part[w][lane] = run;
      run += c;
    }
    if (k < keys) totals[k] = run;
  }
  __syncthreads();
  if (k < keys) {
    int run = part[warp][lane];
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const int c = counts[(long long)t * keys + k];
      counts[(long long)t * keys + k] = run;
      run += c;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) block_exclusive_scan(totals, keys, offsets);
}

// Key k's j-th write in time order, write i, goes to bucket position p =
// offsets[k] + j: sorted[p] = region[i], inv[i] = p.
__global__ void __launch_bounds__(32 * kTileWarps) lru_bucket_scatter_kernel(
    const long long* __restrict__ region, const unsigned char* __restrict__ unload,
    long long n, int mtt_sets, int tlb_sets, const int* __restrict__ counts,
    const int* __restrict__ offsets, int* __restrict__ sorted,
    int* __restrict__ inv, unsigned* __restrict__ bits) {
  extern __shared__ int base[];  // [kTileWarps][keys]
  const int keys = mtt_sets + tlb_sets;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kTileWarps * keys; k += blockDim.x) base[k] = 0;
  // the chain's hit bits (one a bucket position), zeroed a tile's worth a
  // block: kTile / 32 words
  if (threadIdx.x < kTile / 32)
    bits[(long long)blockIdx.x * (kTile / 32) + threadIdx.x] = 0u;
  const long long first = (long long)blockIdx.x * kTile + warp * kWarpWrites;
  long long r[kRounds];
  unsigned key[kRounds];
  int rank[kRounds];
  load_keys(region, unload, n, mtt_sets, tlb_sets, first, r, key);
  __syncthreads();
  // the warp's own count a key, round by round: a lane's rank is the
  // earlier lanes of its group plus the writes of its key in earlier rounds
  int* mine = base + warp * keys;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[rd]);
    const bool ok = key[rd] != kNoKey;
    const int seen = ok ? mine[key[rd]] : 0;
    rank[rd] = seen + __popc(peers & below);
    __syncwarp();
    if (ok && (peers & below) == 0) mine[key[rd]] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // where each warp's writes of key k start: the key's bucket, the earlier
  // tiles' writes of k, then the earlier warps' of this tile
  const int* before = counts + (long long)blockIdx.x * keys;
  for (int k = threadIdx.x; k < keys; k += blockDim.x) {
    int at = offsets[k] + before[k];
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = base[w * keys + k];
      base[w * keys + k] = at;
      at += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    if (key[rd] == kNoKey) continue;
    const int i = (int)(first + rd * 32 + lane);
    const int p = mine[key[rd]] + rank[rd];
    sorted[p] = (int)r[rd];
    inv[i] = p;
  }
}

// One write of a set's chain. tag[w] holds the set's last WP distinct
// regions by recency, way 0 the most recent, -1 where there are fewer.
// A match at way p moves it to the front (ways 1..p take the way before
// them); no match shifts every way and drops the last. LRU's inclusion:
// the first n_ways entries are exactly an n_ways-way LRU set's content, so
// the update is the same for every n_ways <= WP and only the hit asks for
// a match below n_ways. kExact (n_ways == WP): the last prefix-OR; else a
// bit mask of the matches against real, which stays off the chain's path.
template <int WP, bool kExact>
__device__ __forceinline__ bool lru_step(int r, int (&tag)[WP],
                                         unsigned real) {
  bool seen[WP];
  unsigned match = 0;
  bool before = false;
#pragma unroll
  for (int c = 0; c < WP; c += 4) {
    bool in = false;
#pragma unroll
    for (int w = c; w < c + 4; ++w) {
      const bool m = tag[w] == r;
      if constexpr (!kExact) match |= m ? 1u << w : 0u;
      in = in | m;
      seen[w] = before | in;
    }
    before = before | in;
  }
#pragma unroll
  for (int w = WP - 1; w >= 1; --w) tag[w] = seen[w - 1] ? tag[w] : tag[w - 1];
  tag[0] = r;
  if constexpr (kExact) return seen[WP - 1];
  return (match & real) != 0u;
}

// Regions j..j+A-1 of the bucket (-1 past its end).
template <int A>
__device__ __forceinline__ void fetch(int (&buf)[A],
                                      const int* __restrict__ bucket, int j,
                                      int len) {
#pragma unroll
  for (int u = 0; u < A; ++u) buf[u] = j + u < len ? bucket[j + u] : -1;
}

// A steps of the chain from bucket position at = start + j. Their hits go
// to bits (bit p for bucket position p) in at most two atomic ORs: a store
// a step, scattered to the writes' indices, costs more than the step.
template <int WP, bool kExact, int A>
__device__ __forceinline__ void run(const int (&buf)[A], int at, int left,
                                    int (&tag)[WP], unsigned real,
                                    unsigned* __restrict__ bits) {
  unsigned m = 0;
#pragma unroll
  for (int u = 0; u < A; ++u)
    m |= lru_step<WP, kExact>(buf[u], tag, real) ? 1u << u : 0u;
  if (left < A) m &= left > 0 ? (1u << left) - 1u : 0u;
  if (m != 0u) {
    const int sh = at & 31;
    atomicOr(bits + (at >> 5), m << sh);
    // the next word only for bits that reach it: a bucket's last group may
    // start in the last word of the map, which has no word after it
    const unsigned hi = sh + A > 32 ? m >> (32 - sh) : 0u;
    if (hi != 0u) atomicOr(bits + (at >> 5) + 1, hi);
  }
}

// One thread a (cache, set): the MTT's sets are keys 0..mtt_sets-1, the
// TLB's follow. A warp runs as many steps as its longest chain; a thread
// past its own sets no bit.
template <int WP, bool kExact>
__global__ void __launch_bounds__(32) lru_chain_kernel(
    const int* __restrict__ sorted, const int* __restrict__ offsets,
    int mtt_sets, int mtt_ways, int tlb_sets, int tlb_ways,
    unsigned* __restrict__ bits) {
  const int k = blockIdx.x * 32 + threadIdx.x;
  int start = 0, len = 0, n_ways = WP;
  if (k < mtt_sets + tlb_sets) {
    start = offsets[k];
    len = offsets[k + 1] - start;
    n_ways = k < mtt_sets ? mtt_ways : tlb_ways;
  }
  const unsigned real = n_ways == 32 ? ~0u : (1u << n_ways) - 1u;
  const int steps = (int)__reduce_max_sync(0xffffffffu, (unsigned)len);
  const int* bucket = sorted + start;
  int tag[WP];
#pragma unroll
  for (int w = 0; w < WP; ++w) tag[w] = -1;
  constexpr int A = WP <= 16 ? 16 : 8;  // regions a buffer, two buffers
  int a[A], b[A];
  fetch<A>(a, bucket, 0, len);
  for (int j = 0; j < steps; j += 2 * A) {
    fetch<A>(b, bucket, j + A, len);
    run<WP, kExact, A>(a, start + j, len - j, tag, real, bits);
    fetch<A>(a, bucket, j + 2 * A, len);
    run<WP, kExact, A>(b, start + j + A, len - j - A, tag, real, bits);
  }
}

// hit_out[i] = bit inv[i]: each write's hit flag from its bucket position.
__global__ void __launch_bounds__(256) lru_flags_kernel(
    const int* __restrict__ inv, const unsigned* __restrict__ bits,
    long long n, unsigned char* __restrict__ hit_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = inv[i];
  hit_out[i] = (bits[p >> 5] >> (p & 31)) & 1u;
}

// The chain's step alone, for the bound: one thread, 8 ways, registers only,
// `steps` steps of lru_step. miss == 0: two regions in turn, so every step
// after the first two hits; miss != 0: nine regions in turn through 8 ways,
// so every step misses.
__global__ void lru_chain_probe_kernel(long long steps, int miss,
                                       long long* __restrict__ out) {
  int tag[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) tag[w] = -1;
  const int last = miss ? 8 : 1;
  int r = 0, hits = 0;
#pragma unroll 8
  for (long long s = 0; s < steps; ++s) {
    r = r == last ? 0 : r + 1;
    hits += lru_step<8, true>(r, tag, 0xFFu);
  }
  long long acc = hits;
#pragma unroll
  for (int w = 0; w < 8; ++w) acc = acc * 31 + tag[w];
  out[0] = acc;
}

// The first design's step (one warp a set, the ways on lanes), for the
// bound: one warp runs `steps` steps of its loop-carried chain alone (the
// region by a shuffle, the probe ballot, the LRU min-reduce on a miss, the
// way's update). miss == 0: lane 0's region every step, so every step after
// the first hits; miss != 0: the 32 lanes' regions in turn through n_ways
// <= 31 ways, so every step misses.
__global__ void lru_step_probe_kernel(long long steps, int n_ways, int miss,
                                      long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = miss ? lane : 0;
  long long tag = lane < n_ways ? -1 : -2;
  unsigned int stamp = lane < n_ways ? 0u : 0x7FFFFFFu;
  unsigned int clock = 0;
  for (long long k = 0; k < steps; ++k) {
    const long long reg = __shfl_sync(0xffffffffu, r, (int)(k & 31));
    ++clock;
    const unsigned int hits = __ballot_sync(0xffffffffu, tag == reg);
    int way;
    if (hits) {
      way = __ffs(hits) - 1;
    } else {
      const unsigned int k2 = (stamp << 5) | (unsigned)lane;
      way = (int)(__reduce_min_sync(0xffffffffu, k2) & 31u);
    }
    if (lane == way) {
      tag = reg;
      stamp = clock;
    }
  }
  out[lane] = tag * 32 + stamp;
}

template <int WP, bool kExact>
void launch_chain(const int* sorted, const int* offsets, int mtt_sets,
                  int mtt_ways, int tlb_sets, int tlb_ways, unsigned* bits,
                  cudaStream_t stream) {
  const int keys = mtt_sets + tlb_sets;
  lru_chain_kernel<WP, kExact><<<(keys + 31) / 32, 32, 0, stream>>>(
      sorted, offsets, mtt_sets, mtt_ways, tlb_sets, tlb_ways, bits);
}

bool bad_args(long long n, int mtt_sets, int mtt_ways, int tlb_sets,
              int tlb_ways) {
  return n <= 0 || n >= (1ll << 27) || mtt_sets <= 0 || tlb_sets <= 0 ||
         mtt_sets + tlb_sets > kMaxKeys || mtt_ways <= 0 || mtt_ways > 32 ||
         tlb_ways <= 0 || tlb_ways > 32;
}

}  // namespace

// The (cache, set) key space the kernels take: mtt_sets + tlb_sets <= this.
extern "C" int lru_scan_max_keys() { return kMaxKeys; }

// Writes a tile of the bucketing: the wrapper sizes counts as
// ceil(n / tile) * (mtt_sets + tlb_sets) and bits as ceil(n / tile) *
// tile / 32.
extern "C" int lru_scan_tile() { return kTile; }

// The whole scan, five launches in this order: lru_bucket_count,
// lru_bucket_offsets, lru_bucket_scatter (the bucketing), lru_chain,
// lru_flags. Scratch: counts int32[tiles * keys], totals int32[keys + 1]
// (the last: the offsets pass's ticket); offsets int32[keys + 1], sorted and
// inv int32[n] (the bucketing, left for the caller to read), bits
// int32[tiles * kTile / 32] (zeroed here). launched, on the host, int32[5]:
// each kernel's slot gains one when its launch is taken. Regions are
// non-negative and below 2^31; n < 2^27. Returns cudaGetLastError() after
// the last launch (0 = all five launched) or the first error.
extern "C" int lru_scan_launch(const long long* region,
                               const unsigned char* unload, long long n,
                               int mtt_sets, int mtt_ways, int tlb_sets,
                               int tlb_ways, int* counts, int* totals,
                               int* offsets, int* sorted, int* inv,
                               unsigned* bits, unsigned char* hit_out,
                               int* launched, void* stream) {
  if (bad_args(n, mtt_sets, mtt_ways, tlb_sets, tlb_ways))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int keys = mtt_sets + tlb_sets;
  const int tiles = (int)((n + kTile - 1) / kTile);
  unsigned* ticket = reinterpret_cast<unsigned*>(totals + keys);
  const size_t scatter_smem = (size_t)kTileWarps * keys * sizeof(int);
  if (scatter_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lru_bucket_scatter_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scatter_smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ways = mtt_ways > tlb_ways ? mtt_ways : tlb_ways;
  const int wp = ways <= 8 ? 8 : ways <= 16 ? 16 : 32;
  const bool exact = mtt_ways == wp && tlb_ways == wp;
  const auto chain =
      wp == 8 ? (exact ? launch_chain<8, true> : launch_chain<8, false>)
      : wp == 16 ? (exact ? launch_chain<16, true> : launch_chain<16, false>)
                 : (exact ? launch_chain<32, true> : launch_chain<32, false>);
  // cudaGetLastError() after launch k; on success launched[k] gains one
  const auto taken = [launched](int k) {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++launched[k];
    return (int)e;
  };
  lru_bucket_count_kernel<<<tiles, 32 * kTileWarps, keys * sizeof(int), s>>>(
      region, unload, n, mtt_sets, tlb_sets, counts, ticket);
  if (const int e = taken(0)) return e;
  lru_bucket_offsets_kernel<<<(keys + 31) / 32, 32 * kSliceWarps, 0, s>>>(
      counts, tiles, keys, totals, offsets, ticket);
  if (const int e = taken(1)) return e;
  lru_bucket_scatter_kernel<<<tiles, 32 * kTileWarps, scatter_smem, s>>>(
      region, unload, n, mtt_sets, tlb_sets, counts, offsets, sorted, inv,
      bits);
  if (const int e = taken(2)) return e;
  chain(sorted, offsets, mtt_sets, mtt_ways, tlb_sets, tlb_ways, bits, s);
  if (const int e = taken(3)) return e;
  lru_flags_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(inv, bits, n,
                                                               hit_out);
  return taken(4);
}

// One thread of lru_chain_probe_kernel; out is int64[1].
extern "C" int lru_chain_probe_launch(long long steps, int miss,
                                      long long* out, void* stream) {
  if (steps <= 0 || steps >= (1ll << 27)) return (int)cudaErrorInvalidValue;
  lru_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, miss, out);
  return (int)cudaGetLastError();
}

// One warp of lru_step_probe_kernel; out is int64[32].
extern "C" int lru_step_probe_launch(long long steps, int n_ways, int miss,
                                     long long* out, void* stream) {
  if (steps <= 0 || steps >= (1ll << 27) || n_ways <= 0 || n_ways > 31)
    return (int)cudaErrorInvalidValue;
  lru_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, n_ways, miss, out);
  return (int)cudaGetLastError();
}
