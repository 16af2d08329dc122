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
// (cache, set) runs its own chain with a clock of its own and gives the
// JAX scan's hits, fills and victims exactly (all-zero stamps pick the first
// empty way there as here).
//
// One warp per (cache, set), the MTT's sets first, then the TLB's, all in one
// grid. The ways sit on lanes (n_ways <= 32): the probe is one compare and a
// __ballot_sync, the LRU choice one __reduce_min_sync of stamp * 32 + lane,
// so ties go to the lowest way. Lanes at or past n_ways hold a tag that never
// matches and the largest stamp. No sort: each warp walks the whole stream
// in time order, 32 writes a load (coalesced, four loads in flight a lane),
// keeps those of its set with a ballot and takes them one by one.
//
// Bound. Bytes: read each region and flag once, write one flag. Operations:
// the longest set's chain of dependent steps (all writes at one region fall
// into one set), a hit step and a miss step each timed alone by
// lru_step_probe below. Each warp reads the whole stream from L2 (the stream
// is 9 bytes a write; 768 warps), which is what a sort would save.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // warps a block
constexpr int kUnroll = 4;     // 32-write loads in flight a lane

__global__ void __launch_bounds__(32 * kWarps) lru_scan_kernel(
    const long long* __restrict__ region, const unsigned char* __restrict__ unload,
    long long n, int mtt_sets, int mtt_ways, int tlb_sets, int tlb_ways,
    unsigned char* __restrict__ hit_out) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= mtt_sets + tlb_sets) return;
  const bool tlb = warp >= mtt_sets;
  const int set = tlb ? warp - mtt_sets : warp;
  const int n_sets = tlb ? tlb_sets : mtt_sets;
  const int n_ways = tlb ? tlb_ways : mtt_ways;
  const unsigned char want = tlb ? 1 : 0;
  const bool pow2 = (n_sets & (n_sets - 1)) == 0;

  long long tag = lane < n_ways ? -1 : -2;            // -2 never matches
  unsigned int stamp = lane < n_ways ? 0u : 0x7FFFFFFu;
  unsigned int clock = 0;

  for (long long base = 0; base < n; base += 32 * kUnroll) {
    long long r[kUnroll];
    bool mine[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * 32 + lane;
      r[u] = -1;
      mine[u] = false;
      if (i < n) {
        r[u] = region[i];
        const unsigned int ru = (unsigned int)r[u];
        const unsigned int s = pow2 ? (ru & (unsigned)(n_sets - 1))
                                    : ru % (unsigned)n_sets;
        mine[u] = (unload[i] != 0) == (want != 0) && (int)s == set;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned int todo = __ballot_sync(0xffffffffu, mine[u]);
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const long long reg = __shfl_sync(0xffffffffu, r[u], j);
        ++clock;
        const unsigned int hits = __ballot_sync(0xffffffffu, tag == reg);
        int way;
        if (hits) {
          way = __ffs(hits) - 1;
        } else {
          const unsigned int key = (stamp << 5) | (unsigned)lane;
          way = (int)(__reduce_min_sync(0xffffffffu, key) & 31u);
        }
        if (lane == way) {
          tag = reg;
          stamp = clock;
        }
        if (lane == 0) hit_out[base + u * 32 + j] = hits ? 1 : 0;
      }
    }
  }
}

// The fastest dependent step of the scan, for its bound: one warp runs
// `steps` steps of the loop-carried chain alone (the region by a shuffle,
// the probe ballot, the LRU min-reduce on a miss, the way's update), with no
// loads, no filtering and no stores but one at the end. miss == 0: lane 0's
// region every step, so every step after the first hits; miss != 0: the 32
// lanes' regions in turn through n_ways <= 31 ways, so every step misses.
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
      const unsigned int key = (stamp << 5) | (unsigned)lane;
      way = (int)(__reduce_min_sync(0xffffffffu, key) & 31u);
    }
    if (lane == way) {
      tag = reg;
      stamp = clock;
    }
  }
  out[lane] = tag * 32 + stamp;
}

}  // namespace

// One warp of lru_step_probe_kernel; out is int64[32]. Returns
// cudaGetLastError() after the launch.
extern "C" int lru_step_probe_launch(long long steps, int n_ways, int miss,
                                     long long* out, void* stream) {
  if (steps <= 0 || steps >= (1ll << 27) || n_ways <= 0 || n_ways > 31)
    return (int)cudaErrorInvalidValue;
  lru_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, n_ways, miss, out);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 = launched). Regions are
// non-negative and below 2^31; n < 2^27 keeps stamp * 32 + lane in 32 bits.
extern "C" int lru_scan_launch(const long long* region,
                               const unsigned char* unload, long long n,
                               int mtt_sets, int mtt_ways, int tlb_sets,
                               int tlb_ways, unsigned char* hit_out,
                               void* stream) {
  if (n <= 0 || n >= (1ll << 27) || mtt_sets <= 0 || tlb_sets <= 0 ||
      mtt_ways <= 0 || mtt_ways > 32 || tlb_ways <= 0 || tlb_ways > 32)
    return (int)cudaErrorInvalidValue;
  const int warps = mtt_sets + tlb_sets;
  const int blocks = (warps + kWarps - 1) / kWarps;
  lru_scan_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      region, unload, n, mtt_sets, mtt_ways, tlb_sets, tlb_ways, hit_out);
  return (int)cudaGetLastError();
}
