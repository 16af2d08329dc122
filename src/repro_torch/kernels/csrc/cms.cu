// cms_update (K5) and cms_query (K6): the count-min sketch's hot path, for
// Hopper (sm_90a).
//
// counts int32[depth][2^k], depth <= 4; hash_r(x) = ((uint32)x * A_r + B_r)
// >> (32 - k), 0 when k = 0 (a shift by 32 is undefined in C++; JAX gives 0).
// Ids are int32 or int64; their low 32 bits are hashed, so a negative id is
// taken as its uint32 bits, as JAX's astype(uint32) does.
//
// K5: counts[r][hash_r(ids[i])] += 1 for every i with mask[i] (no mask: all)
// and every row r, in place: one global atomicAdd per (id, row), its result
// unused, so it compiles to a reduction. Integer atomicAdd is exact and
// independent of order, so the result equals the sequential sum bit for bit.
// (A shared-memory histogram per row would pay where a batch brings several
// ids per bin of a narrow row; no workload of the repo does.)
//
// K6: est[i] = min_r counts[r][hash_r(ids[i])], one thread per id; a launch
// of its own after K5, so it sees the whole batch's counts.
//
// cms_update_query: the CMS monitor's whole step (CMSMonitor.update, then
// .query, of src/repro/core/monitor.py) in one launch, in this order: add
// every unmasked id to every row; count the unmasked ids; total_out =
// total_in + count; where decay_every > 0 and (total_out % e) < (total_in %
// e), floor-halve every counter; est[i] = min_r counts[r][hash_r(ids[i])]
// for every id, masked ones included. Each query must see every add and the
// halving, so the steps are separated by grid-wide barriers: the grid is one
// thread-block cluster (at most 16 blocks) whose threads stride over the ids
// and the counters, with barrier.cluster arrive.release / wait.acquire
// after the adds and, in a batch that halves, after the halving
// (__syncthreads when the cluster is one block). Every block counts the
// batch's unmasked ids itself while its adds drain (n without a mask; else
// a popcount over the whole mask), so every thread decides the halving from
// the same total_in and count, a batch that does not halve pays one
// barrier, and no block reads another's count or any global scratch.
// Counters written in this launch are read with ld.global.cg (L2), never
// through the non-coherent read-only path. Where the grid has a thread for
// every id (an engine batch of 4096 ids: 16 blocks of 256), each thread
// keeps its id's buckets in registers from its adds to its query.
// Bound: bytes, as K5 + K6 (the touched counter sectors once each way, the
// ids once, the estimates once; the whole table both ways when it halves).
// At an engine batch it is bound by latency (the id load, the adds' drain
// at the barrier, the gathers), in one launch where CMSMonitor.update then
// .query take nine. One cluster is at most 16 SMs, so at 2^20 ids it is several times
// slower than K5 + K6, which spread over the whole card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__constant__ uint32_t kMul[4] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                 0x27D4EB2Fu};
__constant__ uint32_t kOff[4] = {0x165667B1u, 0xD3A2646Du, 0xFD7046C5u,
                                 0xB55A4F09u};

__device__ __forceinline__ uint32_t cms_hash(uint32_t x, int r, int k) {
  const uint32_t h = x * kMul[r] + kOff[r];
  return k == 0 ? 0u : (h >> (32 - k));
}

template <typename Id>
__global__ void __launch_bounds__(kThreads) update_kernel(
    int* __restrict__ counts, const Id* __restrict__ ids,
    const unsigned char* __restrict__ mask, long long n, int depth, int k) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (mask != nullptr && !mask[i])) return;
  const uint32_t x = (uint32_t)ids[i];
  const long long width = 1ll << k;
  for (int r = 0; r < depth; ++r)
    atomicAdd(&counts[r * width + cms_hash(x, r, k)], 1);
}

template <typename Id>
__global__ void __launch_bounds__(kThreads) query_kernel(
    const int* __restrict__ counts, const Id* __restrict__ ids,
    int* __restrict__ out, long long n, int depth, int k) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)ids[i];
  const long long width = 1ll << k;
  int est = __ldg(&counts[cms_hash(x, 0, k)]);
  for (int r = 1; r < depth; ++r)
    est = min(est, __ldg(&counts[r * width + cms_hash(x, r, k)]));
  out[i] = est;
}

template <typename Id>
int launch_update(int* counts, const void* ids, const unsigned char* mask,
                  long long n, int depth, int k, cudaStream_t s) {
  const long long bx = (n + kThreads - 1) / kThreads;
  update_kernel<Id><<<(unsigned)bx, kThreads, 0, s>>>(
      counts, static_cast<const Id*>(ids), mask, n, depth, k);
  return (int)cudaGetLastError();
}

template <typename Id>
int launch_query(const int* counts, const void* ids, int* out, long long n,
                 int depth, int k, cudaStream_t s) {
  const long long bx = (n + kThreads - 1) / kThreads;
  query_kernel<Id><<<(unsigned)bx, kThreads, 0, s>>>(
      counts, static_cast<const Id*>(ids), out, n, depth, k);
  return (int)cudaGetLastError();
}

// Floor modulo, as torch's % on int64 (the totals are never negative in
// the monitor, but the plain version is matched for any input).
__device__ __forceinline__ long long floor_mod(long long a, long long e) {
  const long long r = a % e;
  return r < 0 ? r + e : r;
}

// Barrier over the grid (= the cluster) with release/acquire ordering of
// global and shared memory.
__device__ __forceinline__ void grid_barrier(
    cooperative_groups::cluster_group& c) {
  if (gridDim.x == 1)
    __syncthreads();
  else
    c.sync();
}

// The batch's count of unmasked ids, taken by every block over the whole
// mask (4 bytes a load where the mask is 4-byte aligned; a bool is 0 or 1,
// so a word's popcount is its count), so that every thread knows the
// halving at the first barrier and no block needs another's count.
__device__ unsigned long long batch_count(const unsigned char* mask,
                                          long long n, unsigned int* scratch) {
  if (mask == nullptr) return (unsigned long long)n;
  if (threadIdx.x == 0) *scratch = 0;
  __syncthreads();
  unsigned int mine = 0;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(mask);
    const long long n_words = n >> 2;
    for (long long w = threadIdx.x; w < n_words; w += blockDim.x)
      mine += __popc(words[w]);
    head = n_words << 2;
  }
  for (long long i = head + threadIdx.x; i < n; i += blockDim.x)
    mine += mask[i] != 0;
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if ((threadIdx.x & 31) == 0 && mine != 0) atomicAdd(scratch, mine);
  __syncthreads();
  return *scratch;
}

template <typename Id>
__global__ void __launch_bounds__(1024) update_query_kernel(
    int* __restrict__ counts, const Id* __restrict__ ids,
    const unsigned char* __restrict__ mask,
    const long long* __restrict__ total_in, long long* __restrict__ total_out,
    int* __restrict__ est, long long n, int depth, int k,
    long long decay_every, int vec_ok) {
  __shared__ unsigned int scratch;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const long long width = 1ll << k;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long before = __ldg(total_in);

  // 1. add every unmasked id to every row. Where the grid has a thread for
  // every id (an engine batch), the thread keeps its buckets in registers
  // for the query.
  const bool one_each = n <= stride;
  long long bucket[4] = {0, 0, 0, 0};
  if (one_each) {
    if (first < n) {
      const uint32_t x = (uint32_t)ids[first];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < depth) bucket[r] = r * width + cms_hash(x, r, k);
      if (mask == nullptr || mask[first])
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < depth) atomicAdd(&counts[bucket[r]], 1);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      if (mask != nullptr && !mask[i]) continue;
      const uint32_t x = (uint32_t)ids[i];
      for (int r = 0; r < depth; ++r)
        atomicAdd(&counts[r * width + cms_hash(x, r, k)], 1);
    }
  }
  // 2-3. the count, the total, and from them whether the counters halve:
  // the same total_in and count in every thread (taken while the adds
  // drain)
  const long long after = before + (long long)batch_count(mask, n, &scratch);
  if (first == 0) *total_out = after;
  const bool decay = decay_every > 0 && floor_mod(after, decay_every) <
                                            floor_mod(before, decay_every);
  grid_barrier(cluster);  // every add is done

  // 4. floor-halve every counter where the total crossed a multiple of e;
  // four loads in flight before their stores
  if (decay) {
    const long long m = (long long)depth << k;
    if (vec_ok) {
      int4* c4 = reinterpret_cast<int4*>(counts);
      const long long m4 = m >> 2;
      for (long long j = first; j < m4; j += 4 * stride) {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + u * stride < m4) v[u] = __ldcg(&c4[j + u * stride]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j + u * stride < m4) {
            // arithmetic shifts: floor
            v[u].x >>= 1; v[u].y >>= 1; v[u].z >>= 1; v[u].w >>= 1;
            __stcg(&c4[j + u * stride], v[u]);
          }
      }
    } else {
      for (long long j = first; j < m; j += stride)
        __stcg(&counts[j], __ldcg(&counts[j]) >> 1);
    }
    grid_barrier(cluster);  // every counter is halved
  }

  // 5. every id's estimate from the updated counters (through L2)
  if (one_each) {
    if (first < n) {
      int e = __ldcg(&counts[bucket[0]]);
#pragma unroll
      for (int r = 1; r < 4; ++r)
        if (r < depth) e = min(e, __ldcg(&counts[bucket[r]]));
      est[first] = e;
    }
    return;
  }
  for (long long i = first; i < n; i += stride) {
    const uint32_t x = (uint32_t)ids[i];
    int e = __ldcg(&counts[cms_hash(x, 0, k)]);
    for (int r = 1; r < depth; ++r)
      e = min(e, __ldcg(&counts[r * width + cms_hash(x, r, k)]));
    est[i] = e;
  }
}

template <typename Id>
int launch_update_query(int* counts, const void* ids,
                        const unsigned char* mask, const long long* total_in,
                        long long* total_out, int* est, long long n,
                        int depth, int k, long long decay_every, int blocks,
                        int threads, cudaStream_t s) {
  auto kernel = update_query_kernel<Id>;
  if (blocks > 8) {  // past the portable cluster size (on the current device)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  const long long m = (long long)depth << k;
  const int vec_ok = (m % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(counts) % 16 == 0);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, counts, static_cast<const Id*>(ids), mask, total_in,
      total_out, est, n, depth, k, decay_every, vec_ok);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_args(long long n, int depth, int k, int id_bytes) {
  return n <= 0 || n > (long long)kThreads * 0x7FFFFFFFll || depth < 1 ||
         depth > 4 || k < 0 || k > 30 || (id_bytes != 4 && id_bytes != 8);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched). mask may
// be null (every id counts).
extern "C" int cms_update_launch(int* counts, const void* ids, int id_bytes,
                                 const unsigned char* mask, long long n,
                                 int depth, int log2_width, void* stream) {
  if (bad_args(n, depth, log2_width, id_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    return launch_update<int32_t>(counts, ids, mask, n, depth, log2_width, s);
  return launch_update<int64_t>(counts, ids, mask, n, depth, log2_width, s);
}

extern "C" int cms_query_launch(const int* counts, const void* ids,
                                int id_bytes, int* out, long long n, int depth,
                                int log2_width, void* stream) {
  if (bad_args(n, depth, log2_width, id_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    return launch_query<int32_t>(counts, ids, out, n, depth, log2_width, s);
  return launch_query<int64_t>(counts, ids, out, n, depth, log2_width, s);
}

// The fused step: one cluster of `blocks` (1-16) blocks of `threads` (a
// multiple of 32, at most 1024) threads. counts is updated in place;
// total_out (a fresh int64 scalar) and est (int32[n]) are written. n at
// most 2^31 - 1 (the batch's count is taken in 32 bits a block). Returns
// the launch's error code (0 = launched).
extern "C" int cms_update_query_launch(
    int* counts, const long long* total_in, long long* total_out,
    const void* ids, int id_bytes, const unsigned char* mask, int* est,
    long long n, int depth, int log2_width, long long decay_every,
    int blocks, int threads, void* stream) {
  if (bad_args(n, depth, log2_width, id_bytes) || n > 0x7FFFFFFFll ||
      decay_every < 0 || blocks < 1 || blocks > 16 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    return launch_update_query<int32_t>(counts, ids, mask, total_in,
                                        total_out, est, n, depth, log2_width,
                                        decay_every, blocks, threads, s);
  return launch_update_query<int64_t>(counts, ids, mask, total_in, total_out,
                                      est, n, depth, log2_width, decay_every,
                                      blocks, threads, s);
}
