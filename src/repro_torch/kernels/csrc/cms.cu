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
