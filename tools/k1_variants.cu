// Variants of K1's drain (staged_scatter.cu) for tools/k1_variants.py: the
// kept vector copy at kLayers x kPer 16-byte loads a thread, and a TMA bulk
// copy (cp.async.bulk global -> shared -> global), kL layers a block.
// 16-byte rows, int64 rows, contiguous routing only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kMaxPlanes = 32;
struct Plane {
  unsigned char* dest; const unsigned char* staging;
  long long dest_layer, staging_layer; int n_vec, n_layers, n_rows;
};
struct Table { Plane p[kMaxPlanes]; };

template <int kLayers, int kPer>
__global__ void __launch_bounds__(256) vec_kernel(const __grid_constant__ Table t,
    const long long* __restrict__ dst_row, const unsigned char* __restrict__ valid) {
  using U = uint4;
  const Plane& p = t.p[blockIdx.z];
  const int l0 = blockIdx.y * kLayers;
  if (l0 >= p.n_layers) return;
  const long long i = blockIdx.x;
  const unsigned char ok = valid[i];
  const long long r = dst_row[i];
  if (!ok || r < 0 || r >= p.n_rows) return;
  const int nl = min(kLayers, p.n_layers - l0);
  const int n = p.n_vec;
  const U* src = reinterpret_cast<const U*>(p.staging + l0 * p.staging_layer) + i * n;
  U* dst = reinterpret_cast<U*>(p.dest + l0 * p.dest_layer) + r * n;
  const long long sl = p.staging_layer / 16, dl = p.dest_layer / 16;
  const int step = kPer * blockDim.x;
  for (int base = threadIdx.x; base < n; base += step) {
    U v[kLayers][kPer];
#pragma unroll
    for (int l = 0; l < kLayers; ++l)
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = base + k * blockDim.x;
        if (l < nl && j < n) v[l][k] = __ldcs(src + l * sl + j);
      }
#pragma unroll
    for (int l = 0; l < kLayers; ++l)
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = base + k * blockDim.x;
        if (l < nl && j < n) dst[l * dl + j] = v[l][k];
      }
  }
}

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int kL>
__global__ void __launch_bounds__(32) tma_kernel(const __grid_constant__ Table t,
    const long long* __restrict__ dst_row, const unsigned char* __restrict__ valid) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  const Plane& p = t.p[blockIdx.z];
  const int l0 = blockIdx.y * kL;
  if (l0 >= p.n_layers) return;
  const long long i = blockIdx.x;
  const unsigned char ok = valid[i];
  const long long r = dst_row[i];
  if (!ok || r < 0 || r >= p.n_rows) return;
  if (threadIdx.x != 0) return;
  const int nl = min(kL, p.n_layers - l0);
  const uint32_t bytes = (uint32_t)p.n_vec * 16u;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sa(&bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(sa(&bar)), "r"(bytes * nl) : "memory");
  for (int l = 0; l < nl; ++l) {
    const unsigned char* src = p.staging + (l0 + l) * p.staging_layer + i * bytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(sa(buf + l * bytes)), "l"(src), "r"(bytes), "r"(sa(&bar)) : "memory");
  }
  asm volatile(
      "{\n .reg .pred P;\n W: mbarrier.try_wait.parity.shared::cta.b64 P, [%0], 0;\n"
      " @!P bra W;\n}" :: "r"(sa(&bar)) : "memory");
  for (int l = 0; l < nl; ++l) {
    unsigned char* dst = p.dest + (l0 + l) * p.dest_layer + r * bytes;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(sa(buf + l * bytes)), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <int kLayers, int kPer>
int go_vec(const Table& t, int np, int ml, int n, const long long* rows,
           const unsigned char* ok, int vecs, cudaStream_t s) {
  int th = ((vecs + kPer - 1) / kPer + 31) / 32 * 32; if (th > 256) th = 256;
  dim3 g(n, (ml + kLayers - 1) / kLayers, np);
  vec_kernel<kLayers, kPer><<<g, th, 0, s>>>(t, rows, ok);
  return (int)cudaGetLastError();
}
template <int kL>
int go_tma(const Table& t, int np, int ml, int n, const long long* rows,
           const unsigned char* ok, int vecs, cudaStream_t s) {
  const int sm = kL * vecs * 16;
  cudaFuncSetAttribute(tma_kernel<kL>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
  dim3 g(n, (ml + kL - 1) / kL, np);
  tma_kernel<kL><<<g, 32, sm, s>>>(t, rows, ok);
  return (int)cudaGetLastError();
}
}  // namespace

// variant: 0 vec 8x2 (kept), 1 vec 8x4, 2 vec 4x4, 3 tma 1 layer, 4 tma 4,
// 5 tma 8. Two planes or more, 16-byte rows, int64 rows, contiguous routing.
extern "C" int k1v_launch(int variant, int np, void* const* dest,
    const void* const* staging, long long row_bytes, long long dest_layer,
    long long staging_layer, int n_layers, int n_rows, const long long* rows,
    const unsigned char* ok, int n, void* stream) {
  Table t = {};
  for (int j = 0; j < np; ++j) {
    t.p[j].dest = static_cast<unsigned char*>(dest[j]);
    t.p[j].staging = static_cast<const unsigned char*>(staging[j]);
    t.p[j].dest_layer = dest_layer; t.p[j].staging_layer = staging_layer;
    t.p[j].n_vec = (int)(row_bytes / 16); t.p[j].n_layers = n_layers;
    t.p[j].n_rows = n_rows;
  }
  const int v = (int)(row_bytes / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return go_vec<8, 2>(t, np, n_layers, n, rows, ok, v, s);
    case 1: return go_vec<8, 4>(t, np, n_layers, n, rows, ok, v, s);
    case 2: return go_vec<4, 4>(t, np, n_layers, n, rows, ok, v, s);
    case 3: return go_tma<1>(t, np, n_layers, n, rows, ok, v, s);
    case 4: return go_tma<4>(t, np, n_layers, n, rows, ok, v, s);
    case 5: return go_tma<8>(t, np, n_layers, n, rows, ok, v, s);
  }
  return (int)cudaErrorInvalidValue;
}
