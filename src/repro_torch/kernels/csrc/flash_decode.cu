// flash_decode: one-query attention over a dense per-slot KV cache (the lanes
// layout's decode read), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode (_decode_kernel):
//   out[b,hq,:] = softmax_t( q[b,hq,:] . k[b,t,hq/G,:] * D^-1/2, masked to
//                 -1e30 where !kv_mask[b,t] ) @ v[b,t,hq/G,:]
//
// What bounds it on this card: bytes. Each K/V row is used by the G query
// heads of its group for 2 * G * D FLOP against 2 * D * elemsize bytes; the
// whole call is a read of the live part of the cache. So the design reads
// each live row once and nothing else:
//   * one block per (KV-time split, KV head, slot) serves the head's whole
//     GQA group, so each K/V row leaves device memory once;
//   * the cache's time axis is split across blocks (the "partial" mode the
//     JAX module names): 8 slots x 8 KV heads are 64 (slot, head) pairs,
//     far fewer than 132 SMs, so without the split most of the card would
//     idle. Each split keeps a running (max, sum, fp32 accumulator); a second
//     small kernel merges the splits by log-sum-exp;
//   * a key's D-element row is read by a group of lanes, 16 bytes each
//     (a head_dim of 120 bf16 values is 15 pieces: the group is 16 lanes and
//     one idles), and several keys' loads are issued before the first is used;
//   * masked keys are not read. A key that is masked scores -1e30 in the
//     plain version, which adds exactly 0 wherever the slot has a live key;
//     only a slot with no live key at all (a dead slot of the paged reference
//     read) needs them, and there every key counts once, as the plain
//     version's uniform mean over all T rows. Each block first ORs its slot's
//     mask to know which case it is in.
// The probabilities stay in fp32 (online form); the plain version rounds the
// normalised ones to the I/O type before P.V, so in bf16 the two differ by
// about one output ulp, and the kernel sits nearer an fp32 reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;  // keys in flight per lane group
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

struct Geometry {
  int Hq, Hkv, T, D, G, lpk, n_split, kps;  // lpk: lanes per key (power of 2)
};

// merge (m2, l2, a2) into (m, l, a): the log-sum-exp combine
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2,
                                      float l2, const float* a2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float w1 = expf(m - mn), w2 = expf(m2 - mn);
  l = l * w1 + l2 * w2;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * w1 + a2[e] * w2;
  m = mn;
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, Geometry g,
    float scale) {
  constexpr int kVec = Io<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lpk = g.lpk, kpi = kThreads / lpk;  // keys per block iteration
  const int kq = tid / lpk, d0 = (tid - kq * lpk) * kVec;
  const bool has_d = d0 < g.D;
  const int dw = lpk * kVec;  // padded row width held by a lane group
  float* red_ml = reinterpret_cast<float*>(smem_raw);  // [kWarps][kRows][2]
  float* red_acc = red_ml + kWarps * kRows * 2;        // [kWarps][kRows][dw]
  const int t_begin = split * g.kps, t_end = min(g.T, t_begin + g.kps);
  const unsigned char* mrow = mask + (long long)b * g.T;

  // does the slot have a live key anywhere? If not, every key counts
  int any = 0;
  for (int t = tid; t < g.T; t += kThreads) any |= mrow[t];
  const bool live_any = __syncthreads_or(any) != 0;

  for (int r0 = 0; r0 < g.G; r0 += kRows) {
    float qreg[kRows][kVec];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (has_d && r0 + j < g.G)
        raw = *reinterpret_cast<const uint4*>(
            q + ((long long)b * g.Hq + h * g.G + r0 + j) * g.D + d0);
      Io<T>::unpack(raw, qreg[j]);
    }
    float m[kRows], l[kRows], acc[kRows][kVec];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
    }
    for (int t0 = t_begin; t0 < t_end; t0 += kpi * kAhead) {
      uint4 kraw[kAhead], vraw[kAhead];
      bool ok[kAhead], use[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int t = t0 + u * kpi + kq;
        const bool in = t < t_end;
        ok[u] = in && mrow[t] != 0;
        use[u] = in && (ok[u] || !live_any);
        const long long off = (((long long)b * g.T + t) * g.Hkv + h) * g.D + d0;
        kraw[u] = (ok[u] && has_d) ? *reinterpret_cast<const uint4*>(k + off)
                                   : make_uint4(0, 0, 0, 0);
        vraw[u] = (use[u] && has_d) ? *reinterpret_cast<const uint4*>(v + off)
                                    : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        float kf[kVec], vf[kVec];
        Io<T>::unpack(kraw[u], kf);
        Io<T>::unpack(vraw[u], vf);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot = fmaf(qreg[j][e], kf[e], dot);
          for (int off = lpk >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(kFull, dot, off);
          if (use[u]) {
            const float s = ok[u] ? dot * scale : kMasked;
            const float mn = fmaxf(m[j], s);
            const float alpha = expf(m[j] - mn);
            const float p = expf(s - mn);
            l[j] = l[j] * alpha + p;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e] * alpha);
            m[j] = mn;
          }
        }
      }
    }
    // merge the lane groups of a warp, then the warps through shared memory
    for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float a2[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) a2[e] = __shfl_xor_sync(kFull, acc[j][e], off);
        const float m2 = __shfl_xor_sync(kFull, m[j], off);
        const float l2 = __shfl_xor_sync(kFull, l[j], off);
        merge<kVec>(m[j], l[j], acc[j], m2, l2, a2);
      }
    }
    if (lane < lpk) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (lane == 0) {
          red_ml[(warp * kRows + j) * 2] = m[j];
          red_ml[(warp * kRows + j) * 2 + 1] = l[j];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          red_acc[(warp * kRows + j) * dw + d0 + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int o = tid; o < kRows * g.D; o += kThreads) {
      const int j = o / g.D, d = o - j * g.D;
      if (r0 + j >= g.G) continue;
      float mm = -INFINITY, ll = 0.f, aa = 0.f;
      for (int w = 0; w < kWarps; ++w)
        merge<1>(mm, ll, &aa, red_ml[(w * kRows + j) * 2],
                 red_ml[(w * kRows + j) * 2 + 1], &red_acc[(w * kRows + j) * dw + d]);
      const long long row = (long long)b * g.Hq + h * g.G + r0 + j;
      if (g.n_split == 1) {
        out[row * g.D + d] = Io<T>::from_float(aa / ll);
      } else {
        part_acc[(row * g.n_split + split) * g.D + d] = aa;
        if (d == 0) {
          part_ml[(row * g.n_split + split) * 2] = mm;
          part_ml[(row * g.n_split + split) * 2 + 1] = ll;
        }
      }
    }
    __syncthreads();
  }
}

// out[b,hq,:] from the splits' (max, sum, accumulator)
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int D, int n_split) {
  const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
    for (int i = 0; i < n_split; ++i)
      merge<1>(mm, ll, &aa, ml[2 * i], ml[2 * i + 1],
               &part_acc[(row * n_split + i) * D + d]);
    out[row * D + d] = Io<T>::from_float(aa / ll);
  }
}

template <typename T, int kRows>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask,
           void* out, float* part_acc, float* part_ml, int B, const Geometry& g,
           float scale, cudaStream_t s) {
  const size_t bytes =
      (size_t)kWarps * kRows * (2 + g.lpk * Io<T>::kVec) * sizeof(float);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_decode_kernel<T, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dense_decode_kernel<T, kRows><<<dim3(g.n_split, g.Hkv, B), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(out), part_acc, part_ml, g, scale);
  if (g.n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    combine_kernel<T><<<dim3(g.Hq, B), kThreads, 0, s>>>(
        part_acc, part_ml, static_cast<T*>(out), g.D, g.n_split);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const unsigned char* mask,
             void* out, float* part_acc, float* part_ml, int B, const Geometry& g,
             float scale, cudaStream_t s) {
#define LAUNCH(N) \
  return launch<T, N>(q, k, v, mask, out, part_acc, part_ml, B, g, scale, s)
  if (g.G <= 1) LAUNCH(1);
  if (g.G <= 2) LAUNCH(2);
  if (g.G <= 4) LAUNCH(4);
  LAUNCH(8);
#undef LAUNCH
}

}  // namespace

// q [B,Hq,D], k/v [B,T,Hkv,D], mask bool [B,T], out [B,Hq,D], all contiguous.
// dtype: 0 = float32, 1 = bfloat16. lpk = lanes per key: a power of two
// <= 32 with lpk * (16 / sizeof(T)) >= D; D * sizeof(T) a multiple of 16.
// The time axis is cut into n_split pieces of kps keys; with n_split > 1,
// part_acc [B,Hq,n_split,D] and part_ml [B,Hq,n_split,2] (fp32) are scratch.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const unsigned char* mask,
    void* out, float* part_acc, float* part_ml, int B, int Hq, int Hkv, int T,
    int D, int lpk, int n_split, int kps, float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || T <= 0 || D <= 0 || B > 65535 ||
      Hkv > 65535 || Hq > 65535 || lpk < 1 || lpk > 32 || (lpk & (lpk - 1)) ||
      n_split < 1 || kps < 1 || (long long)n_split * kps < T ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.Hq = Hq; g.Hkv = Hkv; g.T = T; g.D = D; g.G = Hq / Hkv;
  g.lpk = lpk; g.n_split = n_split; g.kps = kps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4 || lpk * 4 < D) return (int)cudaErrorInvalidValue;
    return dispatch<float>(q, k, v, mask, out, part_acc, part_ml, B, g, scale, s);
  }
  if (dtype == 1) {
    if (D % 8 || lpk * 8 < D) return (int)cudaErrorInvalidValue;
    return dispatch<__nv_bfloat16>(q, k, v, mask, out, part_acc, part_ml, B, g,
                                   scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
