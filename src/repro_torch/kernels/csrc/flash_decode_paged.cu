// flash_decode_paged: fused paged-attention read, for Hopper (sm_90a).
//
// out[b,c,hq,:] = softmax_t( q[b,c,hq,:] . K[t,:] * scale, masked to -1e30 ) @ V
// over t in (pool rows reached through blocks[b,:]) U (ring lanes of slot b).
//
// One block per (KV head, slot) serves the head's whole GQA group and all C
// query columns, so each K/V row is read from device memory once per pass.
// Two passes over K keep the arithmetic of the plain version (fp32 scores ->
// mask to -1e30 -> fp32 softmax -> round to the I/O type -> weighted sum in
// fp32) without holding all scores in shared memory:
//   pass 1  running (max, sum) of every query row;
//   pass 2  p = exp(s - m) / l rounded to the I/O type, times V.
// Masked entries are scored -1e30, never skipped: an all-masked row comes
// out as the uniform mean over every view row and ring lane, as the plain
// version gives it.
//
// Thread layout: a key's [D] row is read by D / kVec neighbouring lanes, 16
// bytes each, so a warp reads whole 128-byte lines of a few rows (rows of one
// head lie Hkv * D elements apart). Each lane holds its slice of the query
// rows in registers, forms a partial dot product and the lanes of a key sum
// it by shuffles; every lane of the key then knows the score and scales its
// own 16 bytes of the V row. Several keys' loads are issued before the first
// is used. The partial (max, sum) and output sums of the keys handled by
// different lane groups are combined by shuffles inside a warp and through
// shared memory across warps. Query rows are processed kRows at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
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
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

struct Geometry {
  int C, Hq, Hkv, D, P, ps, R;
  int G, NR, n_view, Tn;
};

__device__ __forceinline__ void merge_ml(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) { l = 0.f; return; }
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pages_k,
    const T* __restrict__ pages_v, const int* __restrict__ blocks,
    const unsigned char* __restrict__ view_ok, const T* __restrict__ ring_k,
    const T* __restrict__ ring_v, const unsigned char* __restrict__ ring_ok,
    T* __restrict__ out, Geometry g, float scale) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kAhead1 = kRows >= 8 ? 4 : 8;  // keys in flight, pass 1
  constexpr int kAhead2 = kRows >= 8 ? 2 : 4;  // keys in flight, pass 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lpk = g.D / kVec;        // lanes sharing one key (power of two)
  const int kpi = kThreads / lpk;    // keys per iteration of the block
  const int kq = tid / lpk;          // this lane's key within an iteration
  const int d0 = (tid - kq * lpk) * kVec;
  const int red_w = g.D > 2 ? g.D : 2;
  float* q_s = reinterpret_cast<float*>(smem_raw);      // [NR][D]
  float* red = q_s + g.NR * g.D;                        // [kWarps][kRows][red_w]
  int* blk_s = reinterpret_cast<int*>(red + kWarps * kRows * red_w);  // [P]

  // query rows r = c * G + grp as fp32, and this slot's page table
  for (int i = tid; i < g.NR * g.D; i += kThreads) {
    const int r = i / g.D, d = i - r * g.D;
    const int c = r / g.G, grp = r - c * g.G;
    q_s[i] = Io<T>::to_float(
        q[(((long long)b * g.C + c) * g.Hq + h * g.G + grp) * g.D + d]);
  }
  for (int i = tid; i < g.P; i += kThreads) blk_s[i] = blocks[(long long)b * g.P + i];
  __syncthreads();

  // this lane's 16 bytes of key t's K (or V) row
  auto load_row = [&](const T* pages, const T* ring, int t) -> uint4 {
    long long off;
    const T* base;
    if (t < g.n_view) {
      const int page = t / g.ps;
      const long long row = (long long)blk_s[page] * g.ps + (t - page * g.ps);
      off = (row * g.Hkv + h) * g.D;
      base = pages;
    } else {
      off = (((long long)b * g.R + (t - g.n_view)) * g.Hkv + h) * g.D;
      base = ring;
    }
    return *reinterpret_cast<const uint4*>(base + off + d0);
  };

  const int n_iter = (g.Tn + kpi - 1) / kpi;
  for (int r0 = 0; r0 < g.NR; r0 += kRows) {
    float qreg[kRows][kVec];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        qreg[j][e] = (r0 + j < g.NR) ? q_s[(r0 + j) * g.D + d0 + e] : 0.f;
    }

    // scores of key t for the kRows rows; every lane of the key gets them
    auto scores = [&](const uint4& kraw, int t, bool in, float* s) {
      float kf[kVec];
      Io<T>::unpack(kraw, kf);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qreg[j][e], kf[e], dot);
        for (int off = lpk >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        bool ok = false;
        if (in && r0 + j < g.NR) {
          if (t < g.n_view) {
            const int c = (r0 + j) / g.G;
            ok = view_ok[((long long)b * g.C + c) * g.n_view + t] != 0;
          } else {
            ok = ring_ok[(long long)b * g.R + (t - g.n_view)] != 0;
          }
        }
        s[j] = ok ? dot * scale : kMasked;
      }
    };

    // ---- pass 1: running max and sum of each row ---------------------------
    float m[kRows], l[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) { m[j] = -INFINITY; l[j] = 0.f; }
    for (int it0 = 0; it0 < n_iter; it0 += kAhead1) {
      uint4 kraw[kAhead1];
#pragma unroll
      for (int u = 0; u < kAhead1; ++u) {
        const int t = (it0 + u) * kpi + kq;
        kraw[u] = t < g.Tn ? load_row(pages_k, ring_k, t) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kAhead1; ++u) {
        const int t = (it0 + u) * kpi + kq;
        const bool in = t < g.Tn;
        float s[kRows];
        scores(kraw[u], t, in, s);
        if (in) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) merge_ml(m[j], l[j], s[j], 1.f);
        }
      }
    }
    for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float m2 = __shfl_xor_sync(kFull, m[j], off);
        const float l2 = __shfl_xor_sync(kFull, l[j], off);
        merge_ml(m[j], l[j], m2, l2);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        red[(warp * kRows + j) * red_w] = m[j];
        red[(warp * kRows + j) * red_w + 1] = l[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      m[j] = red[j * red_w];
      l[j] = red[j * red_w + 1];
      for (int w = 1; w < kWarps; ++w)
        merge_ml(m[j], l[j], red[(w * kRows + j) * red_w],
                 red[(w * kRows + j) * red_w + 1]);
    }
    __syncthreads();

    // ---- pass 2: probabilities (rounded to T) times V ----------------------
    float acc[kRows][kVec];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
    }
    for (int it0 = 0; it0 < n_iter; it0 += kAhead2) {
      uint4 kraw[kAhead2], vraw[kAhead2];
#pragma unroll
      for (int u = 0; u < kAhead2; ++u) {
        const int t = (it0 + u) * kpi + kq;
        if (t < g.Tn) {
          kraw[u] = load_row(pages_k, ring_k, t);
          vraw[u] = load_row(pages_v, ring_v, t);
        } else {
          kraw[u] = make_uint4(0, 0, 0, 0);
          vraw[u] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead2; ++u) {
        const int t = (it0 + u) * kpi + kq;
        const bool in = t < g.Tn;
        float s[kRows];
        scores(kraw[u], t, in, s);
        if (in) {
          float vf[kVec];
          Io<T>::unpack(vraw[u], vf);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float p = Io<T>::round(expf(s[j] - m[j]) / l[j]);
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
          }
        }
      }
    }
    for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
      }
    }
    if (lane < lpk) {  // one lane group per warp holds the warp's sums
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          red[(warp * kRows + j) * red_w + d0 + e] = acc[j][e];
      }
    }
    __syncthreads();
    for (int o = tid; o < kRows * g.D; o += kThreads) {
      const int j = o / g.D, d = o - j * g.D;
      const int r = r0 + j;
      if (r < g.NR) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + j) * red_w + d];
        const int c = r / g.G, grp = r - c * g.G;
        out[(((long long)b * g.C + c) * g.Hq + h * g.G + grp) * g.D + d] =
            Io<T>::from_float(sum);
      }
    }
    __syncthreads();
  }
}

template <typename T, int kRows>
int launch(const void* q, const void* pages_k, const void* pages_v,
           const int* blocks, const unsigned char* view_ok, const void* ring_k,
           const void* ring_v, const unsigned char* ring_ok, void* out, int B,
           const Geometry& g, float scale, cudaStream_t stream) {
  const int red_w = g.D > 2 ? g.D : 2;
  const size_t bytes = ((size_t)g.NR * g.D + (size_t)kWarps * kRows * red_w) *
                           sizeof(float) +
                       (size_t)g.P * sizeof(int);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.Hkv, B);
  paged_decode_kernel<T, kRows><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k),
      static_cast<const T*>(pages_v), blocks, view_ok,
      static_cast<const T*>(ring_k), static_cast<const T*>(ring_v), ring_ok,
      static_cast<T*>(out), g, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* pages_k, const void* pages_v,
             const int* blocks, const unsigned char* view_ok,
             const void* ring_k, const void* ring_v,
             const unsigned char* ring_ok, void* out, int B, const Geometry& g,
             float scale, cudaStream_t stream) {
  const int lpk = g.D / Io<T>::kVec;
  if (g.D % Io<T>::kVec || lpk < 1 || lpk > 32 || (lpk & (lpk - 1)))
    return (int)cudaErrorInvalidValue;
#define LAUNCH(N)                                                            \
  return launch<T, N>(q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v, \
                      ring_ok, out, B, g, scale, stream)
  if (g.NR <= 1) LAUNCH(1);
  if (g.NR <= 2) LAUNCH(2);
  if (g.NR <= 4) LAUNCH(4);
  LAUNCH(8);
#undef LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. R = 0 means no ring (ring pointers unused).
// D / (16 / sizeof(T)) must be a power of two <= 32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_decode_paged_launch(
    const void* q, const void* pages_k, const void* pages_v, const int* blocks,
    const unsigned char* view_ok, const void* ring_k, const void* ring_v,
    const unsigned char* ring_ok, void* out, int B, int C, int Hq, int Hkv,
    int D, int P, int ps, int R, float scale, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || D <= 0 || Hq % Hkv != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.C = C; g.Hq = Hq; g.Hkv = Hkv; g.D = D; g.P = P; g.ps = ps; g.R = R;
  g.G = Hq / Hkv; g.NR = C * g.G; g.n_view = P * ps; g.Tn = g.n_view + R;
  if (g.Tn <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, pages_k, pages_v, blocks, view_ok, ring_k, ring_v,
                           ring_ok, out, B, g, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, pages_k, pages_v, blocks, view_ok, ring_k,
                                   ring_v, ring_ok, out, B, g, scale, s);
  return (int)cudaErrorInvalidValue;
}
