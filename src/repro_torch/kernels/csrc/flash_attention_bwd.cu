// flash_attention_bwd: the backward of K3 (flash_attention.cu), for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes this gradient by autodiff of
// layers.sdpa (its Pallas kernels have no custom_vjp). The port runs K3 where
// the JAX package runs sdpa's prefill, so training needs K3's adjoint on the
// card. Given q [B,Hq,S,D], k/v [B,Hkv,T,D], the forward's out and its
// per-row log-sum-exp lse [B,Hq,S] (fp32), and dout like out, it computes
// dq, dk, dv of out = softmax(q.k^T * scale, masked) v, with the forward's
// masks (causal with the queries at the end of the keys, off = T - S; a
// sliding window; GQA by index, kv head = q head / G). The FlashAttention-2
// form, three launches:
//   1. delta[b,h,i] = sum_d dout * out, fp32 (one thread a row, the sum in
//      the order of the dP products below);
//   2. dK / dV: one block per (batch, KV head, 64-key tile). It walks the
//      64-row query tiles of all G query heads of its group that can see the
//      tile (the causal diagonal and the window rule the others out, as in
//      the forward), recomputes P = exp(q.k * scale - lse) (0 where masked),
//      and forms dV += P^T dO, dP = dO V^T, dS = P (dP - delta),
//      dK += dS^T Q * scale. GQA is summed inside the block in a fixed
//      order, with no atomics: the result repeats bit for bit;
//   3. dQ: one block per (batch, q head, 64-row query tile), over the key
//      tiles the forward walks, dQ += dS K * scale.
// Everything accumulates in fp32 from fp32 or bf16 inputs; the outputs are in
// the inputs' dtype. What bounds it on this card: the larger of 10 * D FLOP
// a live (q, k) pair and head (the two score products again, then dV, dK,
// dQ) at the tensor cores' rate and one read of q, k, v, out, dout, lse and
// one write of dq, dk, dv: bytes at the training shapes (S = 512, D = 64).
// This first design runs on CUDA cores: tiles of 64 x 64 in shared memory
// (fp32, rows padded by one so that 16 threads reading 16 rows hit 16 banks),
// each thread a 4 x 4 block of the score tiles and a 4 x (D / 16) block of
// the 64 x D accumulators, in registers sized to the head (two blocks an SM
// at D <= 64). wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // query rows and keys of a tile
constexpr int kThreads = 256;  // 16 x 16 threads
// columns a thread owns of a 64 x D accumulator: d = td + 16 c for c < kC,
// kC = 4 for D <= 64 and 8 for D <= 128 (a template parameter, so that a
// 64-wide head keeps half the accumulators in registers: two blocks an SM)

struct Geom {
  int Hq, Hkv, S, T, D, G, causal, window, off;  // off = T - S
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool allowed(const Geom& g, int qa, int kpos) {
  return kpos < g.T && (!g.causal || kpos <= qa) &&
         (g.window <= 0 || kpos > qa - g.window);
}

// rows [0, n) of a [kB][D + 1] fp32 tile from rows r0.. of a strided tensor
// (rows past `limit` read as zeros)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int r0, int limit, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < limit ? to_f(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// the two score products of a tile pair, a thread's 4 x 4 block: rows
// tq + 16 i, keys tk + 16 j. s = Q.K^T, dp = dO.V^T
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int D, int tq, int tk,
                                       float s[4][4], float dp[4][4]) {
  const int ld = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float q[4], o[4], k[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = Qs[(tq + 16 * i) * ld + d];
      o[i] = dOs[(tq + 16 * i) * ld + d];
      k[i] = Ks[(tk + 16 * i) * ld + d];
      v[i] = Vs[(tk + 16 * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i], k[j], s[i][j]);
        dp[i][j] = fmaf(o[i], v[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dout * out)
// ---------------------------------------------------------------------------

// One thread a row, summing over d in order with one fma a column: the
// order in which `scores` forms each dP, so where the two sums meet the same
// values (a row that sees one key, whose out is that key's v) dP - delta
// cancels to exactly 0, as the softmax's own backward gives
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    int B, Geom g) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (long long)B * g.Hq * g.S) return;
  const int i = (int)(row % g.S);
  const int h = (int)((row / g.S) % g.Hq);
  const int b = (int)(row / ((long long)g.S * g.Hq));
  const T* orow = o + b * g.o_sb + h * g.o_sh + (long long)i * g.o_ss;
  const T* drow = dout + b * g.do_sb + h * g.do_sh + (long long)i * g.do_ss;
  float acc = 0.f;
  for (int d = 0; d < g.D; ++d) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
  delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (key tile, KV head, batch)
// ---------------------------------------------------------------------------

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kC == 4 ? 2 : 1) attn_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  extern __shared__ __align__(16) float sm[];
  const int D = g.D, ld = D + 1;
  float* Ks = sm;                 // [kB][D + 1]
  float* Vs = Ks + kB * ld;
  float* Qs = Vs + kB * ld;
  float* dOs = Qs + kB * ld;
  float* Ps = dOs + kB * ld;      // [kB rows][kB + 1 keys]
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);  // [kB]
  float* del_s = lse_s + kB;

  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tq = tid / 16, tk = tid % 16;
  load_tile(Ks, k + b * g.k_sb + hk * g.k_sh, g.k_st, k0, g.T, D);
  load_tile(Vs, v + b * g.v_sb + hk * g.v_sh, g.v_st, k0, g.T, D);

  float acc_k[4][kC], acc_v[4][kC];  // keys tk + 16 j, columns tq + 16 c
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  // the query rows that can see a key of [k0, k0 + kB)
  const int k_last = min(k0 + kB, g.T) - 1;
  const int q_lo = g.causal ? max(0, k0 - g.off) : 0;
  const int q_hi = g.window > 0 ? min(g.S - 1, k_last + g.window - 1 - g.off) : g.S - 1;
  for (int hh = 0; hh < g.G; ++hh) {
    const int h = hk * g.G + hh;
    const T* qh = q + b * g.q_sb + h * g.q_sh;
    const T* doh = dout + b * g.do_sb + h * g.do_sh;
    const float* lse_h = lse + ((long long)b * g.Hq + h) * g.S;
    const float* del_h = delta + ((long long)b * g.Hq + h) * g.S;
    for (int qt = q_lo / kB; q_lo <= q_hi && qt <= q_hi / kB; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile is no longer read
      load_tile(Qs, qh, g.q_ss, q0, g.S, D);
      load_tile(dOs, doh, g.do_ss, q0, g.S, D);
      if (tid < kB) {
        const bool in = q0 + tid < g.S;
        lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
        del_s[tid] = in ? del_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores(Qs, dOs, Ks, Vs, D, tq, tk, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tq + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tk + 16 * j;
          const bool live = row < g.S && allowed(g, row + g.off, k0 + key);
          const float p = live ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
          Ps[r * (kB + 1) + key] = p;
          dSs[r * (kB + 1) + key] = p * (dp[i][j] - del_s[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's rows: summed for the tile
      // first, then added to the totals (a sum of up to G * S terms kept in
      // two levels, so its rounding grows with sqrt(64) + sqrt(tiles), not
      // with sqrt(G * S))
      float tile_k[4][kC], tile_v[4][kC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < kC; ++c) tile_k[j][c] = tile_v[j][c] = 0.f;
      for (int r = 0; r < kB; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = Ps[r * (kB + 1) + tk + 16 * j];
          ds[j] = dSs[r * (kB + 1) + tk + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = tq + 16 * c;
          if (d < D) {
            const float o = dOs[r * ld + d], qv = Qs[r * ld + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              tile_v[j][c] = fmaf(p[j], o, tile_v[j][c]);
              tile_k[j][c] = fmaf(ds[j], qv, tile_k[j][c]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc_v[j][c] += tile_v[j][c];
          acc_k[j][c] += tile_k[j][c];
        }
    }
  }
  T* dkp = dk + b * g.dk_sb + hk * g.dk_sh;
  T* dvp = dv + b * g.dv_sb + hk * g.dv_sh;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tk + 16 * j;
    if (key >= g.T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tq + 16 * c;
      if (d < D) {
        dkp[(long long)key * g.dk_st + d] = from_f<T>(acc_k[j][c] * g.scale);
        dvp[(long long)key * g.dv_st + d] = from_f<T>(acc_v[j][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, q head, batch)
// ---------------------------------------------------------------------------

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kC == 4 ? 2 : 1) attn_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Geom g) {
  extern __shared__ __align__(16) float sm[];
  const int D = g.D, ld = D + 1;
  float* Qs = sm;                 // [kB][D + 1]
  float* dOs = Qs + kB * ld;
  float* Ks = dOs + kB * ld;
  float* Vs = Ks + kB * ld;
  float* dSs = Vs + kB * ld;      // [kB rows][kB + 1 keys]
  float* lse_s = dSs + kB * (kB + 1);
  float* del_s = lse_s + kB;

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  const int tid = threadIdx.x, tq = tid / 16, tk = tid % 16;
  load_tile(Qs, q + b * g.q_sb + h * g.q_sh, g.q_ss, q0, g.S, D);
  load_tile(dOs, dout + b * g.do_sb + h * g.do_sh, g.do_ss, q0, g.S, D);
  if (tid < kB) {
    const bool in = q0 + tid < g.S;
    const long long base = ((long long)b * g.Hq + h) * g.S + q0 + tid;
    lse_s[tid] = in ? lse[base] : 0.f;
    del_s[tid] = in ? delta[base] : 0.f;
  }
  // the keys the tile's rows see, as the forward walks them
  const int q_last = min(q0 + kB, g.S) - 1;
  const int k_hi = g.causal ? min(g.T - 1, q_last + g.off) : g.T - 1;
  const int k_lo = g.window > 0 ? max(0, q0 + g.off - g.window + 1) : 0;

  float acc[4][kC];  // rows tk + 16 i, columns tq + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  const T* kh = k + b * g.k_sb + hk * g.k_sh;
  const T* vh = v + b * g.v_sb + hk * g.v_sh;
  for (int kt = k_lo / kB; k_lo <= k_hi && kt <= k_hi / kB; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile is no longer read
    load_tile(Ks, kh, g.k_st, k0, g.T, D);
    load_tile(Vs, vh, g.v_st, k0, g.T, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(Qs, dOs, Ks, Vs, D, tq, tk, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tk + 16 * j;
        const bool live = row < g.S && allowed(g, row + g.off, k0 + key);
        const float p = live ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
        dSs[r * (kB + 1) + key] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys, summed for the tile first
    float tile[4][kC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) tile[i][c] = 0.f;
    for (int key = 0; key < kB; ++key) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(tk + 16 * i) * (kB + 1) + key];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = tq + 16 * c;
        if (d < D) {
          const float kv = Ks[key * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) tile[i][c] = fmaf(ds[i], kv, tile[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] += tile[i][c];
  }
  T* dqp = dq + b * g.dq_sb + h * g.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tk + 16 * i;
    if (row >= g.S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tq + 16 * c;
      if (d < D) dqp[(long long)row * g.dq_ss + d] = from_f<T>(acc[i][c] * g.scale);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int kC>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, const Geom& g, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const long long rows = (long long)B * g.Hq * g.S;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_bwd_delta_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(o), do_, delta, B, g);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t tiles = (size_t)4 * kB * (g.D + 1) * sizeof(float);
  const size_t bytes_kv = tiles + (2 * (size_t)kB * (kB + 1) + 2 * kB) * sizeof(float);
  const size_t bytes_q = tiles + ((size_t)kB * (kB + 1) + 2 * kB) * sizeof(float);
  e = set_smem(attn_bwd_dkdv_kernel<T, kC>, bytes_kv);
  if (!e) e = set_smem(attn_bwd_dq_kernel<T, kC>, bytes_q);
  if (e) return e;
  dim3 grid_kv((g.T + kB - 1) / kB, g.Hkv, B);
  attn_bwd_dkdv_kernel<T, kC><<<grid_kv, kThreads, bytes_kv, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), g);
  e = (int)cudaGetLastError();
  if (e) return e;
  dim3 grid_q((g.S + kB - 1) / kB, g.Hq, B);
  attn_bwd_dq_kernel<T, kC><<<grid_q, kThreads, bytes_q, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of one flash_attention call. q/dq [B,Hq,S,D], k/v/dk/dv
// [B,Hkv,T,D], out/dout like q, each with its own element strides (batch,
// head, row; the last dim dense). lse: the forward's fp32 [B,Hq,S] dense;
// delta: fp32 scratch of B*Hq*S. dtype: 0 = float32, 1 = bfloat16; D <= 128.
// Three launches on `stream`; returns 0 when all were launched, else the CUDA
// error (cudaErrorInvalidValue for what the kernels do not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int S, int T, int D,
    const long long* strides, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 || D <= 0 || D > 128 ||
      B > 65535 || Hq > 65535 || (causal && S > T))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.Hq = Hq; g.Hkv = Hkv; g.S = S; g.T = T; g.D = D; g.G = Hq / Hkv;
  g.causal = causal; g.window = window; g.off = T - S;
  // strides: (batch, head, row) of q, k, v, out, dout, dq, dk, dv
  long long* fields[24] = {&g.q_sb, &g.q_sh, &g.q_ss, &g.k_sb, &g.k_sh, &g.k_st,
                           &g.v_sb, &g.v_sh, &g.v_st, &g.o_sb, &g.o_sh, &g.o_ss,
                           &g.do_sb, &g.do_sh, &g.do_ss, &g.dq_sb, &g.dq_sh, &g.dq_ss,
                           &g.dk_sb, &g.dk_sh, &g.dk_st, &g.dv_sb, &g.dv_sh, &g.dv_st};
  for (int i = 0; i < 24; ++i) *fields[i] = strides[i];
  g.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = D <= 64;
  if (dtype == 0)
    return narrow ? launch<float, 4>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, g, s)
                  : launch<float, 8>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, g, s);
  if (dtype == 1)
    return narrow
               ? launch<__nv_bfloat16, 4>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, g, s)
               : launch<__nv_bfloat16, 8>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, g, s);
  return (int)cudaErrorInvalidValue;
}
