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
// sliding window; GQA by index, kv head = q head / G). FlashAttention-2's
// form: delta = rowsum(dout * out), then a dK / dV pass and a dQ pass that
// each recompute P = exp(q.k * scale - lse) from the scores.
//
// What bounds it on this card: the larger of 10 * D FLOP a live (q, k) pair
// and head (S, dP, dV, dK, dQ) at the tensor cores' rate and one read of q,
// k, v, out, dout, lse and one write of dq, dk, dv: bytes at the training
// shapes (S = 512, D = 64). Recomputing both score products in each pass
// makes 14 * D FLOP a pair; on CUDA cores that alone takes 11x the bytes
// bound, so in bf16 every product runs as wgmma on tiles TMA brought into
// shared memory, on K3's forward's machinery (tma_wgmma.cuh). Three
// launches:
//   1. prep: delta and lse2 = lse * log2 e, fp32, into a [B * Hq][S rounded
//      up to 64] scratch; a padding row gets delta 0 and lse2 +inf, so its
//      P is exactly 0 wherever a tile reads it. Eight lanes a row, 16-byte
//      loads of out and dout;
//   2. dK / dV: one block per (64 keys, KV head, batch), the heaviest key
//      tiles first. K and V are loaded once by TMA; one producer thread
//      streams the 64-row Q and dO tiles (their rows' lse2 and delta by bulk
//      copy) of every head of the group that can see the keys, through a
//      ring of stages with full / empty mbarriers. The consumer warpgroup
//      forms S^T = K.Q^T and dP^T = V.dO^T (wgmma, both operands in shared
//      memory, K-major), then P^T = exp2(S^T * scale * log2 e - lse2) and
//      dS^T = P^T (dP^T - delta) on the accumulators, rounds both to bf16 in
//      registers and accumulates dV += P^T.dO and dK += dS^T.Q (wgmma, A
//      from registers, dO and Q read MN-major: the transposed B that bf16
//      allows) in fp32 registers. GQA is summed inside the block in a fixed
//      order;
//   3. dQ: one block per (64 query rows, q head, batch), the heaviest first.
//      Q and dO are loaded once, the 64-key K and V tiles the rows see
//      (as the forward walks them) streamed through the ring; S = Q.K^T and
//      dP = dO.V^T (shared / shared), dS in registers, dQ += dS.K (K read
//      MN-major).
// Each block is one consumer warpgroup and one producer warpgroup, two
// blocks an SM (setmaxnreg: 232 registers a consumer thread, 24 a producer
// thread), so one block's loads, softmax and stores overlap the other's
// products. Every tile a block streams holds a live pair of its rows and
// keys; a tile the causal diagonal, the window or the end of the keys cuts
// is masked by absolute position. On an H100 this runs at 4-5x the bytes
// bound at the training shapes: each tile's softmax and dS arithmetic (32
// ex2 a thread) sits on the chain from its score products to its gradient
// products. Three consumers a block (a third of the bytes streamed) and a
// tile's scores issued beside the previous tile's gradients were both
// measured, and neither was faster.
// No atomics: every sum runs in a fixed order and the result repeats bit
// for bit. A query row past S has P = 0 (lse2 = +inf); a key past T is
// masked in dQ and its dK / dV row is never stored.
// head_dim 80 and 120 are two 64-column boxes whose columns past D arrive as
// zeros; no column past D is stored.
//
// float32 takes the CUDA-core design the fp32 parity runs are held on: tiles
// of 64 x 64 in shared memory (fp32, rows padded by one so that 16 threads
// reading 16 rows hit 16 banks), each thread a 4 x 4 block of the score
// tiles and a 4 x (D / 16) block of the 64 x D accumulators, in registers
// sized to the head (two blocks an SM at D <= 64); delta one thread a row,
// summed in the order of the dP products.
#include <math.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

using namespace hopper;

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

__device__ __forceinline__ bool allowed(const Geom& g, int qa, int kpos) {
  return kpos < g.T && (!g.causal || kpos <= qa) &&
         (g.window <= 0 || kpos > qa - g.window);
}

// rows [0, n) of a [kB][D + 1] fp32 tile from rows r0.. of a strided tensor
// (rows past `limit` read as zeros)
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int r0, int limit, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < limit ? src[(long long)(r0 + r) * row_stride + d] : 0.f;
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
// float32: CUDA cores. 1. delta = rowsum(dout * out)
// ---------------------------------------------------------------------------

// One thread a row, summing over d in order with one fma a column: the
// order in which `scores` forms each dP, so where the two sums meet the same
// values (a row that sees one key, whose out is that key's v) dP - delta
// cancels to exactly 0, as the softmax's own backward gives
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ delta,
    int B, Geom g) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (long long)B * g.Hq * g.S) return;
  const int i = (int)(row % g.S);
  const int h = (int)((row / g.S) % g.Hq);
  const int b = (int)(row / ((long long)g.S * g.Hq));
  const float* orow = o + b * g.o_sb + h * g.o_sh + (long long)i * g.o_ss;
  const float* drow = dout + b * g.do_sb + h * g.do_sh + (long long)i * g.do_ss;
  float acc = 0.f;
  for (int d = 0; d < g.D; ++d) acc = fmaf(drow[d], orow[d], acc);
  delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (key tile, KV head, batch)
// ---------------------------------------------------------------------------

template <int kC>
__global__ void __launch_bounds__(kThreads, kC == 4 ? 2 : 1) attn_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    Geom g) {
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
    const float* qh = q + b * g.q_sb + h * g.q_sh;
    const float* doh = dout + b * g.do_sb + h * g.do_sh;
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
  float* dkp = dk + b * g.dk_sb + hk * g.dk_sh;
  float* dvp = dv + b * g.dv_sb + hk * g.dv_sh;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tk + 16 * j;
    if (key >= g.T) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tq + 16 * c;
      if (d < D) {
        dkp[(long long)key * g.dk_st + d] = acc_k[j][c] * g.scale;
        dvp[(long long)key * g.dv_st + d] = acc_v[j][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, q head, batch)
// ---------------------------------------------------------------------------

template <int kC>
__global__ void __launch_bounds__(kThreads, kC == 4 ? 2 : 1) attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, Geom g) {
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
  const float* kh = k + b * g.k_sb + hk * g.k_sh;
  const float* vh = v + b * g.v_sb + hk * g.v_sh;
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
  float* dqp = dq + b * g.dq_sb + h * g.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tk + 16 * i;
    if (row >= g.S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tq + 16 * c;
      if (d < D) dqp[(long long)row * g.dq_ss + d] = acc[i][c] * g.scale;
    }
  }
}

template <int kC>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, const Geom& g, cudaStream_t s) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const long long rows = (long long)B * g.Hq * g.S;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_bwd_delta_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(o), do_, delta, B, g);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t tiles = (size_t)4 * kB * (g.D + 1) * sizeof(float);
  const size_t bytes_kv = tiles + (2 * (size_t)kB * (kB + 1) + 2 * kB) * sizeof(float);
  const size_t bytes_q = tiles + ((size_t)kB * (kB + 1) + 2 * kB) * sizeof(float);
  e = set_smem(attn_bwd_dkdv_kernel<kC>, bytes_kv);
  if (!e) e = set_smem(attn_bwd_dq_kernel<kC>, bytes_q);
  if (e) return e;
  dim3 grid_kv((g.T + kB - 1) / kB, g.Hkv, B);
  attn_bwd_dkdv_kernel<kC><<<grid_kv, kThreads, bytes_kv, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), g);
  e = (int)cudaGetLastError();
  if (e) return e;
  dim3 grid_q((g.S + kB - 1) / kB, g.Hq, B);
  attn_bwd_dq_kernel<kC><<<grid_q, kThreads, bytes_q, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dq), g);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
// a block: one consumer warpgroup of 64 keys (dK / dV) or 64 query rows
// (dQ) and one producer warpgroup; two blocks an SM (128 registers a thread
// at launch; setmaxnreg moves the producer's to the consumer: 24 and 232)
constexpr int kRows = 64;       // a block's keys or rows; a streamed tile's rows
constexpr int kThreadsWS = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kBoxBytes = kRows * 128;  // a 64-column box of a 64-row tile
// delta and lse2 are laid out [B * Hq][Sp], Sp = S rounded up to kRows, so
// that every tile reads whole rows of them
constexpr int kPrepThreads = 256, kPrepLanes = 8;

// the query rows [lo, hi] that may see a key of [k_lo, k_hi] (lo > hi: none)
__device__ __forceinline__ void query_range(const Geom& g, int k_lo, int k_hi,
                                            int& lo, int& hi) {
  lo = g.causal ? max(0, k_lo - g.off) : 0;
  hi = g.window > 0 ? min(g.S - 1, k_hi + g.window - 1 - g.off) : g.S - 1;
}

// the keys [lo, hi] that query rows [q_lo, q_hi] may see, as the forward
// walks them
__device__ __forceinline__ void key_range(const Geom& g, int q_lo, int q_hi,
                                          int& lo, int& hi) {
  hi = g.causal ? min(g.T - 1, q_hi + g.off) : g.T - 1;
  lo = g.window > 0 ? max(0, q_lo + g.off - g.window + 1) : 0;
}

// shared memory of both passes, from a 1024-byte aligned base: the block's
// own tiles A and B (K and V, or Q and dO) [kNB boxes], the streamed tiles X
// and Y (Q and dO, or K and V) [kStages][kNB boxes], the streamed lse2 and
// delta [2][kStages][kRows] (dK / dV pass only), then the barriers
template <int kNB>
struct SmemBwd {
  // as many stages as let two blocks share an SM's 227 KB
  static constexpr int kStages = kNB == 1 ? 4 : 2;
  static constexpr int a = 0;
  static constexpr int b = kNB * kBoxBytes;
  static constexpr int x = 2 * kNB * kBoxBytes;
  static constexpr int y = x + kStages * kNB * kBoxBytes;
  static constexpr int rows = y + kStages * kNB * kBoxBytes;
  static constexpr int bar = rows + 2 * kStages * kRows * 4;
  // full and empty per stage, then the block tiles' barrier
  static constexpr int bytes = bar + (2 * kStages + 1) * 8 + 1024;  // + align
};

// an m64n64 fp32 accumulator rounded to bf16 as the A operand of four
// k-steps of 16 (its columns are the next product's K)
__device__ __forceinline__ void to_a(uint32_t a[4][4], const float* x) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j & 1) * 2] = pack_f32(x[4 * j], x[4 * j + 1]);
    a[j / 2][(j & 1) * 2 + 1] = pack_f32(x[4 * j + 2], x[4 * j + 3]);
  }
}

// d = A . B^T over the padded head_dim, both 64-row tiles K-major in shared
// memory (their 64-column boxes kBoxBytes apart)
template <int kNB>
__device__ __forceinline__ void issue_ss(float* d, uint32_t a_base, uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < kNB * 4; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64(d, desc_sw128(a_base + off, 16, 1024),
                 desc_sw128(b_base + off, 16, 1024), kk > 0);
  }
}

// d += A . B, A (64 x 64) from registers, B a 64-row tile read MN-major
// (its rows the product's K, its padded head_dim the N)
template <int kNB>
__device__ __forceinline__ void issue_rs(float* d, const uint32_t a[4][4],
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b_base + kk * 16 * 128, kBoxBytes, 1024);
    if constexpr (kNB == 1) wgmma_rs_n64(d, a[kk], db);
    else wgmma_rs_n128(d, a[kk], db);
  }
}

// 1. delta[r] = sum_d dout * out and lse2[r] = lse * log2 e, for every row r
// of the padded [B * Hq][Sp] layout; a padding row (i >= S) gets delta 0 and
// lse2 +inf, so that its P is exactly 0 wherever a tile reads it. Eight
// lanes a row, 16 bytes (8 values) of out and of dout a lane a step
__global__ void __launch_bounds__(kPrepThreads) attn_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, long long rows, int Sp, Geom g) {
  const long long row =
      ((long long)blockIdx.x * kPrepThreads + threadIdx.x) / kPrepLanes;
  const int lane = threadIdx.x % kPrepLanes;
  const bool live = row < rows;
  const int i = (int)(row % Sp);
  const long long bh = row / Sp;
  const int h = (int)(bh % g.Hq), b = (int)(bh / g.Hq);
  float acc = 0.f;
  if (live && i < g.S) {
    const __nv_bfloat16* orow = o + b * g.o_sb + h * g.o_sh + (long long)i * g.o_ss;
    const __nv_bfloat16* drow =
        dout + b * g.do_sb + h * g.do_sh + (long long)i * g.do_ss;
    for (int c = lane * 8; c < g.D; c += kPrepLanes * 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(op[j]), d = __bfloat1622float2(dp[j]);
        acc = fmaf(d.x, a.x, acc);
        acc = fmaf(d.y, a.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = kPrepLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (live && lane == 0) {
    delta[row] = acc;
    lse2[row] = i < g.S ? lse[bh * g.S + i] * kLog2e : INFINITY;
  }
}

// 2. dK, dV: one block per (64 keys, KV head, batch), the heaviest key
// tiles (the first, under the causal mask) first. The producer streams the
// 64-row query tiles of every head of the group that can see the keys, each
// with its rows' lse2 and delta
template <int kNB>
__global__ void __launch_bounds__(kThreadsWS, kBlocksPerSM) attn_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B,
    int Sp, Geom g) {
  using L = SmemBwd<kNB>;
  constexpr int kDp = kNB * kBox;  // padded head_dim
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  float* lse_s = reinterpret_cast<float*>(sm + L::rows);  // [kStages][kRows]
  float* del_s = lse_s + kStages * kRows;

  const int per_kt = g.Hkv * B;
  const int kt = blockIdx.x / per_kt, hk = blockIdx.x % g.Hkv,
            b = (blockIdx.x % per_kt) / g.Hkv;
  const int k0 = kt * kRows;
  int q_lo, q_hi;
  query_range(g, k0, min(k0 + kRows, g.T) - 1, q_lo, q_hi);
  const int qt0 = q_lo / kRows;
  const int n_qt = q_lo <= q_hi ? q_hi / kRows - qt0 + 1 : 0;
  // streamed tiles: head hk * G + i / n_qt, query tile qt0 + i % n_qt; each
  // holds a row that sees one of the block's keys
  const int n = g.G * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of every consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread loads the block's K and V once, then keeps the
    // ring of query tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 && n > 0) {
      mbar_expect_tx(kvbar, 2 * kNB * kBoxBytes);
      for (int c = 0; c < kNB; ++c) {
        tma_load(sm + L::a + c * kBoxBytes, &tk, kvbar, c * kBox, k0, hk, b);
        tma_load(sm + L::b + c * kBoxBytes, &tv, kvbar, c * kBox, k0, hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages, h = hk * g.G + i / n_qt;
        const int q0 = (qt0 + i % n_qt) * kRows;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kNB * kBoxBytes + 2 * kRows * 4);
        for (int c = 0; c < kNB; ++c) {
          tma_load(sm + L::x + (st * kNB + c) * kBoxBytes, &tq, &full[st],
                   c * kBox, q0, h, b);
          tma_load(sm + L::y + (st * kNB + c) * kBoxBytes, &tdo, &full[st],
                   c * kBox, q0, h, b);
        }
        const long long r = ((long long)b * g.Hq + h) * Sp + q0;
        bulk_load(lse_s + st * kRows, lse2 + r, kRows * 4, &full[st]);
        bulk_load(del_s + st * kRows, delta + r, kRows * 4, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x, warp = t / 32, lane = t % 32, gid = lane / 4,
              tig = lane % 4;
    const int key[2] = {k0 + warp * 16 + gid, k0 + warp * 16 + gid + 8};
    const float sl2 = g.scale * kLog2e;
    const uint32_t k_base = smem_u32(sm + L::a), v_base = smem_u32(sm + L::b);
    float acc_k[kDp / 2], acc_v[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    float s[32], dp[32];          // S^T and dP^T: keys x the tile's query rows
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16, A operands

    auto x_base = [&](int st) { return smem_u32(sm + L::x + st * kNB * kBoxBytes); };
    auto y_base = [&](int st) { return smem_u32(sm + L::y + st * kNB * kBoxBytes); };
    // S^T = K.Q^T, dP^T = V.dO^T of the tile in stage st, issued
    auto issue_scores = [&](int st) {
      issue_ss<kNB>(s, k_base, x_base(st));
      issue_ss<kNB>(dp, v_base, y_base(st));
    };
    // P^T = exp(S^T * scale - lse) (0 where masked, by absolute position
    // where the causal diagonal or the window cuts the tile; a query row
    // past S reads lse2 = +inf, so P = 0 there), dS^T = P^T (dP^T - delta);
    // both rounded to bf16 as A operands
    auto probs = [&](int st, int q0) {
      const bool cut = (g.causal && k0 + kRows - 1 > q0 + g.off) ||
                       (g.window > 0 && k0 <= q0 + kRows - 1 + g.off - g.window);
      const float* ls = lse_s + st * kRows;
      const float* dl = del_s + st * kRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float p = ex2(fmaf(s[x], sl2, -((e & 1) ? l2.y : l2.x)));
          if (cut && !allowed(g, q0 + col + (e & 1) + g.off, key[e >> 1])) p = 0.f;
          dp[x] = p * (dp[x] - ((e & 1) ? d2.y : d2.x));
          s[x] = p;
        }
      }
      to_a(pa, s);
      to_a(da, dp);
    };
    // dV += P^T.dO, dK += dS^T.Q with the tile in stage st (read MN-major)
    auto issue_grads = [&](int st) {
      issue_rs<kNB>(acc_v, pa, y_base(st));
      issue_rs<kNB>(acc_k, da, x_base(st));
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    if (n > 0) mbar_wait(kvbar, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      wg_fence();
      issue_scores(st);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      probs(st, (qt0 + i % n_qt) * kRows);
      wg_fence();
      issue_grads(st);
      wg_commit();
      wg_wait<0>();
      fence_regs<kDp / 2>(acc_v);
      fence_regs<kDp / 2>(acc_k);
      release(st);
    }
    // the real columns of the real keys
    __nv_bfloat16* dkp = dk + b * g.dk_sb + hk * g.dk_sh;
    __nv_bfloat16* dvp = dv + b * g.dv_sb + hk * g.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= g.T) continue;
      __nv_bfloat16* krow = dkp + (long long)key[r] * g.dk_st;
      __nv_bfloat16* vrow = dvp + (long long)key[r] * g.dv_st;
#pragma unroll
      for (int j = 0; j < kDp / 8; ++j) {
        const int col = j * 8 + tig * 2;
        if (col < g.D) {
          *reinterpret_cast<__nv_bfloat162*>(krow + col) = __floats2bfloat162_rn(
              acc_k[4 * j + 2 * r] * g.scale, acc_k[4 * j + 2 * r + 1] * g.scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + col) = __floats2bfloat162_rn(
              acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// 3. dQ: one block per (64 query rows, q head, batch), the heaviest (the
// last, under the causal mask) first. The producer streams the 64-key K and
// V tiles the rows see, as the forward walks them
template <int kNB>
__global__ void __launch_bounds__(kThreadsWS, kBlocksPerSM) attn_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int B, int Sp, Geom g) {
  using L = SmemBwd<kNB>;
  constexpr int kDp = kNB * kBox;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int per_qt = g.Hq * B;
  const int qt = Sp / kRows - 1 - (int)(blockIdx.x / per_qt);
  const int h = blockIdx.x % g.Hq, b = (blockIdx.x % per_qt) / g.Hq, hk = h / g.G;
  const int q0 = qt * kRows;
  int k_lo, k_hi;
  key_range(g, q0, min(q0 + kRows, g.S) - 1, k_lo, k_hi);
  // streamed tiles: keys (kt0 + i) * kRows ..; every row has a key, and
  // each tile holds a key one of the rows sees
  const int kt0 = k_lo / kRows, n = k_hi / kRows - kt0 + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: Q and dO of the block once, then the ring of K and V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128) {
      mbar_expect_tx(qbar, 2 * kNB * kBoxBytes);
      for (int c = 0; c < kNB; ++c) {
        tma_load(sm + L::a + c * kBoxBytes, &tq, qbar, c * kBox, q0, h, b);
        tma_load(sm + L::b + c * kBoxBytes, &tdo, qbar, c * kBox, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages, k0 = (kt0 + i) * kRows;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kNB * kBoxBytes);
        for (int c = 0; c < kNB; ++c) {
          tma_load(sm + L::x + (st * kNB + c) * kBoxBytes, &tk, &full[st],
                   c * kBox, k0, hk, b);
          tma_load(sm + L::y + (st * kNB + c) * kBoxBytes, &tv, &full[st],
                   c * kBox, k0, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x, warp = t / 32, lane = t % 32, gid = lane / 4,
              tig = lane % 4;
    const int r_last = min(q0 + kRows - 1, g.S - 1);
    const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
    const float sl2 = g.scale * kLog2e;
    float l2[2], dl[2];  // rows past S read lse2 = +inf: P = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = ((long long)b * g.Hq + h) * Sp + row[r];
      l2[r] = lse2[at];
      dl[r] = delta[at];
    }
    const uint32_t q_base = smem_u32(sm + L::a), do_base = smem_u32(sm + L::b);
    float acc[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
    float s[32], dp[32];  // S and dP: the rows x the tile's keys
    uint32_t da[4][4];    // dS in bf16, the A operand

    auto x_base = [&](int st) { return smem_u32(sm + L::x + st * kNB * kBoxBytes); };
    // S = Q.K^T, dP = dO.V^T of the tile in stage st, issued
    auto issue_scores = [&](int st) {
      issue_ss<kNB>(s, q_base, x_base(st));
      issue_ss<kNB>(dp, do_base, smem_u32(sm + L::y + st * kNB * kBoxBytes));
    };
    // dS = P (dP - delta), P = exp(S * scale - lse), 0 where masked (by
    // absolute position where the tile is cut by the causal diagonal, the
    // window or the end of the keys); rounded to bf16 as the A operand
    auto dscores = [&](int i) {
      const int k0 = (kt0 + i) * kRows;
      const bool cut = k0 + kRows > g.T || (g.causal && k0 + kRows - 1 > q0 + g.off) ||
                       (g.window > 0 && k0 <= r_last + g.off - g.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float p = ex2(fmaf(s[x], sl2, -l2[e >> 1]));
          if (cut && !allowed(g, row[e >> 1] + g.off, k0 + j * 8 + tig * 2 + (e & 1)))
            p = 0.f;
          dp[x] = p * (dp[x] - dl[e >> 1]);
        }
      }
      to_a(da, dp);
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    mbar_wait(qbar, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      wg_fence();
      issue_scores(st);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      dscores(i);
      wg_fence();
      issue_rs<kNB>(acc, da, x_base(st));  // dQ += dS.K, K read MN-major
      wg_commit();
      wg_wait<0>();
      fence_regs<kDp / 2>(acc);
      release(st);
    }

    __nv_bfloat16* dqp = dq + b * g.dq_sb + h * g.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= g.S) continue;
      __nv_bfloat16* qrow = dqp + (long long)row[r] * g.dq_ss;
#pragma unroll
      for (int j = 0; j < kDp / 8; ++j) {
        const int col = j * 8 + tig * 2;
        if (col < g.D)
          *reinterpret_cast<__nv_bfloat162*>(qrow + col) = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] * g.scale, acc[4 * j + 2 * r + 1] * g.scale);
      }
    }
  }
}

template <int kNB>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dq,
                void* dk, void* dv, int B, const Geom& g, cudaStream_t s) {
  const int Sp = (g.S + kRows - 1) / kRows * kRows;
  const long long rows = (long long)B * g.Hq * Sp;
  const long long prep_blocks = (rows * kPrepLanes + kPrepThreads - 1) / kPrepThreads;
  const long long kv_blocks = (long long)((g.T + kRows - 1) / kRows) * g.Hkv * B;
  const long long q_blocks = (long long)(Sp / kRows) * g.Hq * B;
  if (prep_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* delta = scratch;
  float* lse2 = scratch + rows;
  CUtensorMap tq, tdo, tk, tv;
  int e = make_map(&tq, q, g.D, g.S, g.Hq, B, g.q_ss, g.q_sh, g.q_sb, kRows);
  if (!e) e = make_map(&tdo, dout, g.D, g.S, g.Hq, B, g.do_ss, g.do_sh, g.do_sb, kRows);
  if (!e) e = make_map(&tk, k, g.D, g.T, g.Hkv, B, g.k_st, g.k_sh, g.k_sb, kRows);
  if (!e) e = make_map(&tv, v, g.D, g.T, g.Hkv, B, g.v_st, g.v_sh, g.v_sb, kRows);
  if (e) return e;
  constexpr size_t bytes = SmemBwd<kNB>::bytes;
  e = set_smem(attn_bwd_dkdv_wgmma_kernel<kNB>, bytes);
  if (!e) e = set_smem(attn_bwd_dq_wgmma_kernel<kNB>, bytes);
  if (e) return e;
  attn_bwd_prep_kernel<<<(unsigned)prep_blocks, kPrepThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, lse2, rows, Sp, g);
  e = (int)cudaGetLastError();
  if (e) return e;
  attn_bwd_dkdv_wgmma_kernel<kNB><<<(unsigned)kv_blocks, kThreadsWS, bytes, s>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sp, g);
  e = (int)cudaGetLastError();
  if (e) return e;
  attn_bwd_dq_wgmma_kernel<kNB><<<(unsigned)q_blocks, kThreadsWS, bytes, s>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<__nv_bfloat16*>(dq), B, Sp, g);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of one flash_attention call. q/dq [B,Hq,S,D], k/v/dk/dv
// [B,Hkv,T,D], out/dout like q, each with its own element strides (batch,
// head, row; the last dim dense). lse: the forward's fp32 [B,Hq,S] dense;
// scratch: fp32, 2 * B * Hq * (S rounded up to 64) (float32 uses its first
// B * Hq * S). dtype: 0 = float32, 1 = bfloat16; D <= 128, a multiple of 8 in
// bf16, whose pointers and strides are 16-byte aligned (the tensor maps'
// rule). Three launches on `stream`; returns 0 when all were launched, the
// CUDA error (cudaErrorInvalidValue for what the kernels do not take), or
// 10000 + the CUresult of cuTensorMapEncodeTiled when a tensor map is
// refused.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
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
  if (dtype == 0)
    return D <= 64
               ? launch_f32<4>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, g, s)
               : launch_f32<8>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, g, s);
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return D <= kBox
               ? launch_bf16<1>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, g, s)
               : launch_bf16<2>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
