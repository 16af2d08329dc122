// flash_attention: causal / sliding-window prefill attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_attn_kernel):
//   out[b,h,i,:] = softmax_j( q[b,h,i,:] . k[b,h/G,j,:] * D^-1/2 ) @ v[b,h/G,j,:]
// over the keys j a query i may see: j <= i + (T - S) when causal (the queries
// sit at the end of the key stream), and j > i + (T - S) - window when
// window > 0. GQA goes by index (kv head = q head / G): K/V are never copied.
//
// What bounds it on this card: operations. A 4608-token prompt does
// 4 * D * (live (q, k) pairs) FLOP per head against 2 * T * D * 2 B of K/V
// per KV head, far above the ~295 FLOP/B at which the H100's bf16 tensor
// cores, not its memory, are the limit. Only wgmma reaches their full rate,
// so the bf16 path is built the way Hopper wants it:
//   * one block owns 192 query rows of one head: three consumer warpgroups
//     of 64 rows and one producer warpgroup (setmaxnreg moves its registers
//     to the consumers: 24 against 160 a thread). The K/V loads set the
//     pace (the kernel with no products and no softmax takes nearly all of
//     its time), so a tile should serve as many query rows as the registers
//     allow: 192 rows with 64-key tiles beat 128 rows with 128-key tiles;
//   * producer threads issue TMA loads (cp.async.bulk.tensor, 4-D tensor
//     maps over the caller's strides) of the query tile once and of 64-key
//     K and V tiles into a ring of 5 stages (8 for head_dim <= 64). K and V
//     are two pipelines, each stage with a full/empty mbarrier pair: a K
//     tile is released as soon as its scores are in. Every tile is 128-byte
//     swizzled, in boxes of 64 columns: head_dim 120 is two boxes whose
//     columns 120-127 lie outside the tensor and arrive as zeros, so the
//     padding costs no copy and is never stored;
//   * S = Q.K^T is wgmma m64n64k16 with both operands read from shared
//     memory through descriptors (K-major); the online softmax runs on the
//     accumulator registers (fp32 running max m and sum l; a masked key adds
//     exactly 0, as the plain version's -1e30 does in a row with a live
//     key); P is rounded to bf16 unnormalised, as the Pallas kernel does,
//     and fed from registers into O += P.V (wgmma, V read MN-major: the
//     transposed B that bf16 allows). The scores of tile j are issued with
//     P.V of tile j - 1, so the softmax of tile j overlaps that product;
//   * key tiles wholly above the causal diagonal or wholly below the window
//     of the block's rows are never loaded (every warpgroup takes every tile
//     of the block; one that masks all of a row's keys adds nothing to it);
//     only tiles the mask cuts through are masked, by absolute position;
//   * the heaviest query blocks (most key tiles under the causal mask) are
//     scheduled first.
// Every row a caller can give has at least one live key (the wrapper refuses
// causal S > T), so no row is all-masked and the result is the plain
// version's softmax.
//
// float32 inputs take a plain CUDA-core path (one key per lane for Q.K^T,
// probabilities broadcast by shuffles for P.V), used by the fp32 parity runs.
//
// Given a pointer for it, either path also writes each row's log-sum-exp of
// the scaled scores, lse[b, h, i] = log sum_j exp(q.k * scale) over the keys
// the row sees, fp32, [B, Hq, S] dense: what the backward
// (flash_attention_bwd.cu) needs to recompute P without a second softmax.
// The serving launch passes none, and stores nothing more.
#include <math.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

struct Geom {
  int Hq, Hkv, S, T, D, G, causal, window, off;  // off = T - S
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;  // element strides; the last dim is dense
  float scale;
};

// the keys [lo, hi] that query rows [q_lo, q_hi] may see, as a range
__device__ __forceinline__ void key_range(const Geom& g, int q_lo, int q_hi,
                                          int& lo, int& hi) {
  hi = g.causal ? min(g.T - 1, q_hi + g.off) : g.T - 1;
  lo = g.window > 0 ? max(0, q_lo + g.off - g.window + 1) : 0;
}

__device__ __forceinline__ bool allowed(const Geom& g, int qa, int kpos) {
  return kpos < g.T && (!g.causal || kpos <= qa) &&
         (g.window <= 0 || kpos > qa - g.window);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kConsumers = 3;   // warpgroups of 64 query rows
constexpr int kBM = 64 * kConsumers;  // query rows per block
constexpr int kBN = 64;         // keys per tile
constexpr int kThreadsWS = (kConsumers + 1) * 128;
constexpr int kQBoxBytes = kBM * 128;   // a box of the query tile
constexpr int kKVBoxBytes = kBN * 128;  // a box of a K or V tile

// shared memory, from a 1024-byte aligned base: Q [kNB boxes], K and V
// [kStages][kNB boxes], then the barriers. As many stages as fit in 227 KB,
// at most 8: 5 for head_dim > 64, 8 for <= 64
template <int kNB>
struct Smem {
  static constexpr int kStages =
      (227 * 1024 - 2048 - kNB * kQBoxBytes) / (2 * kNB * kKVBoxBytes) < 8
          ? (227 * 1024 - 2048 - kNB * kQBoxBytes) / (2 * kNB * kKVBoxBytes)
          : 8;
  static constexpr int q = 0;
  static constexpr int k = kNB * kQBoxBytes;
  static constexpr int v = k + kStages * kNB * kKVBoxBytes;
  static constexpr int bar = v + kStages * kNB * kKVBoxBytes;
  // full and empty barriers of K and of V per stage, then Q's
  static constexpr int bytes = bar + (4 * kStages + 1) * 8 + 1024;  // + align
};

// kNB: 64-column boxes of the padded head_dim (1: D <= 64, 2: D <= 128)
template <int kNB>
__global__ void __launch_bounds__(kThreadsWS, 1) attn_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, Geom g) {
  using L = Smem<kNB>;
  constexpr int kDp = kNB * kBox;  // padded head_dim: the P.V product's N
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // K and V run as two pipelines over the same stages: a K tile is released
  // once its scores are in, a V tile once its P.V is
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sm + L::bar);
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;
  uint64_t* qbar = empty_v + kStages;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  const int q0 = qb * kBM;
  int k_lo, k_hi;
  key_range(g, q0, min(q0 + kBM, g.S) - 1, k_lo, k_hi);
  const int kt0 = k_lo / kBN, kt1 = k_hi / kBN;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], kConsumers * 4);  // lane 0 of every consumer warp
      mbar_init(&empty_v[i], kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: warp 8's first thread keeps the K ring full (and loads Q),
    // warp 9's the V ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (t == 0 || t == 32) {
      const bool is_k = t == 0;
      const CUtensorMap* map = is_k ? &tk : &tv;
      uint64_t* full = is_k ? full_k : full_v;
      uint64_t* empty = is_k ? empty_k : empty_v;
      unsigned char* ring = sm + (is_k ? L::k : L::v);
      if (is_k) {
        mbar_expect_tx(qbar, kNB * kQBoxBytes);
        for (int c = 0; c < kNB; ++c)
          tma_load(sm + L::q + c * kQBoxBytes, &tq, qbar, c * kBox, q0, h, b);
      }
      for (int kt = kt0; kt <= kt1; ++kt) {
        const int i = kt - kt0, st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kNB * kKVBoxBytes);
        for (int c = 0; c < kNB; ++c)
          tma_load(ring + (st * kNB + c) * kKVBoxBytes, map, &full[st], c * kBox,
                   kt * kBN, hk, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows r0 .. r0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    const int warp = t / 32, lane = t % 32, gid = lane / 4, tig = lane % 4;
    const int r0 = q0 + wg * 64;
    const int r_last = min(r0 + 63, g.S - 1);
    const bool active = r0 < g.S;
    const int qa[2] = {r0 + warp * 16 + gid + g.off, r0 + warp * 16 + gid + 8 + g.off};
    const float sl2 = g.scale * kLog2e;  // softmax in base 2, same function
    const uint32_t q_base = smem_u32(sm + L::q) + wg * 64 * 128;

    float acc[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[kBN / 2];          // scores, then probabilities, of the newest tile
    uint32_t pa[kBN / 16][4];  // the previous tile's P: the A operand of P.V

    // S = Q.K^T of the tile in stage st, issued (one commit group)
    auto issue_s = [&](int st) {
      const uint32_t k_base = smem_u32(sm + L::k + st * kNB * kKVBoxBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(s, desc_sw128(q_base + (kk / 4) * kQBoxBytes + off, 16, 1024),
                     desc_sw128(k_base + (kk / 4) * kKVBoxBytes + off, 16, 1024),
                     kk > 0);
      }
      wg_commit();
    };
    // O += P.V with the tile in stage st, issued (one commit group)
    auto issue_pv = [&](int st) {
      const uint32_t v_base = smem_u32(sm + L::v + st * kNB * kKVBoxBytes);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = desc_sw128(v_base + kk * 16 * 128, kKVBoxBytes, 1024);
        if constexpr (kNB == 1) wgmma_rs_n64(acc, pa[kk], dv);
        else wgmma_rs_n128(acc, pa[kk], dv);
      }
      wg_commit();
    };
    // the online softmax of tile kt's scores in s: masked keys (by absolute
    // position, where the tile is cut by the causal diagonal, the window or
    // the end of the keys) score -inf and add exactly 0, as the plain
    // version's -1e30 does in a row with a live key (every real row has
    // one); s becomes the probabilities exp2(s * scale * log2 e - m), l
    // their running sum, and alpha[] the factor that takes the accumulator
    // to the new max m
    float alpha[2];
    auto softmax = [&](int kt) {
      const int k0 = kt * kBN;
      const bool cut = k0 + kBN > g.T ||
                       (g.causal && k0 + kBN - 1 > r0 + g.off) ||
                       (g.window > 0 && k0 <= r_last + g.off - g.window);
      if (cut) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
            if (!allowed(g, qa[e >> 1], kpos)) s[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row is spread over a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r] * sl2);
        base[r] = mn == -INFINITY ? 0.f : mn;  // no live key yet: p = 0
        alpha[r] = ex2(m[r] - base[r]);         // m = -inf: 0
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -base[e >> 1]));
          l[e >> 1] += s[4 * j + e];
        }
      }
    };
    // P rounded to bf16, unnormalised, as the A operand (16 keys a k-step)
    auto to_pa = [&]() {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_f32(s[4 * j], s[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_f32(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    auto release = [&](uint64_t* empty, int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    // The block's tiles run as a pipeline: the scores of tile kt are issued
    // with P.V of tile kt - 1, and the softmax of tile kt runs while P.V is
    // in flight. Every warpgroup sees every tile of the block (a tile that
    // masks all of a row's keys adds nothing to it); a warpgroup past the
    // last row computes on zero rows and stores nothing. The first tile and
    // the last P.V are peeled off, so every wait retires a fixed number of
    // groups.
    mbar_wait(qbar, 0);
    int st = 0;
    mbar_wait(&full_k[0], 0);
    issue_s(0);
    wg_wait<0>();
    fence_regs<kBN / 2>(s);
    release(empty_k, 0);
    softmax(kt0);
    to_pa();
    for (int kt = kt0 + 1; kt <= kt1; ++kt) {
      const int i = kt - kt0, prev = st;
      st = i % kStages;
      mbar_wait(&full_k[st], (i / kStages) & 1);
      mbar_wait(&full_v[prev], ((i - 1) / kStages) & 1);
      issue_s(st);
      // the accumulator to the previous tile's max while the scores run
#pragma unroll
      for (int j = 0; j < kDp / 8; ++j) {
        acc[4 * j] *= alpha[0]; acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1]; acc[4 * j + 3] *= alpha[1];
      }
      issue_pv(prev);
      wg_wait<1>();  // the scores are in: the K tile is free
      fence_regs<kBN / 2>(s);
      release(empty_k, st);
      softmax(kt);
      wg_wait<0>();  // P.V of the previous tile is done: pa and its V free
      fence_regs<kDp / 2>(acc);
      release(empty_v, prev);
      to_pa();
    }
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      acc[4 * j] *= alpha[0]; acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1]; acc[4 * j + 3] *= alpha[1];
    }
    mbar_wait(&full_v[st], ((kt1 - kt0) / kStages) & 1);
    issue_pv(st);  // the last tile
    wg_wait<0>();
    fence_regs<kDp / 2>(acc);
    release(empty_v, st);

    // l is a per-thread partial over its columns: sum the quad, normalise,
    // store the real columns of the real rows (and, where asked, each row's
    // log-sum-exp: m is its max in base-2 units of the scaled score)
    if (active) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      __nv_bfloat16* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + gid + 8 * r;
        if (row >= g.S) continue;
        if (lse != nullptr && tig == 0)
          lse[((long long)b * g.Hq + h) * g.S + row] = (m[r] + log2f(l[r])) * kLn2;
        __nv_bfloat16* orow = op + (long long)row * g.o_ss;
#pragma unroll
        for (int j = 0; j < kDp / 8; ++j) {
          const int col = j * 8 + tig * 2;
          if (col < g.D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 32, kBK32 = 32, kRowsPerWarp = kBQ32 / (kThreads / 32);

__global__ void __launch_bounds__(kThreads) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = g.D, ks = D + 1;  // K rows padded by one: lanes own rows
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [kBQ32][D]
  float* Ks = Qs + kBQ32 * D;                     // [kBK32][D + 1]
  float* Vs = Ks + kBK32 * ks;                    // [kBK32][D]
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qb * kBQ32;
  const float* qp = q + b * g.q_sb + h * g.q_sh;
  const float* kp = k + b * g.k_sb + hk * g.k_sh;
  const float* vp = v + b * g.v_sb + hk * g.v_sh;
  for (int i = tid; i < kBQ32 * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[i] = q0 + r < g.S ? qp[(long long)(q0 + r) * g.q_ss + d] : 0.f;
  }
  int k_lo, k_hi;
  key_range(g, q0, min(q0 + kBQ32, g.S) - 1, k_lo, k_hi);
  constexpr int kC = 4;  // output columns per lane: d = lane + 32 c, D <= 128
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[j][c] = 0.f;
  }
  for (int kt = k_lo / kBK32; kt <= k_hi / kBK32; ++kt) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK32 * D; i += kThreads) {
      const int r = i / D, d = i - r * D, t = kt * kBK32 + r;
      const bool in = t < g.T;
      Ks[r * ks + d] = in ? kp[(long long)t * g.k_st + d] : 0.f;
      Vs[i] = in ? vp[(long long)t * g.v_st + d] : 0.f;
    }
    __syncthreads();
    const int kpos = kt * kBK32 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      const float* qr = Qs + r * D;
      const float* kr = Ks + lane * ks;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s = allowed(g, q0 + r + g.off, kpos) ? dot * g.scale : kMasked;
      float mt = s;
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float mn = fmaxf(m[j], mt);
      const float alpha = expf(m[j] - mn);
      const float p = expf(s - mn);
      float ps = p;
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[j] = l[j] * alpha + ps;
      m[j] = mn;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[j][c] *= alpha;
      for (int t = 0; t < kBK32; ++t) {
        const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[j][c] = fmaf(pt, Vs[t * D + d], acc[j][c]);
        }
      }
    }
  }
  float* op = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = q0 + warp * kRowsPerWarp + j;
    if (row >= g.S) continue;
    if (lse != nullptr && lane == 0)
      lse[((long long)b * g.Hq + h) * g.S + row] = m[j] + logf(l[j]);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) op[(long long)row * g.o_ss + d] = acc[j][c] / l[j];
    }
  }
}

template <int kNB>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, const Geom& g, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, g.D, g.S, g.Hq, B, g.q_ss, g.q_sh, g.q_sb, kBM);
  if (!e) e = make_map(&tk, k, g.D, g.T, g.Hkv, B, g.k_st, g.k_sh, g.k_sb, kBN);
  if (!e) e = make_map(&tv, v, g.D, g.T, g.Hkv, B, g.v_st, g.v_sh, g.v_sb, kBN);
  if (e) return e;
  constexpr size_t bytes = Smem<kNB>::bytes;
  e = set_smem(attn_wgmma_kernel<kNB>, bytes);
  if (e) return e;
  dim3 grid((g.S + kBM - 1) / kBM, g.Hq, B);
  attn_wgmma_kernel<kNB><<<grid, kThreadsWS, bytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, g);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,S,D], k/v [B,Hkv,T,D], out like q, each with its own element strides
// (the last dim dense). lse: null, or fp32 [B,Hq,S] dense for each row's
// log-sum-exp. dtype: 0 = float32, 1 = bfloat16. D <= 128, a multiple
// of 8 (bf16) or any (fp32); bf16 pointers and strides 16-byte aligned (the
// tensor maps' rule). Causal needs S <= T. Returns 0 when launched, a CUDA
// error, or 10000 + the CUresult of cuTensorMapEncodeTiled when a tensor map
// is refused.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int S, int T, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_ss, float* lse, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 || D <= 0 || D > 128 ||
      B > 65535 || Hq > 65535 || (causal && S > T))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.Hq = Hq; g.Hkv = Hkv; g.S = S; g.T = T; g.D = D; g.G = Hq / Hkv;
  g.causal = causal; g.window = window; g.off = T - S;
  g.q_sb = q_sb; g.q_sh = q_sh; g.q_ss = q_ss;
  g.k_sb = k_sb; g.k_sh = k_sh; g.k_st = k_st;
  g.v_sb = v_sb; g.v_sh = v_sh; g.v_st = v_st;
  g.o_sb = o_sb; g.o_sh = o_sh; g.o_ss = o_ss;
  g.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t bytes = ((size_t)kBQ32 * D + (size_t)kBK32 * (D + 1) +
                          (size_t)kBK32 * D) * sizeof(float);
    const int e = set_smem(attn_f32_kernel, bytes);
    if (e) return e;
    dim3 grid((S + kBQ32 - 1) / kBQ32, Hq, B);
    attn_f32_kernel<<<grid, kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, g);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return D <= kBox ? launch_bf16<1>(q, k, v, out, lse, B, g, s)
                     : launch_bf16<2>(q, k, v, out, lse, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
