// Pieces shared by the two decode reads, flash_decode.cu (dense cache) and
// flash_decode_paged.cu (paged pool + staging ring), for Hopper (sm_90a):
// cp.async / ldmatrix / mma.sync primitives, one warp's online softmax over
// 16 keys (bf16 on the tensor cores, fp32 on the CUDA cores), and the merge
// of a block's warps and of a cluster's blocks by log-sum-exp through
// distributed shared memory. A key's score comes from the caller, so each
// kernel keeps its own masking rule.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

namespace cg = cooperative_groups;

constexpr int kRows = 16;     // query rows per block (the mma's M)
constexpr int kMaxSplit = 8;  // the portable cluster size
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane t gives the address of row
// t % 8 of matrix t / 8. Plain: lane t gets (row t/4, cols 2(t%4), +1) of
// each; .trans: (rows 2(t%4), +1, col t/4), the lower index in the low half.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x, one MUFU op (inputs of -1e30 and below give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// merge (m2, l2, a2) into (m, l, a): the log-sum-exp combine, base 2
__device__ __forceinline__ void merge(float& m, float& l, float& a, float m2,
                                      float l2, float a2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float w1 = exp2f(m - mn), w2 = exp2f(m2 - mn);
  l = l * w1 + l2 * w2;
  a = a * w1 + a2 * w2;
  m = mn;
}

// ---- one warp's 16 keys: bf16 on the tensor cores -------------------------
// K and V lie in boxes of [kBoxRows rows][128 B] (64 bf16 columns), 16-byte
// chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle), the boxes of
// a row kBoxRows * 128 bytes apart; the warp's keys are rows w16 .. w16 + 15.
// score(dot, j, h) gives key j's (0..15) base-2 score for row gid + 8 h of
// the mma (gid = lane / 4).

template <int kDp, int kBoxRows>
struct WarpBf16 {
  static constexpr int kStride = kDp + 8, kDN = kDp / 8;
  static constexpr int kBoxBytes = kBoxRows * 128;
  uint32_t qf[kDp / 16][4];
  float acc[kDN][4];
  float m[2], l[2];  // rows gid, gid + 8 (l: this thread's columns)

  // Qs: the 16 query rows, kStride values apart
  __device__ void init(const __nv_bfloat16* Qs, int, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      const __nv_bfloat16* a = Qs + gid * kStride + kk * 16 + tig * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(a);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(a + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride + 8);
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // one max and one rescale for the 16 keys; the unnormalised
  // probabilities are rounded to bf16 for P.V, l stays fp32
  template <typename Score>
  __device__ void tile(const unsigned char* Ks, const unsigned char* Vs, int w16,
                       Score score, int lane) {
    const int tig = lane & 3, mi = lane >> 3, mr = lane & 7;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // lane l addresses row l % 8 of matrix l / 8: (keys +8 for matrices
    // 2-3, d +8 for matrices 1 and 3) gives b0, b1 of the two key n-tiles;
    // every row this lane addresses is = mr (mod 8)
    const unsigned char* krow = Ks + (w16 + (mi >> 1) * 8 + mr) * 128;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      const int cc = 2 * kk + (mi & 1);  // 16-byte chunk of the padded row
      uint32_t b[4];
      ldsm_x4(b, krow + (cc >> 3) * kBoxBytes + (((cc & 7) ^ mr) << 4));
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = score(s[n][e], n * 8 + tig * 2 + (e & 1), e >> 1);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);  // m = -inf before the first key: 0
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
    uint32_t a[4];
    a[0] = pack_f32(s[0][0], s[0][1]);
    a[1] = pack_f32(s[0][2], s[0][3]);
    a[2] = pack_f32(s[1][0], s[1][1]);
    a[3] = pack_f32(s[1][2], s[1][3]);
    // .trans: matrices (keys +0/+8, d +0/+8) give b0, b1 of two d n-tiles
    const unsigned char* vrow = Vs + (w16 + (mi & 1) * 8 + mr) * 128;
#pragma unroll
    for (int n = 0; n < kDN; n += 2) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      acc[n + 1][0] *= alpha[0]; acc[n + 1][1] *= alpha[0];
      acc[n + 1][2] *= alpha[1]; acc[n + 1][3] *= alpha[1];
      const int cc = n + (mi >> 1);
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + (cc >> 3) * kBoxBytes + (((cc & 7) ^ mr) << 4));
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }

  __device__ void store(float* red_acc, float* red_ml, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = gid + 8 * r;
      if (tig == 0) {
        red_ml[row * 2] = m[r];
        red_ml[row * 2 + 1] = l[r];
      }
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        red_acc[row * kDp + n * 8 + tig * 2] = acc[n][2 * r];
        red_acc[row * kDp + n * 8 + tig * 2 + 1] = acc[n][2 * r + 1];
      }
    }
  }
};

// ---- one warp's 16 keys: float32 on the CUDA cores ------------------------
// K and V rows kStride = kDp + 4 floats apart; lane = key (lane % 16) x half
// of the columns (lane / 16) for the scores; lane = columns lane + 32 c for
// P.V. score(dot, j, r) gives key j's base-2 score for query row r.

template <int kDp>
struct WarpF32 {
  static constexpr int kStride = kDp + 4, kC = kDp / 32;
  const float* Qs;
  float acc[kRows][kC];
  float m[kRows], l[kRows];
  int rows;

  __device__ void init(const float* q_smem, int n_rows, int) {
    Qs = q_smem;
    rows = n_rows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
    }
  }

  template <typename Score>
  __device__ void tile(const unsigned char* k_tile, const unsigned char* v_tile,
                       int w16, Score score, int lane) {
    const float* Ks = reinterpret_cast<const float*>(k_tile);
    const float* Vs = reinterpret_cast<const float*>(v_tile);
    const int j = lane & 15, half = lane >> 4;
    const float* kr = Ks + (w16 + j) * kStride + half * (kDp / 2);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const float* qr = Qs + r * kStride + half * (kDp / 2);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDp / 2; ++d) dot = fmaf(qr[d], kr[d], dot);
      dot += __shfl_xor_sync(kFull, dot, 16);
      const float sc = score(dot, j, r);
      float mx = sc;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      mx = fmaxf(mx, m[r]);
      const float alpha = exp2f(m[r] - mx);
      const float p = exp2f(sc - mx);
      float ps = p;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float pj = __shfl_sync(kFull, p, jj);
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[r][c] = fmaf(pj, Vs[(w16 + jj) * kStride + lane + 32 * c], acc[r][c]);
      }
    }
  }

  __device__ void store(float* red_acc, float* red_ml, int lane) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        red_ml[r * 2] = m[r];
        red_ml[r * 2 + 1] = l[r];
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) red_acc[r * kDp + lane + 32 * c] = acc[r][c];
    }
  }
};

// Bytes of the merge area, laid over the caller's (finished) K/V ring: the
// warps' (acc, m, l), then the block's, which the cluster reads.
template <int kDp, int kWarps>
struct MergeArea {
  static constexpr int red_acc = 0;                                 // [kWarps][kRows][kDp]
  static constexpr int red_ml = red_acc + kWarps * kRows * kDp * 4; // [kWarps][kRows][2]
  static constexpr int blk_acc = red_ml + kWarps * kRows * 2 * 4;   // [kRows][kDp]
  static constexpr int blk_ml = blk_acc + kRows * kDp * 4;          // [kRows][2]
  static constexpr int bytes = blk_ml + kRows * 2 * 4;
};

// Every warp of the block has finished its keys (the caller synchronised the
// block), and `area` is free. Merge the warps' partials in shared memory,
// then the blocks of the cluster (ranks 0 .. n_split - 1) through
// distributed shared memory; each block writes its share of the `rows`
// outputs, out_row(r) pointing at row r's D values.
template <typename T, int kDp, int kWarps, typename Warp, typename OutRow>
__device__ void merge_and_store(Warp& w, unsigned char* area, int rows, int D,
                                int n_split, int split, OutRow out_row) {
  using M = MergeArea<kDp, kWarps>;
  constexpr int kThreads = 32 * kWarps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  cg::cluster_group cluster = cg::this_cluster();
  float* red_acc = reinterpret_cast<float*>(area + M::red_acc);
  float* red_ml = reinterpret_cast<float*>(area + M::red_ml);
  float* blk_acc = reinterpret_cast<float*>(area + M::blk_acc);
  float* blk_ml = reinterpret_cast<float*>(area + M::blk_ml);
  w.store(red_acc + warp * kRows * kDp, red_ml + warp * kRows * 2, lane);
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      merge(mm, ll, aa, red_ml[(ww * kRows + r) * 2], red_ml[(ww * kRows + r) * 2 + 1],
            red_acc[(ww * kRows + r) * kDp + d]);
    blk_acc[r * kDp + d] = aa;
    if (d == 0) {
      blk_ml[r * 2] = mm;
      blk_ml[r * 2 + 1] = ll;
    }
  }
  cluster.sync();  // every block's partial is in its shared memory

  // the cluster's merge: this block writes its share of the outputs
  for (int i = split * kThreads + tid; i < rows * D; i += n_split * kThreads) {
    const int r = i / D, d = i - r * D;
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
    for (int rk = 0; rk < n_split; ++rk) {
      const float* ml = cluster.map_shared_rank(blk_ml, rk);
      const float* ac = cluster.map_shared_rank(blk_acc, rk);
      merge(mm, ll, aa, ml[r * 2], ml[r * 2 + 1], ac[r * kDp + d]);
    }
    out_row(r)[d] = from_float<T>(aa / ll);
  }
  cluster.sync();  // no block leaves while its shared memory is read
}

}  // namespace decode
