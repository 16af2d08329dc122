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
// cores, not its memory, are the limit. So the design puts both products on
// the tensor cores and does no work the mask throws away:
//   * one block owns 64 query rows of one head (4 warps x 16 rows) and loops
//     over 64-key tiles of K/V, keeping the online-softmax state (running
//     max m, sum l, fp32 accumulator) in registers;
//   * key tiles wholly above the causal diagonal or wholly below the window
//     are never visited; only tiles the mask cuts through are masked, by
//     absolute position, masked scores set to -1e30 as the plain version does;
//   * Q.K^T and P.V run as mma.sync m16n8k16 (bf16 in, fp32 accumulate), their
//     K and V fragments read by ldmatrix (.trans for V); the
//     unnormalised probabilities are rounded to bf16 for P.V, and l is kept
//     in fp32 (as the Pallas kernel does: it differs from the plain version,
//     which rounds the normalised probabilities, by about one bf16 ulp);
//   * K/V tiles arrive by cp.async into two shared-memory stages, the next
//     tile's copy in flight while the current one is multiplied;
//   * a head_dim that is not a multiple of 16 (h2o-danube's 120) is padded
//     with zero columns to 64 or 128 in shared memory; the padding is never
//     stored;
//   * the heaviest query blocks (most key tiles under the causal mask) are
//     scheduled first.
// Every row a caller can give has at least one live key (the wrapper refuses
// causal S > T), so no row is all-masked and the result is the plain
// version's softmax. wgmma, TMA and warp specialisation are later work.
//
// float32 inputs take a plain CUDA-core path (one key per lane for Q.K^T,
// probabilities broadcast by shuffles for P.V), used by the fp32 parity runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr int kBQ = 64, kBK = 64, kThreads = 128;

template <int kDp>
constexpr int smem_bytes_bf16() {
  return (kBQ + 4 * kBK) * (kDp + 8) * 2;  // Q + 2 stages of K and V
}

template <int kDp>
__global__ void __launch_bounds__(kThreads) attn_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Geom g) {
  constexpr int kStride = kDp + 8;  // +16 B per row: no bank conflicts
  constexpr int kChunks = kDp / 8;  // 16-byte pieces of a padded row
  constexpr int kKS = kDp / 16;     // k-steps of Q.K^T
  constexpr int kDN = kDp / 8;      // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kStride;      // [2][kBK][kStride]
  __nv_bfloat16* Vs = Ks + 2 * kBK * kStride;  // [2][kBK][kStride]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qb * kBQ;
  const int dch = g.D / 8;  // 16-byte pieces of a real row
  const __nv_bfloat16* qp = q + b * g.q_sb + h * g.q_sh;
  const __nv_bfloat16* kp = k + b * g.k_sb + hk * g.k_sh;
  const __nv_bfloat16* vp = v + b * g.v_sb + hk * g.v_sh;

  const int q_last = min(q0 + kBQ, g.S) - 1;
  int k_lo, k_hi;
  key_range(g, q0, q_last, k_lo, k_hi);
  const int kt0 = k_lo / kBK, kt1 = k_hi / kBK;

  auto load_kv = [&](int stage, int kt) {
    for (int i = tid; i < kBK * dch; i += kThreads) {
      const int r = i / dch, c = i - r * dch, t = kt * kBK + r;
      const bool in = t < g.T;
      const long long row = in ? t : 0;
      const int so = (stage * kBK + r) * kStride + c * 8;
      cp_async16(Ks + so, kp + row * g.k_st + c * 8, in);
      cp_async16(Vs + so, vp + row * g.v_st + c * 8, in);
    }
    cp_async_commit();
  };
  load_kv(0, kt0);

  // the query tile, zero past the last row and in the padding columns; and
  // zero padding columns in both K/V stages (the copies never write them)
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < dch && q0 + r < g.S)
      val = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * g.q_ss + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * kStride + c * 8) = val;
  }
  for (int i = tid; i < 2 * kBK * (kChunks - dch); i += kThreads) {
    const int r = i / (kChunks - dch), c = dch + i % (kChunks - dch);
    *reinterpret_cast<uint4*>(Ks + r * kStride + c * 8) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(Vs + r * kStride + c * 8) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const __nv_bfloat16* a = Qs + (r0 + gid) * kStride + kk * 16 + tig * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(a);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(a + 8 * kStride + 8);
  }
  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qa[2] = {q0 + r0 + gid + g.off, q0 + r0 + gid + 8 + g.off};
  const float sl2 = g.scale * kLog2e;  // softmax in base 2, same function

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt < kt1) {
      load_kv(stage ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kst = Ks + stage * kBK * kStride;
    const __nv_bfloat16* Vst = Vs + stage * kBK * kStride;

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // lane l addresses row l % 8 of matrix l / 8: (keys +8 for matrices 2-3,
    // d +8 for matrices 1 and 3) gives b0, b1 of two key n-tiles
    const int mi = lane >> 3, mr = lane & 7;
    const __nv_bfloat16* kb = Kst + ((mi >> 1) * 8 + mr) * kStride + (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, kb + n * 8 * kStride + kk * 16);
        mma_bf16(s[n], qf[kk], b[0], b[1]);
        mma_bf16(s[n + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask by absolute position where the tile is cut by the causal
    // diagonal, the window or the end of the keys; scale; the online
    // softmax of this thread's 2 rows
    const int k0 = kt * kBK;
    const bool cut = k0 + kBK > g.T || (g.causal && k0 + kBK - 1 > q0 + g.off) ||
                     (g.window > 0 && k0 <= q_last + g.off - g.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + tig * 2 + (e & 1);
        const float val =
            (!cut || allowed(g, qa[e >> 1], kpos)) ? s[n][e] * sl2 : kMasked;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);  // m = -inf on the first tile: 0
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // P (the S accumulators, as bf16 A fragments) times V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // .trans: matrices (keys +0/+8, d +0/+8) give b0, b1 of two d n-tiles
      const __nv_bfloat16* vb =
          Vst + (kk * 16 + (mi & 1) * 8 + mr) * kStride + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kDN; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + n * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

  // l is a per-thread partial over its columns: sum the quad, normalise, store
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
    const int row = q0 + r0 + gid + 8 * r;
    if (row >= g.S) continue;
    __nv_bfloat16* orow = op + (long long)row * g.o_ss;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      const int col = n * 8 + tig * 2;
      if (col < g.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 32, kBK32 = 32, kRowsPerWarp = kBQ32 / (kThreads / 32);

__global__ void __launch_bounds__(kThreads) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, Geom g) {
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
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) op[(long long)row * g.o_ss + d] = acc[j][c] / l[j];
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

template <int kDp>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                const Geom& g, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes_bf16<kDp>();
  const int e = set_smem(attn_bf16_kernel<kDp>, bytes);
  if (e) return e;
  dim3 grid((g.S + kBQ - 1) / kBQ, g.Hq, B);
  attn_bf16_kernel<kDp><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), g);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,S,D], k/v [B,Hkv,T,D], out like q, each with its own element strides
// (the last dim dense). dtype: 0 = float32, 1 = bfloat16. D <= 128, a multiple
// of 8 (bf16) or any (fp32); bf16 rows and strides 16-byte aligned. Causal
// needs S <= T. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int S, int T, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale, int dtype,
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
        static_cast<const float*>(v), static_cast<float*>(out), g);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return D <= 64 ? launch_bf16<64>(q, k, v, out, B, g, s)
                   : launch_bf16<128>(q, k, v, out, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
