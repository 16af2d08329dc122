// flash_decode: one-query attention over a dense per-slot KV cache (the lanes
// layout's decode read), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode (_decode_kernel):
//   out[b,hq,:] = softmax_t( q[b,hq,:] . k[b,t,hq/G,:] * D^-1/2, masked to
//                 -1e30 where !kv_mask[b,t] ) @ v[b,t,hq/G,:]
//
// What bounds it on this card: bytes. Each K/V row is used by the G query
// heads of its group for 4 * G * D FLOP against 2 * D * elemsize bytes; the
// whole call is a read of the live part of the cache. So the design keeps
// the memory busy and does as little per key as it can:
//   * one block per (key split, KV head, group of 16 query rows, slot)
//     serves the rows of the head's GQA group, so each K/V row leaves device
//     memory once. The splits of one (slot, head, rows) form a thread-block
//     cluster (at most 8, the portable size): 8 slots x 8 KV heads are 64
//     pairs, far fewer than 132 SMs, so the time axis is split across blocks;
//   * bf16 K/V tiles of 128 keys arrive by TMA (cp.async.bulk.tensor over a
//     4-D map of the cache, 64-column boxes, 128-byte swizzled; columns past
//     D and keys past T read as zeros) in a ring of 3 stages with an mbarrier
//     each; thread-issued copies cap the bytes an SM has in flight well
//     below what the memory needs. A tile with no live key is not loaded
//     (unless the slot has none at all);
//   * each of the 8 warps scores its 16 keys of a tile against the rows at
//     once on the tensor cores (mma.sync m16n8k16, the rows padded to 16
//     with zeros, K by ldmatrix from the swizzled tile), takes one max and
//     one rescale per tile, rounds the unnormalised probabilities to bf16
//     and adds P.V (V by ldmatrix.trans); l is kept in fp32. A warp whose 16
//     keys hold no live key skips the tile;
//   * float32 (the parity runs) takes the same structure with 64-key tiles
//     copied by cp.async (16-byte pieces, masked keys unread) and the
//     products on the CUDA cores;
//   * at the end each block merges its warps through shared memory, and the
//     blocks of a cluster merge by log-sum-exp through distributed shared
//     memory: one launch a call, no partial results in device memory;
//   * a masked key scores -1e30 in the plain version, which adds exactly 0
//     wherever the slot has a live key; only a slot with no live key at all
//     (a dead slot of the paged reference read) needs them, and there every
//     key counts once, as the plain version's uniform mean over all T rows.
//     Each block ORs the mask of its split, the cluster ORs the blocks'.
#include <cuda.h>  // CUtensorMap; the encoder comes through cudaGetDriverEntryPoint

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kBox = 64;     // bf16 columns of one 128-byte swizzled box

struct Geometry {
  int Hq, Hkv, T, D, G, n_split, kps, n_rg;  // n_rg: groups of kRows rows
  float scale;
};

// per type: values in a 16-byte piece, warps a block (each takes 16 keys of
// a tile), ring stages
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kVec = 8, kWarps = 8, kStages = 3;
};
template <> struct Cfg<float> {
  static constexpr int kVec = 4, kWarps = 4, kStages = 2;
};

// Shared memory of one block. bf16, from a 1024-byte aligned base: the ring
// of K and V tiles (kNB swizzled boxes of [kTK rows][128 B] a stage), the
// query rows (padded by 16 bytes), each stage's key codes and barriers, the
// live flag. fp32: the ring with rows padded by 16 bytes, the query rows,
// the codes, the flag. After the loop the ring is reused for the merge
// (``MergeArea``).
template <typename T, int kDp>
struct Smem {
  static constexpr bool kTma = sizeof(T) == 2;
  static constexpr int kWarps = Cfg<T>::kWarps, kTK = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps, kStages = Cfg<T>::kStages;
  static constexpr int kNB = kDp / kBox;
  static constexpr int kBoxBytes = kTK * 128;
  static constexpr int kStride = kDp + 16 / (int)sizeof(T);  // q, fp32 tiles
  static constexpr int kTile =
      kTma ? kNB * kBoxBytes : kTK * kStride * (int)sizeof(T);
  static constexpr int k = 0;
  static constexpr int v = kStages * kTile;
  static constexpr int q = 2 * v;
  static constexpr int code = q + kRows * kStride * (int)sizeof(T);
  static constexpr int bar = code + kStages * kTK;  // a multiple of 8
  static constexpr int flag = bar + 8 * kStages;
  static constexpr int bytes = flag + 16 + (kTma ? 1024 : 0);  // + alignment
  static_assert(MergeArea<kDp, kWarps>::bytes <= q, "merge area must fit the ring");
  static_assert(bar % 8 == 0, "barriers are 8-byte aligned");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// a key of a tile: past the split (never counted), masked, or live
constexpr unsigned char kPast = 0, kMaskedKey = 1, kLive = 2;

// the score of a key for the tile's online softmax, base 2: -inf past the
// split, -1e30 where masked, as the plain version
__device__ __forceinline__ float score(float dot, float sl2, unsigned char code) {
  return code == kLive ? dot * sl2 : code == kMaskedKey ? kMasked : -INFINITY;
}

template <typename T, int kDp> struct Warp;
template <int kDp>
struct Warp<__nv_bfloat16, kDp> : WarpBf16<kDp, Smem<__nv_bfloat16, kDp>::kTK> {};
template <int kDp> struct Warp<float, kDp> : WarpF32<kDp> {};

// the tensor maps of a bf16 cache (unused by fp32)
struct Maps {
  CUtensorMap k, v;
};

template <typename T, int kDp>
__global__ void __launch_bounds__(Smem<T, kDp>::kThreads) dense_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const __grid_constant__ Maps maps, const unsigned char* __restrict__ mask,
    T* __restrict__ out, Geometry g) {
  using L = Smem<T, kDp>;
  constexpr int kVec = Cfg<T>::kVec, kStages = L::kStages;
  constexpr int kWarps = L::kWarps, kTK = L::kTK, kThreads = L::kThreads;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      L::kTma ? smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) : smem_raw;
  T* Qs = reinterpret_cast<T*>(sm + L::q);
  unsigned char* codes = sm + L::code;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bar);
  int* flag = reinterpret_cast<int*>(sm + L::flag);
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x;  // = the rank in the cluster (cluster = splits)
  const int hk = blockIdx.y / g.n_rg, row0 = (blockIdx.y % g.n_rg) * kRows;
  const int b = blockIdx.z;
  const int rows = min(kRows, g.G - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_begin = split * g.kps, t_end = min(g.T, t_begin + g.kps);
  const unsigned char* mrow = mask + (long long)b * g.T;
  const int dch = g.D / kVec;  // 16-byte pieces of a row

  // does the slot have a live key anywhere? each block ORs its split, the
  // cluster ORs the blocks (the splits cover all T keys)
  int any = 0;
  for (int t = t_begin + tid; t < t_end; t += kThreads) any |= mrow[t];
  any = __syncthreads_or(any);
  if (tid == 0) {
    *flag = any;
    if constexpr (L::kTma) {
      for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // the query rows, zero past the group and in the padding columns; fp32:
  // zero padding columns in every K/V stage (the copies never write them)
  for (int i = tid; i < kRows * (kDp / kVec); i += kThreads) {
    const int r = i / (kDp / kVec), c = i % (kDp / kVec);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows && c < dch)
      val = *reinterpret_cast<const uint4*>(
          q + ((long long)b * g.Hq + hk * g.G + row0 + r) * g.D + c * kVec);
    *reinterpret_cast<uint4*>(Qs + r * kStride + c * kVec) = val;
  }
  if constexpr (!L::kTma) {
    T* Ks = reinterpret_cast<T*>(sm + L::k);
    T* Vs = reinterpret_cast<T*>(sm + L::v);
    const int pad = kDp / kVec - dch;
    for (int i = tid; i < kStages * kTK * pad; i += kThreads) {
      const int r = i / pad, c = dch + i % pad;
      *reinterpret_cast<uint4*>(Ks + r * kStride + c * kVec) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + r * kStride + c * kVec) = make_uint4(0, 0, 0, 0);
    }
  }
  cluster.sync();  // flags and barriers are set, and every block has started
  int live_any = 0;
  for (int r = 0; r < g.n_split; ++r) live_any |= *cluster.map_shared_rank(flag, r);

  const int n_tiles = (t_end - t_begin + kTK - 1) / kTK;
  // Tile i into stage st. bf16: warp 0 writes the key codes and, where the
  // tile has a key to count, lane 0 loads it by TMA (else a plain arrive).
  // fp32: a key row's 16-byte pieces on consecutive threads, masked keys
  // unread, the first piece's thread writes the code.
  auto load = [&](int st, int i) {
    const int t0 = t_begin + i * kTK;
    if constexpr (L::kTma) {
      if (warp != 0) return;
      bool need = false;
#pragma unroll
      for (int j = 0; j < kTK / 32; ++j) {
        const int t = t0 + lane + 32 * j;
        const bool in = t < t_end;
        const bool live = in && mrow[t] != 0;
        codes[st * kTK + lane + 32 * j] = live ? kLive : in ? kMaskedKey : kPast;
        need |= live_any ? live : in;
      }
      need = __any_sync(kFull, need);
      __syncwarp();
      if (lane == 0) {
        if (need) {
          mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < L::kNB; ++c) {
            tma_load(sm + L::k + st * L::kTile + c * L::kBoxBytes, &maps.k,
                     &full[st], c * kBox, hk, t0, b);
            tma_load(sm + L::v + st * L::kTile + c * L::kBoxBytes, &maps.v,
                     &full[st], c * kBox, hk, t0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    } else {
      constexpr int kPieces = kDp / kVec;
      T* Ks = reinterpret_cast<T*>(sm + L::k);
      T* Vs = reinterpret_cast<T*>(sm + L::v);
      const int lr = tid / kPieces, lc = tid % kPieces;
#pragma unroll
      for (int j = 0; j < kTK * kPieces / kThreads; ++j) {
        const int r = lr + j * (kThreads / kPieces), t = t0 + r;
        const bool in = t < t_end;
        const bool live = in && mrow[t] != 0;
        if (lc == 0) codes[st * kTK + r] = live ? kLive : in ? kMaskedKey : kPast;
        if (lc < dch) {
          const long long off =
              (((long long)b * g.T + (in ? t : t_begin)) * g.Hkv + hk) * g.D + lc * kVec;
          const int so = (st * kTK + r) * kStride + lc * kVec;
          cp_async16(Ks + so, k + off, live);
          cp_async16(Vs + so, v + off, live || (in && !live_any));
        }
      }
      cp_async_commit();
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load(i, i);
    else if constexpr (!L::kTma) cp_async_commit();  // keep the group count
  }

  __syncthreads();  // the query rows are written
  Warp<T, kDp> w;
  w.init(Qs, rows, lane);
  const float sl2 = g.scale * kLog2e;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if constexpr (!L::kTma) cp_async_wait<kStages - 2>();
    __syncthreads();  // every warp is done with tile i - 1: its stage is free
    if (i + kStages - 1 < n_tiles) {
      if constexpr (L::kTma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load((i + kStages - 1) % kStages, i + kStages - 1);
    } else if constexpr (!L::kTma) {
      cp_async_commit();  // an empty group keeps the count
    }
    if constexpr (L::kTma) mbar_wait(&full[st], (i / kStages) & 1);
    // a warp whose 16 keys hold none to count skips the tile
    const unsigned char c = codes[st * kTK + warp * 16 + (lane & 15)];
    if (__any_sync(kFull, live_any ? c == kLive : c != kPast)) {
      const unsigned char* code = codes + st * kTK + warp * 16;
      w.tile(sm + L::k + st * L::kTile, sm + L::v + st * L::kTile, warp * 16,
             [&](float dot, int j, int) { return score(dot, sl2, code[j]); }, lane);
    }
  }
  if constexpr (!L::kTma) cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge over it

  merge_and_store<T, kDp, kWarps>(
      w, sm, rows, g.D, g.n_split, split,
      [&](int r) { return out + ((long long)b * g.Hq + hk * g.G + row0 + r) * g.D; });
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 [B, T, Hkv, D] cache as a 4-D map (D, Hkv, T, B); boxes
// of 64 columns x 1 head x kTK keys, 128-byte swizzled; what lies past D or
// past the last key reads as 0
int make_map(CUtensorMap* map, const void* ptr, int B, int T, int Hkv, int D,
             int tk) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)T * Hkv * D * 2};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)tk, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;  // 10000 + the CUresult
}

template <typename T, int kDp>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask,
           void* out, int B, const Geometry& g, cudaStream_t s) {
  using L = Smem<T, kDp>;
  if (g.kps % L::kTK) return (int)cudaErrorInvalidValue;
  Maps maps{};
  if constexpr (L::kTma) {
    int e = make_map(&maps.k, k, B, g.T, g.Hkv, g.D, L::kTK);
    if (!e) e = make_map(&maps.v, v, B, g.T, g.Hkv, g.D, L::kTK);
    if (e) return e;
  }
  constexpr int bytes = L::bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_decode_kernel<T, kDp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_split, g.Hkv * g.n_rg, B);
  cfg.blockDim = dim3(L::kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, dense_decode_kernel<T, kDp>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), maps, mask,
      static_cast<T*>(out), g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,D], k/v [B,T,Hkv,D], mask bool [B,T], out [B,Hq,D], all contiguous
// and 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. D <= 128, a whole
// number of 16-byte pieces. The time axis is cut into n_split (<= 8) pieces
// of kps keys, kps a multiple of the tile (128 keys in bf16, 64 in fp32),
// (n_split - 1) * kps < T <= n_split * kps; the splits of one (slot, KV
// head, 16 query rows) form one cluster. Returns 0 when launched, a CUDA
// error, or 10000 + the CUresult of cuTensorMapEncodeTiled when a tensor map
// is refused.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const unsigned char* mask,
    void* out, int B, int Hq, int Hkv, int T, int D, int n_split, int kps,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || T <= 0 || D <= 0 || D > 128 ||
      B > 65535 || n_split < 1 || n_split > kMaxSplit || kps < 1 ||
      (long long)n_split * kps < T || (long long)(n_split - 1) * kps >= T)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.Hq = Hq; g.Hkv = Hkv; g.T = T; g.D = D; g.G = Hq / Hkv;
  g.n_split = n_split; g.kps = kps; g.n_rg = (g.G + kRows - 1) / kRows;
  g.scale = scale;
  if ((long long)Hkv * g.n_rg > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;
    return D <= 64 ? launch<float, 64>(q, k, v, mask, out, B, g, s)
                   : launch<float, 128>(q, k, v, mask, out, B, g, s);
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, g, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, mask, out, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
