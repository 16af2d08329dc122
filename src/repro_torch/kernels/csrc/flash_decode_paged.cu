// flash_decode_paged: fused paged-attention read, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:135
// flash_decode_paged (_paged_kernel, :70):
//   out[b,c,hq,:] = softmax_t( q[b,c,hq,:] . K[t,:] * D^-1/2, masked to
//                   -1e30 ) @ V
// over t in (pool rows reached through blocks[b,:]) U (ring lanes of slot b),
// K/V of pool row t = pages[blocks[b, t / ps], t % ps, hq / G, :], masked by
// view_ok[b, c, t]; ring lane r masked by ring_ok[b, r].
//
// Also the head-sharded read, flash_decode_paged_sharded (the TPU kernel
// under shard_map, src/repro/kernels/flash_decode.py:207): the pool and ring
// planes may be a TABLE of head shards, each with its own base pointers and
// hkv_s of the KV heads ([n_blocks, ps, hkv_s, D], [B, R, hkv_s, D]). KV
// head h of the grid reads shard h / hkv_s, its head h % hkv_s; q and out
// keep their whole head axis, the grid's head 0 at KV head h0 of them. So
// the shards that share a device are one grid, one launch (a virtual mesh on
// one card read 4 quarter-full grids in turn before); unsharded K2 is the
// table of one. The table is a __grid_constant__ parameter, passed by value,
// of at most 16 shards: a device with more is read by one launch per 16, each
// writing its own heads of one output (K1 likewise takes 32 planes, the K and
// V of 16 shards, a launch). A block's result depends
// only on its (slot, KV head, rows) and n_split, so any table gives
// unsharded K2's bits when it takes the unsharded split count.
//
// What bounds it on this card: bytes. Each K/V row serves the C x G query
// rows of its (slot, KV head) for 4 * C * G * D FLOP against 2 * D * elemsize
// bytes, and only the rows that some query column of the slot sees have to
// be read: in the engine a slot's live keys are a prefix of its view, and the
// unallocated tail of its page table is clamped to block 0. So the design
// reads the live rows once and nothing else, and keeps the memory busy:
//   * one pass with an online softmax (K is read once): per 16 keys one max
//     and one rescale; q.k is rounded to the I/O type as the JAX oracle
//     (src/repro/kernels/ref.py flash_decode_paged_ref) and the plain
//     version round it, the unnormalised probabilities are rounded to the
//     I/O type for P.V and l is kept in fp32, divided at the end. The
//     Pallas kernel keeps fp32 scores: in bf16 this kernel follows the
//     oracle's precision there, not the TPU kernel's;
//   * dead pages are not read. Each block reads its slot's page-table row
//     and view_ok bytes (C x P*ps, 4 bytes a lane, turned into bit planes by
//     ballots), marks a page live when any query column of the slot sees a
//     key in it, and the ring (one more unit after the last page) when any
//     ring_ok lane is set. Within a live page a key that no query row of
//     the block sees is not read either (cp.async zero-fills it);
//   * the dead-row rule: a query column with no live key at all must give
//     the plain version's uniform mean over all P*ps + R rows (retired slots
//     of the engine). A slot with such a column counts every page live, and
//     a block whose rows include one reads every V row and scores every key
//     -1e30, decided before any K/V row is read;
//   * key splits in a thread-block cluster: one block per (split, KV head,
//     group of 16 query rows, slot), the splits of one (slot, head, rows) a
//     cluster of at most 8 (the portable size). Each block counts the live
//     units from the mask it holds and takes its share of them in page order
//     (split s of n_split: live units [s n / n_split, (s + 1) n / n_split)
//     of n, rounded down), so splits are even however the live pages lie,
//     and a result never depends on timing. The
//     splits merge by log-sum-exp through distributed shared memory at the
//     end of the same kernel: one launch a call, no partial results in
//     device memory. n_split comes from the shapes and the SM count only
//     (kernels/flash_decode.py::_paged_splits);
//   * page gathers by cp.async, 16-byte pieces, neighbouring lanes on the
//     neighbouring bytes of a key row (rows of one head lie hkv_s * D elements
//     apart, pages anywhere in the pool): each warp walks its own chunks of
//     16 keys (chunks w, w + kWarps, ...) through a ring of stages (8 warps
//     and 3 stages in bf16), so a warp waits on its own copies only and no
//     block barrier sits in the loop;
//   * the rows of a (slot, KV head) are C x G (1 at stablelm's step decode,
//     up to 56 for GQA 28/4 at C = 8), scored 16 at a time on the tensor
//     cores (mma.sync m16n8k16, rows padded with zeros, K by ldmatrix and V
//     by ldmatrix.trans from a 128-byte swizzled chunk); float32 takes the
//     same structure on the CUDA cores.
// The warp's softmax and the cluster merge are shared with flash_decode.cu
// (decode_common.cuh).
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr uint32_t kIn = 1u << 31;  // a key word's bit: the key is in the split
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may use
constexpr int kNoCol = 30;          // the column bit of a padding row: never set
constexpr int kMaxShards = 16;      // head shards one launch reads

struct Geometry {
  int C, Hq, Hkv, D, P, ps, R, G, NR, n_rg, n_view, n_words, n_cg, n_split;
  int hkv_s;  // KV heads of one shard: grid head h is shard h / hkv_s's
  int h0;     // the KV head of q and out that grid head 0 is
  int al4;    // view_ok may be read 4 bytes at a time
  float scale;
};

// The planes of the head shards one launch reads: per shard the base
// pointers of its pool ([n_blocks, ps, hkv_s, D]) and ring ([B, R, hkv_s,
// D]) planes; ring pointers unused when R = 0.
template <typename T>
struct Shards {
  const T* pages_k[kMaxShards];
  const T* pages_v[kMaxShards];
  const T* ring_k[kMaxShards];
  const T* ring_v[kMaxShards];
};

// per type: values in a 16-byte piece, warps a block, stages of each warp's
// ring of 16-key chunks
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kVec = 8, kWarps = 8, kStages = 3;
};
template <> struct Cfg<float> {
  static constexpr int kVec = 4, kWarps = 4, kStages = 2;
};

// Shared memory of one block: the warps' K/V rings ([kWarps][kStages][K, V]
// chunks of 16 keys: bf16 in kDp / 64 swizzled boxes of [16 rows][128 B],
// fp32 in rows padded by 16 bytes), the 16 query rows (padded by 16 bytes),
// the key words of every stage, then the slot's tables (``Tables``). After
// the loop the rings hold the merge (``MergeArea``).
template <typename T, int kDp>
struct Smem {
  static constexpr int kWarps = Cfg<T>::kWarps, kStages = Cfg<T>::kStages;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = kDp + 16 / (int)sizeof(T);
  static constexpr int kTile = sizeof(T) == 2 ? 16 * kDp * 2 : 16 * kStride * 4;
  static constexpr int q = kWarps * kStages * 2 * kTile;
  static constexpr int words = q + kRows * kStride * (int)sizeof(T);
  static constexpr int fixed = words + kWarps * kStages * 16 * 4;
  static_assert(MergeArea<kDp, kWarps>::bytes <= q, "merge area must fit the rings");
};

// The slot's tables, after Smem::fixed: the view_ok bit planes of the
// block's query columns and their OR over all columns (bit l of word 4k + e
// is key 128k + 4l + e), the page-table row, the live units in order (a page
// index, or P for the ring), a byte per column (it has a live key) and per
// ring lane, and the live-unit count.
struct Tables {
  int planes, anyw, phys, units, colf, rok, misc, bytes;
};

__host__ __device__ inline Tables tables(int fixed, const Geometry& g) {
  Tables t;
  t.planes = fixed;
  t.anyw = t.planes + 4 * g.n_cg * g.n_words;
  t.phys = t.anyw + 4 * g.n_words;
  t.units = t.phys + 4 * g.P;
  t.colf = t.units + 4 * (g.P + 1);
  t.rok = t.colf + g.C;
  t.misc = (t.rok + g.R + 3) & ~3;
  t.bytes = t.misc + 16;
  return t;
}

// any bit of keys [lo, hi) in planes laid out as Tables' anyw
__device__ bool any_key(const uint32_t* w, int lo, int hi) {
  for (int k = lo >> 7; k <= (hi - 1) >> 7; ++k) {
    const int base = k << 7;
    for (int e = 0; e < 4; ++e) {
      const int a = max(lo - base - e, 0), z = hi - 1 - base - e;
      if (z < 0) continue;
      const int l0 = (a + 3) >> 2, l1 = min(z >> 2, 31);
      if (l0 > l1) continue;
      const uint32_t m = l1 - l0 == 31 ? kFull : ((1u << (l1 - l0 + 1)) - 1) << l0;
      if (w[4 * k + e] & m) return true;
    }
  }
  return false;
}

// q.k as the oracle's and the plain version's einsum returns it: rounded to
// the I/O type (the Pallas kernel keeps it in fp32)
template <typename T> __device__ __forceinline__ float round_io(float x);
template <> __device__ __forceinline__ float round_io<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_io<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int kDp> struct Warp;
template <int kDp> struct Warp<__nv_bfloat16, kDp> : WarpBf16<kDp, 16> {};
template <int kDp> struct Warp<float, kDp> : WarpF32<kDp> {};

// byte offset of 16-byte piece pc of key row r in a chunk
template <typename T, int kDp>
__device__ __forceinline__ int piece_at(int r, int pc) {
  if constexpr (sizeof(T) == 2)
    return (pc >> 3) * (16 * 128) + r * 128 + (((pc & 7) ^ (r & 7)) << 4);
  else
    return r * Smem<T, kDp>::kStride * 4 + pc * 16;
}

template <typename T, int kDp>
__global__ void __launch_bounds__(Smem<T, kDp>::kThreads) paged_decode_kernel(
    const T* __restrict__ q, const __grid_constant__ Shards<T> sh,
    const int* __restrict__ blocks, const unsigned char* __restrict__ view_ok,
    const unsigned char* __restrict__ ring_ok, T* __restrict__ out,
    Geometry g) {
  using L = Smem<T, kDp>;
  constexpr int kVec = Cfg<T>::kVec, kWarps = L::kWarps, kStages = L::kStages;
  constexpr int kThreads = L::kThreads, kStride = L::kStride, kTile = L::kTile;
  constexpr int kPieces = kDp / kVec;      // 16-byte pieces of a padded row
  constexpr int kKeysPass = 32 / kPieces;  // keys a warp copies at once
  extern __shared__ __align__(128) unsigned char sm[];
  const Tables tb = tables(L::fixed, g);
  uint32_t* planes = reinterpret_cast<uint32_t*>(sm + tb.planes);
  uint32_t* anyw = reinterpret_cast<uint32_t*>(sm + tb.anyw);
  int* phys = reinterpret_cast<int*>(sm + tb.phys);
  int* units = reinterpret_cast<int*>(sm + tb.units);
  unsigned char* colf = sm + tb.colf;
  unsigned char* rok = sm + tb.rok;
  int* misc = reinterpret_cast<int*>(sm + tb.misc);
  T* Qs = reinterpret_cast<T*>(sm + L::q);

  const int split = blockIdx.x;  // = the rank in the cluster (cluster = splits)
  const int h = blockIdx.y / g.n_rg, row0 = (blockIdx.y % g.n_rg) * kRows;
  const int b = blockIdx.z;
  // the shard that holds grid head h, h's head there, and its KV head in q
  // and out
  const int shard = h / g.hkv_s, hl = h - shard * g.hkv_s, hq0 = (g.h0 + h) * g.G;
  const T* pages_k = sh.pages_k[shard];
  const T* pages_v = sh.pages_v[shard];
  const T* ring_k = sh.ring_k[shard];
  const T* ring_v = sh.ring_v[shard];
  const int rows = min(kRows, g.NR - row0);
  const int c_lo = row0 / g.G, n_cols = (row0 + rows - 1) / g.G - c_lo + 1;
  const uint32_t gmask = (1u << n_cols) - 1;  // the block's columns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dch = g.D / kVec;  // 16-byte pieces of a row

  // ---- the slot's tables, the query rows ----------------------------------
  for (int i = tid; i < g.P; i += kThreads) phys[i] = blocks[(long long)b * g.P + i];
  for (int i = tid; i < g.C; i += kThreads) colf[i] = 0;
  for (int i = tid; i < g.n_words; i += kThreads) anyw[i] = 0;
  int ring_any = 0;
  for (int i = tid; i < g.R; i += kThreads) {
    const unsigned char o = ring_ok[(long long)b * g.R + i] != 0;
    rok[i] = o;
    ring_any |= o;
  }
  // query row r = row0 + r's (column, head of the group); zero past the
  // group and in the padding columns
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces, pc = i % kPieces;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows && pc < dch) {
      const int row = row0 + r, c = row / g.G, grp = row - c * g.G;
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)b * g.C + c) * g.Hq + hq0 + grp) * g.D + pc * kVec);
    }
    *reinterpret_cast<uint4*>(Qs + r * kStride + pc * kVec) = val;
  }
  // the padding columns of every chunk of every ring (copies never write them)
  if (dch < kPieces) {
    const int per = kPieces - dch;
    for (int i = tid; i < kWarps * kStages * 2 * 16 * per; i += kThreads) {
      const int chunk = i / (16 * per), r = (i / per) % 16, pc = dch + i % per;
      *reinterpret_cast<uint4*>(sm + chunk * kTile + piece_at<T, kDp>(r, pc)) =
          make_uint4(0, 0, 0, 0);
    }
  }
  ring_any = __syncthreads_or(ring_any);

  // ---- view_ok into bit planes: warps take (column, 128 keys) pairs, a lane
  // 4 bytes, four ballots a pair; four pairs' loads in flight a warp
  {
    const unsigned char* vrow = view_ok + (long long)b * g.C * g.n_view;
    const int n_grp = (g.n_view + 127) >> 7, n_pairs = g.C * n_grp;
    for (int p0 = warp; p0 < n_pairs; p0 += 4 * kWarps) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pr = p0 + j * kWarps;
        v[j] = 0;
        if (pr < n_pairs) {
          const int c = pr / n_grp, t = (pr - c * n_grp) * 128 + lane * 4;
          const unsigned char* src = vrow + (long long)c * g.n_view + t;
          if (g.al4 && t < g.n_view) {
            v[j] = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int e = 0; e < 4; ++e)
              if (t + e < g.n_view) v[j] |= (uint32_t)(src[e] != 0) << (8 * e);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pr = p0 + j * kWarps;  // the same for the whole warp
        if (pr >= n_pairs) break;
        const int c = pr / n_grp, k = pr - c * n_grp;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t word = __ballot_sync(kFull, (v[j] >> (8 * e)) & 0xffu);
          if (lane == 0) {
            if (c >= c_lo && c < c_lo + n_cols)
              planes[(c - c_lo) * g.n_words + 4 * k + e] = word;
            if (word) {
              colf[c] = 1;
              atomicOr(&anyw[4 * k + e], word);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- the dead-row rule, decided before any K/V row is read --------------
  int dead = 0, gdead = 0;
  for (int c = tid; c < g.C; c += kThreads) {
    const int d = !colf[c] && !ring_any;
    dead |= d;
    if (c >= c_lo && c < c_lo + n_cols) gdead |= d;
  }
  const bool slot_dead = __syncthreads_or(dead) != 0;
  const bool group_dead = __syncthreads_or(gdead) != 0;

  // ---- live units (pages, then the ring), compacted in order --------------
  const int n_all = g.P + (g.R > 0 ? 1 : 0);
  for (int u = tid; u < n_all; u += kThreads)
    units[u] = slot_dead ||
               (u < g.P ? any_key(anyw, u * g.ps, (u + 1) * g.ps) : ring_any != 0);
  __syncthreads();
  if (warp == 0) {  // in place: an entry is written at or before where it was read
    int n = 0;
    for (int u0 = 0; u0 < n_all; u0 += 32) {
      const int u = u0 + lane;
      const bool live = u < n_all && units[u] != 0;
      const uint32_t bal = __ballot_sync(kFull, live);
      if (live) units[n + __popc(bal & ((1u << lane) - 1))] = u;
      n += __popc(bal);
    }
    if (lane == 0) misc[0] = n;
  }
  __syncthreads();

  // ---- this block's share: live units [lo, hi), the ring last -------------
  const int n_u = misc[0];
  const int lo = (int)((long long)split * n_u / g.n_split);
  const int hi = (int)((long long)(split + 1) * n_u / g.n_split);
  const bool has_ring = g.R > 0 && hi > lo && units[hi - 1] == g.P;
  const int n_page_keys = (hi - lo - (has_ring ? 1 : 0)) * g.ps;
  const int n_keys = n_page_keys + (has_ring ? g.R : 0);
  const int n_chunks = (n_keys + 15) / 16;
  const int mine = warp < n_chunks ? (n_chunks - 1 - warp) / kWarps + 1 : 0;

  unsigned char* wring = sm + warp * kStages * 2 * kTile;
  uint32_t* wwords = reinterpret_cast<uint32_t*>(sm + L::words) + warp * kStages * 16;
  uint32_t need_bits = 0;  // bit st: stage st holds a chunk to count
  // this warp's i-th chunk (keys 16 (warp + i kWarps) ..) into stage st: lane
  // j < 16 works out key j's source row and word (bit c: column c_lo + c sees
  // it; kIn: it is in the split), then every lane copies pieces of the keys
  auto fetch = [&](int i, int st) {
    long long off = 0;
    uint32_t word = 0;
    int in_ring = 0;
    if (lane < 16) {
      const int kk = (warp + i * kWarps) * 16 + lane;
      if (kk < n_page_keys) {
        const int j = kk / g.ps, r = kk - j * g.ps;
        const int u = units[lo + j], t = u * g.ps + r;
        off = (((long long)phys[u] * g.ps + r) * g.hkv_s + hl) * g.D;
        const int wi = 4 * (t >> 7) + (t & 3), sh = (t >> 2) & 31;
        word = kIn;
        for (int jc = 0; jc < n_cols; ++jc)
          word |= ((planes[jc * g.n_words + wi] >> sh) & 1u) << jc;
      } else if (kk < n_keys) {
        const int rr = kk - n_page_keys;
        off = (((long long)b * g.R + rr) * g.hkv_s + hl) * g.D;
        in_ring = 1;
        word = kIn | (rok[rr] ? gmask : 0u);
      }
      wwords[st * 16 + lane] = word;
    }
    const bool need =
        __any_sync(kFull, group_dead ? (word & kIn) != 0 : (word & gmask) != 0);
    need_bits = (need_bits & ~(1u << st)) | ((uint32_t)need << st);
    if (need) {
      unsigned char* kt = wring + st * 2 * kTile;
      const int pc = lane % kPieces;
#pragma unroll
      for (int p = 0; p < 16 / kKeysPass; ++p) {
        const int key = p * kKeysPass + lane / kPieces;
        const long long o =
            ((long long)__shfl_sync(kFull, (int)(off >> 32), key) << 32) |
            (unsigned)__shfl_sync(kFull, (int)off, key);
        const uint32_t wd = __shfl_sync(kFull, word, key);
        const int rg = __shfl_sync(kFull, in_ring, key);
        if (pc < dch) {
          const bool ldk = (wd & gmask) != 0;
          const bool ldv = ldk || (group_dead && (wd & kIn));
          const T* kb = rg ? ring_k : pages_k;
          const T* vb = rg ? ring_v : pages_v;
          const int so = piece_at<T, kDp>(key, pc);
          cp_async16(kt + so, ldk ? kb + o + pc * kVec : pages_k, ldk);
          cp_async16(kt + kTile + so, ldv ? vb + o + pc * kVec : pages_v, ldv);
        }
      }
    }
    cp_async_commit();
  };

  Warp<T, kDp> w;
  w.init(Qs, rows, lane);
  const float sl2 = g.scale * kLog2e;
  // a key's base-2 score for query row r: q.k rounded to the I/O type, as
  // the plain version's einsum gives it, where live; -1e30 where masked (as
  // the plain version), -inf past the split (never counted)
  auto col_of = [&](int r) { return r < rows ? (row0 + r) / g.G - c_lo : kNoCol; };
  const int col_lo = col_of(lane >> 2), col_hi = col_of((lane >> 2) + 8);
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) fetch(i, i);
    else cp_async_commit();  // an empty group keeps the count
  }
  for (int i = 0; i < mine; ++i) {
    const int st = i % kStages;
    __syncwarp();  // the warp is done with chunk i - 1: its stage is free
    if (i + kStages - 1 < mine) fetch(i + kStages - 1, (i + kStages - 1) % kStages);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk i's copies have landed
    __syncwarp();
    if (!((need_bits >> st) & 1u)) continue;
    const uint32_t* wd = wwords + st * 16;
    const unsigned char* kt = wring + st * 2 * kTile;
    auto score = [&](float dot, int j, int col) {
      const uint32_t word = wd[j];
      return (word >> col) & 1u ? round_io<T>(dot) * sl2
                                : (word & kIn) ? kMasked : -INFINITY;
    };
    if constexpr (sizeof(T) == 2)
      w.tile(kt, kt + kTile, 0,
             [&](float dot, int j, int hh) { return score(dot, j, hh ? col_hi : col_lo); },
             lane);
    else
      w.tile(kt, kt + kTile, 0,
             [&](float dot, int j, int r) { return score(dot, j, col_of(r)); }, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: merge over them

  merge_and_store<T, kDp, kWarps>(w, sm, rows, g.D, g.n_split, split, [&](int r) {
    const int row = row0 + r, c = row / g.G, grp = row - c * g.G;
    return out + (((long long)b * g.C + c) * g.Hq + hq0 + grp) * g.D;
  });
}

template <typename T, int kDp>
int launch(const void* q, int n_shards, const void* const* pages_k,
           const void* const* pages_v, const void* const* ring_k,
           const void* const* ring_v, const int* blocks,
           const unsigned char* view_ok, const unsigned char* ring_ok,
           void* out, int B, const Geometry& g, cudaStream_t s) {
  using L = Smem<T, kDp>;
  const int bytes = tables(L::fixed, g).bytes;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Shards<T> sh = {};
  for (int j = 0; j < n_shards; ++j) {
    sh.pages_k[j] = static_cast<const T*>(pages_k[j]);
    sh.pages_v[j] = static_cast<const T*>(pages_v[j]);
    sh.ring_k[j] = g.R ? static_cast<const T*>(ring_k[j]) : nullptr;
    sh.ring_v[j] = g.R ? static_cast<const T*>(ring_v[j]) : nullptr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_split, n_shards * g.hkv_s * g.n_rg, B);
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
      &cfg, paged_decode_kernel<T, kDp>, static_cast<const T*>(q), sh, blocks,
      view_ok, ring_ok, static_cast<T*>(out), g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int kDp>
int allow_smem() {
  return (int)cudaFuncSetAttribute(paged_decode_kernel<T, kDp>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
}

}  // namespace

// Lets every instantiation of the kernel take up to 227 KB of dynamic
// shared memory on the current device; call once per device before the
// first launch (the launches then make no other runtime call). Returns 0 or
// a CUDA error.
extern "C" int flash_decode_paged_prepare() {
  int e = allow_smem<float, 64>();
  if (!e) e = allow_smem<float, 128>();
  if (!e) e = allow_smem<__nv_bfloat16, 64>();
  if (!e) e = allow_smem<__nv_bfloat16, 128>();
  return e;
}

// q [B,C,Hq,D] over Hkv KV heads; n_shards (1..16) head shards, each with
// its pool planes [n_blocks,ps,hkv_s,D] and ring planes [B,R,hkv_s,D] (host
// arrays of n_shards device pointers), together KV heads [h0, h0 + n_shards
// hkv_s) of q's: KV head h0 + h is shard h / hkv_s's. A table of more head
// shards is read by one launch per 16, each writing its heads of out.
// blocks int32 [B,P], view_ok bool [B,C,P*ps], ring_ok bool
// [B,R], out [B,C,Hq,D], all contiguous, q / pages / ring / out 16-byte
// aligned. dtype: 0 = float32, 1 = bfloat16. D <= 128, a whole number of
// 16-byte pieces. R = 0 means no ring (ring arrays unused). The live units
// of a slot are shared among n_split (1..8) blocks of a cluster. Returns 0
// when launched, else a CUDA error (cudaErrorInvalidValue for what the
// kernel does not take, shared memory past 227 KB included).
extern "C" int flash_decode_paged_launch(
    const void* q, int n_shards, const void* const* pages_k,
    const void* const* pages_v, const void* const* ring_k,
    const void* const* ring_v, const int* blocks,
    const unsigned char* view_ok, const unsigned char* ring_ok, void* out,
    int B, int C, int Hq, int Hkv, int D, int P, int ps, int R, int n_split,
    int hkv_s, int h0, float scale, int dtype, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || hkv_s < 1 || h0 < 0 ||
      h0 + (long long)n_shards * hkv_s > Hkv)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D > 128 ||
      B > 65535 || P < 0 || ps <= 0 || R < 0 || (long long)P * ps + R <= 0 ||
      (long long)P * ps > (1 << 30) || n_split < 1 || n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.C = C; g.Hq = Hq; g.Hkv = Hkv; g.D = D; g.P = P; g.ps = ps; g.R = R;
  g.G = Hq / Hkv; g.NR = C * g.G; g.n_rg = (g.NR + kRows - 1) / kRows;
  g.n_view = P * ps; g.n_words = 4 * ((g.n_view + 127) / 128);
  g.n_cg = 15 / g.G + 2;  // columns 16 consecutive query rows can span
  if (g.n_cg > kRows) g.n_cg = kRows;
  if (g.n_cg > C) g.n_cg = C;
  g.n_split = n_split;
  g.hkv_s = hkv_s;
  g.h0 = h0;
  g.al4 = g.n_view % 4 == 0 && reinterpret_cast<uintptr_t>(view_ok) % 4 == 0;
  g.scale = scale;
  if ((long long)n_shards * hkv_s * g.n_rg > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;
    return D <= 64 ? launch<float, 64>(q, n_shards, pages_k, pages_v, ring_k, ring_v,
                                       blocks, view_ok, ring_ok, out, B, g, s)
                   : launch<float, 128>(q, n_shards, pages_k, pages_v, ring_k, ring_v,
                                        blocks, view_ok, ring_ok, out, B, g, s);
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return D <= 64
               ? launch<__nv_bfloat16, 64>(q, n_shards, pages_k, pages_v, ring_k,
                                           ring_v, blocks, view_ok, ring_ok,
                                           out, B, g, s)
               : launch<__nv_bfloat16, 128>(q, n_shards, pages_k, pages_v, ring_k,
                                            ring_v, blocks, view_ok, ring_ok,
                                            out, B, g, s);
  }
  return (int)cudaErrorInvalidValue;
}
