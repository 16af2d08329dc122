// staged_scatter: the unload path's drain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/staged_scatter.py:44
// staged_scatter (_drain_kernel). For every plane p of a table and every
// layer l of that plane:
//   dest_p[l][dst_row[i]][:] = staging_p[l][i][:]
// where valid[i] and 0 <= dst_row[i] < n_rows_p, in place. The routing
// (dst_row, valid) is one list shared by every plane: the K and V planes of
// the paged pool, and every head shard of them that sits on this device,
// drain in ONE launch.
//
// What bounds it on this card: bytes, 2 * n_valid * row bytes a (plane,
// layer), plus the routing. The design:
//   * the routing is read as the caller holds it: int32 or int64 rows (a
//     template on the index type), bool valid, any element stride. No
//     conversion kernel runs before the launch;
//   * the table of planes (destination, staging, row size, layer strides,
//     layer and row counts) is a __grid_constant__ parameter, passed by
//     value: no device array, no copy of its own. A block reads its plane
//     from the parameter space;
//   * one block per (staged entry, group of kLayers layers, plane). It loads
//     the predicate and the row together (neither load waits for the
//     other), and only a live, in-range entry reads payload: the gated
//     in-segment drain, where nothing is due, reads 2 routing values a
//     block and no row;
//   * a thread keeps kLayers x kPer 16-byte loads in flight before its
//     stores (a block's layers and two vectors of each row), streamed
//     (ld.global.cs: the staging is read once). 8 layers a block: of the
//     variants timed (1 x 1 to 8 x 2), it has the fewest blocks for the
//     gated drain with nothing due (384 at the paged engine's shape) and
//     the fastest full drain;
//   * the block is sized to the widest row: ceil(vectors / kPer) threads,
//     rounded to a warp, at most 256 (a 1536-wide bf16 row is 192 vectors:
//     96 threads);
//   * rows move as 16-byte vectors when every row size, base pointer and
//     layer stride allows it, else in the largest power-of-two unit that
//     does (at least the element size).
// Valid destination rows are unique within one drain, so blocks never write
// the same bytes.
//
// staged_gather: the drain's adjoint, for training's staged MoE dispatch.
// It replaces no TPU kernel: the JAX package takes this gradient by autodiff
// of its .at[dst].set(mode="drop"). For a drain of one plane
// (dest[dst_row[i]] = staging[i] where valid[i]) the gradient of the staging
// rows is
//   grad_staging[i][:] = valid[i] && 0 <= dst_row[i] < n_rows
//                        ? grad_dest[dst_row[i]][:] : 0,
// a row gather over the same routing list, read as the caller holds it
// (int32 or int64, any stride), in one launch. Bound: bytes, the valid rows
// read once and every output row written once, plus the routing. One block
// a staged entry, the drain's vector widths and block size; a dropped entry
// writes its zeros without reading.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 32;  // planes a launch (the table is 1.5 KB)
constexpr int kLayers = 8;      // layers a block
constexpr int kPer = 2;         // vectors of one row a thread loads at once
constexpr int kMaxThreads = 256;

struct Plane {
  unsigned char* dest;
  const unsigned char* staging;
  long long dest_layer;     // bytes from one layer to the next
  long long staging_layer;
  int n_vec;                // units a row
  int n_layers;
  int n_rows;               // destination rows; an entry past them is dropped
};

struct Table {
  Plane p[kMaxPlanes];
};

template <typename U, typename I>
__global__ void __launch_bounds__(kMaxThreads) drain_rows_kernel(
    const __grid_constant__ Table t, const I* __restrict__ dst_row,
    long long row_stride, const unsigned char* __restrict__ valid,
    long long valid_stride) {
  const Plane& p = t.p[blockIdx.z];
  const int l0 = blockIdx.y * kLayers;
  if (l0 >= p.n_layers) return;
  const long long i = blockIdx.x;
  // the predicate and the row together: neither load waits for the other
  const unsigned char ok = valid[i * valid_stride];
  const long long r = (long long)dst_row[i * row_stride];
  if (!ok || r < 0 || r >= p.n_rows) return;
  const int nl = min(kLayers, p.n_layers - l0);
  const int n = p.n_vec;
  const U* src = reinterpret_cast<const U*>(p.staging + l0 * p.staging_layer) + i * n;
  U* dst = reinterpret_cast<U*>(p.dest + l0 * p.dest_layer) + r * n;
  const long long sl = p.staging_layer / (long long)sizeof(U);
  const long long dl = p.dest_layer / (long long)sizeof(U);
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

template <typename U, typename I>
int launch(const Table& t, int n_planes, int max_layers, int threads,
           const void* dst_row, long long row_stride,
           const unsigned char* valid, long long valid_stride, int n_staged,
           cudaStream_t s) {
  dim3 grid(n_staged, (max_layers + kLayers - 1) / kLayers, n_planes);
  drain_rows_kernel<U, I><<<grid, threads, 0, s>>>(
      t, static_cast<const I*>(dst_row), row_stride, valid, valid_stride);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_idx(const Table& t, int n_planes, int max_layers, int threads,
               const void* dst_row, int idx_bytes, long long row_stride,
               const unsigned char* valid, long long valid_stride,
               int n_staged, cudaStream_t s) {
  if (idx_bytes == 8)
    return launch<U, long long>(t, n_planes, max_layers, threads, dst_row,
                                row_stride, valid, valid_stride, n_staged, s);
  if (idx_bytes == 4)
    return launch<U, int>(t, n_planes, max_layers, threads, dst_row,
                          row_stride, valid, valid_stride, n_staged, s);
  return (int)cudaErrorInvalidValue;
}

template <typename U, typename I>
__global__ void __launch_bounds__(kMaxThreads) gather_rows_kernel(
    U* __restrict__ out, const U* __restrict__ src, int n_vec, int n_rows,
    const I* __restrict__ dst_row, long long row_stride,
    const unsigned char* __restrict__ valid, long long valid_stride) {
  const long long i = blockIdx.x;
  const unsigned char ok = valid[i * valid_stride];
  const long long r = (long long)dst_row[i * row_stride];
  U* dst = out + i * n_vec;
  if (!ok || r < 0 || r >= n_rows) {
    const U zero = U();
    for (int j = threadIdx.x; j < n_vec; j += blockDim.x) dst[j] = zero;
    return;
  }
  const U* row = src + r * n_vec;
  const int step = kPer * blockDim.x;
  for (int base = threadIdx.x; base < n_vec; base += step) {
    U v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = base + k * blockDim.x;
      if (j < n_vec) v[k] = row[j];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = base + k * blockDim.x;
      if (j < n_vec) dst[j] = v[k];
    }
  }
}

template <typename U>
int launch_gather(void* out, const void* src, int n_vec, int n_rows,
                  const void* dst_row, int idx_bytes, long long row_stride,
                  const unsigned char* valid, long long valid_stride, int n,
                  int threads, cudaStream_t s) {
  if (idx_bytes == 8) {
    gather_rows_kernel<U, long long><<<n, threads, 0, s>>>(
        static_cast<U*>(out), static_cast<const U*>(src), n_vec, n_rows,
        static_cast<const long long*>(dst_row), row_stride, valid, valid_stride);
  } else if (idx_bytes == 4) {
    gather_rows_kernel<U, int><<<n, threads, 0, s>>>(
        static_cast<U*>(out), static_cast<const U*>(src), n_vec, n_rows,
        static_cast<const int*>(dst_row), row_stride, valid, valid_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The drain's adjoint: out[i] = src[dst_row[i]] where valid[i] and
// 0 <= dst_row[i] < n_rows, else zeros. out [n, row_bytes] and src [n_rows,
// row_bytes] row-contiguous; the routing as staged_scatter_launch takes it.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int staged_gather_launch(
    void* out, const void* src, long long row_bytes, int n_rows,
    const void* dst_row, int idx_bytes, long long row_stride,
    const unsigned char* valid, long long valid_stride, int n, int elem_size,
    void* stream) {
  if (n <= 0 || n_rows < 0 || row_bytes <= 0 || (elem_size != 2 && elem_size != 4) ||
      row_bytes % elem_size)
    return (int)cudaErrorInvalidValue;
  int unit = 16;
  const unsigned long long bits = (unsigned long long)row_bytes |
                                  reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(src);
  while (unit > elem_size && (bits & (unit - 1))) unit >>= 1;
  const long long vecs = row_bytes / unit;
  if (vecs > (1LL << 30)) return (int)cudaErrorInvalidValue;
  long long threads = ((vecs + kPer - 1) / kPer + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (int)vecs, th = (int)threads;
  switch (unit) {
    case 16:
      return launch_gather<uint4>(out, src, nv, n_rows, dst_row, idx_bytes,
                                  row_stride, valid, valid_stride, n, th, s);
    case 8:
      return launch_gather<uint2>(out, src, nv, n_rows, dst_row, idx_bytes,
                                  row_stride, valid, valid_stride, n, th, s);
    case 4:
      return launch_gather<unsigned int>(out, src, nv, n_rows, dst_row, idx_bytes,
                                         row_stride, valid, valid_stride, n, th, s);
    default:
      return launch_gather<unsigned short>(out, src, nv, n_rows, dst_row,
                                           idx_bytes, row_stride, valid,
                                           valid_stride, n, th, s);
  }
}

// One drain of n_planes planes (at most kMaxPlanes) over one routing list:
// per plane its dest and staging base pointers, row bytes, bytes from one
// layer to the next in each, its layer count and destination row count
// (host arrays, copied into the kernel's parameters). dst_row: n_staged
// indices of idx_bytes (4 or 8) bytes, row_stride elements apart; valid:
// n_staged bools, valid_stride apart. elem_size: 2 or 4, the smallest unit
// a row moves in. Returns cudaGetLastError() after the launch (0 =
// launched); cudaErrorInvalidValue for what the kernel does not take.
extern "C" int staged_scatter_launch(
    int n_planes, void* const* dest, const void* const* staging,
    const long long* row_bytes, const long long* dest_layer_bytes,
    const long long* staging_layer_bytes, const int* n_layers,
    const int* n_rows, const void* dst_row, int idx_bytes,
    long long row_stride, const unsigned char* valid, long long valid_stride,
    int n_staged, int elem_size, void* stream) {
  if (n_planes <= 0 || n_planes > kMaxPlanes || n_staged <= 0 ||
      (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  // the largest unit every row size, base pointer and layer stride allows
  int unit = 16;
  int max_layers = 0;
  long long max_bytes = 0;
  for (int j = 0; j < n_planes; ++j) {
    if (n_layers[j] <= 0 || row_bytes[j] <= 0 || row_bytes[j] % elem_size)
      return (int)cudaErrorInvalidValue;
    // (a plane of one layer never steps to a next layer)
    unsigned long long bits = (unsigned long long)row_bytes[j] |
                              reinterpret_cast<uintptr_t>(dest[j]) |
                              reinterpret_cast<uintptr_t>(staging[j]);
    if (n_layers[j] > 1)
      bits |= (unsigned long long)dest_layer_bytes[j] |
              (unsigned long long)staging_layer_bytes[j];
    while (unit > elem_size && (bits & (unit - 1))) unit >>= 1;
    if (n_layers[j] > max_layers) max_layers = n_layers[j];
    if (row_bytes[j] > max_bytes) max_bytes = row_bytes[j];
  }
  if ((max_layers + kLayers - 1) / kLayers > 65535 ||
      max_bytes / unit > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Table t = {};
  for (int j = 0; j < n_planes; ++j) {
    t.p[j].dest = static_cast<unsigned char*>(dest[j]);
    t.p[j].staging = static_cast<const unsigned char*>(staging[j]);
    t.p[j].dest_layer = dest_layer_bytes[j];
    t.p[j].staging_layer = staging_layer_bytes[j];
    t.p[j].n_vec = (int)(row_bytes[j] / unit);
    t.p[j].n_layers = n_layers[j];
    t.p[j].n_rows = n_rows[j];
  }
  const long long vecs = max_bytes / unit;
  long long threads = ((vecs + kPer - 1) / kPer + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int th = (int)threads;
  switch (unit) {
    case 16:
      return launch_idx<uint4>(t, n_planes, max_layers, th, dst_row, idx_bytes,
                               row_stride, valid, valid_stride, n_staged, s);
    case 8:
      return launch_idx<uint2>(t, n_planes, max_layers, th, dst_row, idx_bytes,
                               row_stride, valid, valid_stride, n_staged, s);
    case 4:
      return launch_idx<unsigned int>(t, n_planes, max_layers, th, dst_row,
                                      idx_bytes, row_stride, valid,
                                      valid_stride, n_staged, s);
    default:
      return launch_idx<unsigned short>(t, n_planes, max_layers, th, dst_row,
                                        idx_bytes, row_stride, valid,
                                        valid_stride, n_staged, s);
  }
}
