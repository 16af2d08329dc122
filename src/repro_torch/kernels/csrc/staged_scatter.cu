// staged_scatter: the unload path's drain, for Hopper (sm_90a).
//
// dest[l][dst_row[i]][:] = staging[l][i][:]  where valid[i] and
// 0 <= dst_row[i] < n_rows_dest, in place, for every layer l of one plane.
//
// One block per (staged row, layer). The predicate is read from global
// memory by the block itself, so an entry that is not live costs one
// 5-byte read and no copy. A row is a plain byte copy: it moves as 16-byte
// vectors when the row size, both base pointers and both layer strides are
// 16-byte aligned, and in units of the element size (2 or 4 bytes)
// otherwise. Valid destination rows are unique within one drain, so blocks
// never write the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads) drain_rows_kernel(
    unsigned char* __restrict__ dest, const unsigned char* __restrict__ staging,
    const int* __restrict__ dst_row, const unsigned char* __restrict__ valid,
    long long dest_layer_bytes, long long staging_layer_bytes,
    int n_rows_dest, long long row_bytes) {
  const int i = blockIdx.x;
  const int l = blockIdx.y;
  if (!valid[i]) return;
  const int r = dst_row[i];
  if (r < 0 || r >= n_rows_dest) return;
  const U* src = reinterpret_cast<const U*>(
      staging + l * staging_layer_bytes + (long long)i * row_bytes);
  U* dst = reinterpret_cast<U*>(
      dest + l * dest_layer_bytes + (long long)r * row_bytes);
  const long long n = row_bytes / (long long)sizeof(U);
  for (long long j = threadIdx.x; j < n; j += kThreads) dst[j] = src[j];
}

template <typename U>
int launch(void* dest, const void* staging, const int* dst_row,
           const unsigned char* valid, int n_layers, int n_staged,
           int n_rows_dest, long long row_bytes, long long dest_layer_bytes,
           long long staging_layer_bytes, cudaStream_t stream) {
  dim3 grid(n_staged, n_layers);
  drain_rows_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<unsigned char*>(dest),
      static_cast<const unsigned char*>(staging), dst_row, valid,
      dest_layer_bytes, staging_layer_bytes, n_rows_dest, row_bytes);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int staged_scatter_launch(
    void* dest, const void* staging, const int* dst_row,
    const unsigned char* valid, int n_layers, int n_staged, int n_rows_dest,
    long long row_bytes, int elem_size, long long dest_layer_bytes,
    long long staging_layer_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers <= 0 || n_staged <= 0 || n_layers > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = (row_bytes % 16 == 0) && aligned16(dest) &&
                   aligned16(staging) && (dest_layer_bytes % 16 == 0) &&
                   (staging_layer_bytes % 16 == 0);
  if (vec)
    return launch<uint4>(dest, staging, dst_row, valid, n_layers, n_staged,
                         n_rows_dest, row_bytes, dest_layer_bytes,
                         staging_layer_bytes, s);
  if (elem_size == 4)
    return launch<uint32_t>(dest, staging, dst_row, valid, n_layers, n_staged,
                            n_rows_dest, row_bytes, dest_layer_bytes,
                            staging_layer_bytes, s);
  if (elem_size == 2)
    return launch<uint16_t>(dest, staging, dst_row, valid, n_layers, n_staged,
                            n_rows_dest, row_bytes, dest_layer_bytes,
                            staging_layer_bytes, s);
  return (int)cudaErrorInvalidValue;
}
