// Paged row gather for Hopper: out[i] = pool[table[i]].
//
// Replaces the Pallas TPU kernel `page_gather` in
// src/repro/kernels/page_gather.py (body `_gather_kernel`), where the page
// table is a scalar-prefetch operand and the BlockSpec index map selects
// the pool row, so the gather is pure block DMA.  Here pool is (P, W) of
// any dtype, table (N,) int32 on the device, out (N, W) in the pool's
// dtype.  The kernel copies bytes: it never looks at the element type.
//
// What bounds it on this card: it is a copy, 2 * N * W * elem bytes and no
// arithmetic.  At the streaming-decode shape (one stablelm-1.6b layer's KV
// pool flattened to (128, 16 * 32 * 64) bf16, N = 8 rows x 8 pages = 64)
// that is 8.4 MB, 2.5 us at 3.35 TB/s.  The design keeps every byte on the
// widest load the alignment allows and spreads a row over several blocks:
//   * grid (chunk of a row, output row): a block copies THREADS * UNROLL
//     words of one row, so a 64 KB row is 4 blocks and the 64 rows of the
//     main shape fill 256 blocks, about two per SM;
//   * each block reads its own index from the table (Hopper has no scalar
//     prefetch); every thread issues its UNROLL loads before its stores;
//   * the word is 16 bytes (uint4) when both base pointers and the row
//     length are 16-byte aligned, else the widest of 4, 2, 1 bytes that is;
//     the last chunk of each row is masked, so W need not be a multiple of
//     the vector width;
//   * an index outside [0, P) writes a row of zeros and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long MAX_GRID_Y = 65535;

template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const W* __restrict__ pool, const int* __restrict__ table,
              W* __restrict__ out, long long P, long long N, long long row_words) {
  const long long w0 = (long long)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  for (long long i = blockIdx.y; i < N; i += gridDim.y) {
    const long long src = table[i];
    W* dst = out + i * row_words;
    if (src < 0 || src >= P) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long w = w0 + (long long)u * THREADS;
        if (w < row_words) dst[w] = W{};
      }
      continue;
    }
    const W* s = pool + src * row_words;
    W buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = w0 + (long long)u * THREADS;
      if (w < row_words) buf[u] = s[w];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = w0 + (long long)u * THREADS;
      if (w < row_words) dst[w] = buf[u];
    }
  }
}

template <typename W>
cudaError_t launch(const void* pool, const int* table, void* out, long long P,
                   long long N, long long row_bytes, cudaStream_t stream) {
  const long long row_words = row_bytes / (long long)sizeof(W);
  const long long per_block = (long long)THREADS * UNROLL;
  const long long gx = (row_words + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)(N < MAX_GRID_Y ? N : MAX_GRID_Y));
  gather_kernel<W><<<grid, THREADS, 0, stream>>>(
      static_cast<const W*>(pool), table, static_cast<W*>(out), P, N, row_words);
  return cudaGetLastError();
}

}  // namespace

// pool (P, row_bytes) and out (N, row_bytes) are contiguous byte rows; table
// (N,) int32.  Returns cudaError_t.
extern "C" int page_gather_launch(const void* pool, const void* table, void* out,
                                  long long P, long long N, long long row_bytes,
                                  void* stream) {
  if (P < 0 || N < 0 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const uintptr_t align = (uintptr_t)pool | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) return (int)launch<uint4>(pool, t, out, P, N, row_bytes, s);
  if (align % 4 == 0) return (int)launch<uint32_t>(pool, t, out, P, N, row_bytes, s);
  if (align % 2 == 0) return (int)launch<uint16_t>(pool, t, out, P, N, row_bytes, s);
  return (int)launch<uint8_t>(pool, t, out, P, N, row_bytes, s);
}
