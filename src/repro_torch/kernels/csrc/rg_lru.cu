// RG-LRU diagonal linear recurrence for Hopper.
//
// Replaces the Pallas TPU kernel `rg_lru_scan` in src/repro/kernels/rg_lru.py
// (body `_rg_lru_kernel`).  Per batch row b and channel c:
//
//     h_t = a_t * h_{t-1} + b_t,        y_t = h_t
//
// a, b are (B, S, d) of one dtype (float32 or bfloat16), h0 (B, d) float32;
// y (B, S, d) and h_last (B, d) are float32, and so is the arithmetic.  Any
// S >= 1 is taken (no chunk padding).
//
// What bounds it on this card: at the recurrentgemma-9b serving shape
// (B = 8, S = 128, d = 4096, f32) it must read a and b (33.6 MB) and write
// y (16.8 MB), plus h0 and h_last: 50 MB, 15 us at 3.35 TB/s, for one
// multiply-add per element -- it is bound by bytes.  The design:
//   * one thread per (batch row, channel), h in a register, the time
//     recurrence a loop inside the thread (the TPU's sequential chunk grid
//     axis becomes that loop);
//   * neighbouring threads take neighbouring channels, so every load of a
//     and b and every store of y is coalesced;
//   * the loads of UNROLL steps are issued before any of them is used, so
//     each thread keeps 2 * UNROLL loads in flight instead of waiting out
//     one memory latency per step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ bv,
              const float* __restrict__ h0, float* __restrict__ y,
              float* __restrict__ h_last, int S, int d) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  float h = h0[(long long)b * d + c];
  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float av[UNROLL], bb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = ((long long)b * S + t0 + u) * d + c;
      const bool in = t0 + u < S;
      av[u] = in ? to_f32(a[g]) : 1.f;
      bb[u] = in ? to_f32(bv[g]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < S) {
        h = av[u] * h + bb[u];
        y[((long long)b * S + t0 + u) * d + c] = h;
      }
    }
  }
  h_last[(long long)b * d + c] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* y,
                   float* h_last, int B, int S, int d, cudaStream_t stream) {
  dim3 grid((d + THREADS - 1) / THREADS, B);
  rg_lru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, y, h_last, S, d);
  return cudaGetLastError();
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16.  Returns cudaError_t.
extern "C" int rg_lru_launch(const void* a, const void* b, const void* h0, void* y,
                             void* h_last, int B, int S, int d, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_last);
  if (dtype == 0) return (int)launch<float>(a, b, h, yo, ho, B, S, d, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, h, yo, ho, B, S, d, s);
  return (int)cudaErrorInvalidValue;
}
