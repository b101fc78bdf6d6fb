// Suffix-bank grouped GEMM for Hopper: out[n] = x[n] @ w[n] (+ b[n]).
//
// Replaces the Pallas TPU kernel `bank_matmul` in
// src/repro/kernels/bank_matmul.py (bodies `_bank_kernel` and
// `_bank_bias_kernel`).  x is banked (N, M, K) or broadcast (M, K) -- a
// bank stride of 0 -- w is (N, K, F), the optional bias (N, F); inputs are
// float32 or bfloat16 and the output is float32 (N, M, F).
//
// What bounds it on this card: at the serving shape that matters (the
// stablelm-1.6b head: M = 1024 trunk rows, K = 2048, F = 100352, N = 3) the
// work is 1.26 TFLOP against 2.5 GB of traffic, about 500 operations per
// byte, so it is bound by operations: 1.28 ms at the bf16 tensor-core peak.
// This first version is a plain CUDA-core kernel that is right first: the
// TPU grid's sequential k axis becomes a loop inside the block, and the
// f32 accumulator lives in registers instead of VMEM scratch.
//   * grid (F tiles, M tiles, bank member): every block owns one 64 x 64
//     output tile of one member and walks K in 16-deep slices;
//   * each slice of x and w is staged in shared memory as float32 (bf16
//     products are exact in f32, so this is f32 accumulation), every one of
//     the 256 threads keeps a 4 x 4 register tile of sums;
//   * ragged M, K and F are masked on load (zeros) and on store, so shapes
//     such as small_cnn's F = 4 classes need no padding by the caller;
//   * the bias is added once, in the epilogue.
// It runs on CUDA cores, far below the tensor-core bound; wgmma, TMA and a
// multi-stage pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
bank_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, float* __restrict__ out,
                   int M, int K, int F, long long x_bank_stride) {
  __shared__ float xs[BK][BM + 1];  // +1: the transposing store is conflict-free
  __shared__ float ws[BK][BN];

  const int n = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  const T* xn = x + (long long)n * x_bank_stride;
  const T* wn = w + (long long)n * K * F;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns f0 + tx + 16 * j
  const int ty = tid / 16;  // output rows    m0 + ty + 16 * i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice: BM rows x BK columns, consecutive threads walk k
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK, col = e % BK;
      const int gm = m0 + row, gk = k0 + col;
      xs[col][row] = (gm < M && gk < K) ? to_f32(xn[(long long)gm * K + gk]) : 0.f;
    }
    // w slice: BK rows x BN columns, consecutive threads walk f
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BN, col = e % BN;
      const int gk = k0 + row, gf = f0 + col;
      ws[row][col] = (gk < K && gf < F) ? to_f32(wn[(long long)gk * F + gf]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gf = f0 + tx + 16 * j;
      if (gf >= F) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[(long long)n * F + gf]);
      out[((long long)n * M + gm) * F + gf] = v;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int N, int M, int K, int F, int broadcast, cudaStream_t stream) {
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM, N);
  const long long stride = broadcast ? 0LL : (long long)M * K;
  bank_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<float*>(out), M, K, F, stride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b may be null.  Returns cudaError_t.
extern "C" int bank_matmul_launch(const void* x, const void* w, const void* b,
                                  void* out, int N, int M, int K, int F,
                                  int broadcast, int dtype, void* stream) {
  if (N <= 0 || M <= 0 || K <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535 || N > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, b, out, N, M, K, F, broadcast, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, out, N, M, K, F, broadcast, s);
  return (int)cudaErrorInvalidValue;
}
