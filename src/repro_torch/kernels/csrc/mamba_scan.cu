// Mamba selective scan for Hopper.
//
// Replaces the Pallas TPU kernel `mamba_scan` in
// src/repro/kernels/mamba_scan.py (body `_mamba_kernel`).  Per batch row b
// and channel c, with an n-wide state h (n = N, a template parameter):
//
//     h_t = exp(dt_t * A[c]) * h_{t-1} + dtx_t * B_t        h, A[c]: (n,)
//     y_t = sum_j h_t[j] * C_t[j]
//
// dt, dtx are (B, S, di), Bmat, Cmat (B, S, n) of one dtype (float32 or
// bfloat16); A is (di, n) and h0 (B, di, n), both float32.  y (B, S, di)
// and h_last (B, di, n) are float32.  All arithmetic is float32; `expf`,
// not `__expf`.  Any S >= 1 is taken (no chunk padding), so one decode
// token with a carried h0 is the same kernel at S = 1.
//
// What bounds it on this card: at the falcon-mamba-7b serving shape
// (B = 8, S = 128, di = 8192, n = 16, f32) it must read dt and dtx
// (67 MB) and h0 (4.2 MB) and write y (34 MB) and h_last (4.2 MB):
// 110 MB, 33 us at 3.35 TB/s.  The (B, S, di, n) decay and input tensors
// are never formed -- they would be 16x that.  The work is 134 M
// exponentials plus ~6 float32 operations each, about 10 us at the
// float32 peak, so the bytes bound it; the exponentials on the special
// function units come close.  The design:
//   * one thread per (batch row, channel): the time recurrence is a loop
//     inside the thread, its n states and its row of A live in registers
//     (the TPU's sequential chunk grid axis becomes that loop);
//   * B_t and C_t are the same for every channel of a batch row, so a
//     block of channels stages a tile of TILE steps of them in shared
//     memory, read as broadcasts;
//   * dt and dtx loads are coalesced across the block's channels, and the
//     UNROLL steps of a group are loaded before any of them is computed,
//     so the loads of a thread are in flight together instead of one
//     dependent load per step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int TILE = 32;      // time steps of B and C staged per round
constexpr int UNROLL = 4;     // time steps whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ dtx,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_last, int S, int di) {
  __shared__ float bs[TILE][N];
  __shared__ float cs[TILE][N];
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool live = c < di;

  float a[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = live ? A[(long long)c * N + j] : 0.f;
    h[j] = live ? h0[((long long)b * di + c) * N + j] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int steps = min(TILE, S - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
      const int tt = e / N, j = e % N;
      const long long g = ((long long)b * S + t0 + tt) * N + j;
      bs[tt][j] = tt < steps ? to_f32(Bm[g]) : 0.f;
      cs[tt][j] = tt < steps ? to_f32(Cm[g]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int u0 = 0; u0 < steps; u0 += UNROLL) {
      float d[UNROLL], dx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = ((long long)b * S + t0 + u0 + u) * di + c;
        const bool in = u0 + u < steps;
        d[u] = in ? to_f32(dt[g]) : 0.f;
        dx[u] = in ? to_f32(dtx[g]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int tt = u0 + u;
        if (tt < steps) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            h[j] = expf(d[u] * a[j]) * h[j] + dx[u] * bs[tt][j];
            acc += h[j] * cs[tt][j];
          }
          y[((long long)b * S + t0 + tt) * di + c] = acc;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < N; ++j) h_last[((long long)b * di + c) * N + j] = h[j];
  }
}

template <typename T, int N>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const float* A, const float* h0, float* y, float* h_last, int B,
                   int S, int di, cudaStream_t stream) {
  dim3 grid((di + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(dtx), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, y, h_last, S, di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                     const float* A, const float* h0, float* y, float* h_last, int B,
                     int S, int di, int n, cudaStream_t stream) {
  if (n == 8) return launch<T, 8>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, stream);
  if (n == 16) return launch<T, 16>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of dt, dtx, Bmat, Cmat: 0 = float32, 1 = bfloat16.  Returns cudaError_t.
extern "C" int mamba_scan_launch(const void* dt, const void* dtx, const void* Bm,
                                 const void* Cm, const void* A, const void* h0, void* y,
                                 void* h_last, int B, int S, int di, int n, int dtype,
                                 void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* h = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_last);
  if (dtype == 0)
    return (int)launch_n<float>(dt, dtx, Bm, Cm, a, h, yo, ho, B, S, di, n, s);
  if (dtype == 1)
    return (int)launch_n<__nv_bfloat16>(dt, dtx, Bm, Cm, a, h, yo, ho, B, S, di, n, s);
  return (int)cudaErrorInvalidValue;
}
