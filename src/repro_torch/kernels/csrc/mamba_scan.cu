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
// and h_last (B, di, n) are float32.  Any S >= 1 is taken (no chunk
// padding), so one decode token with a carried h0 is the same kernel at
// S = 1.
//
// Arithmetic, the same in both routes and in every launch: per state
// h = fma(expf(dt * A), h, dtx * B), and y_t = fma(h_j, C_j, y) over j in
// state order from 0.  One order for every S makes a scan of S steps and
// S chained S = 1 launches that carry h_last bitwise equal.  The rounding
// is kept as it is on purpose: a faster exponential (ex2.approx) or another
// order for y moves falcon-mamba-7b's streamed-vs-replayed decode logits,
// through 64 bf16 layers, past their check (`chip_scan_numerics.py`).
//
// What bounds it on this card: at the falcon-mamba-7b serving shape
// (B = 8, S = 128, di = 8192, n = 16, f32) it must move dt, dtx, y (101 MB)
// and h0, h_last (8.4 MB): 33 us at 3.35 TB/s, and evaluate B*S*di*n = 134 M
// exponentials, 32 us on the special-function units at 16 a clock per SM.
// expf's range reduction adds ~7 float32 instructions to each, so the issue
// of ~12 instructions per (step, state) sets the pace.  At the decode step
// (S = 1) it moves h0 and h_last (8.4 MB) and A: ~3 us.  Two routes, picked
// by the wrapper from S alone:
//   * "step" (S = 1): a channel's 16 states are spread over 4 lanes (8
//     states: 2), 4 states a lane: A and h0 are read and h_last written as
//     float4, neighbouring lanes on neighbouring addresses, so a warp
//     touches 512 contiguous bytes where one thread per channel touched 32
//     separate sectors, with 4x the threads in flight; B_t and C_t are read
//     as 16-byte broadcasts; no shared memory and no barrier.  y_t runs
//     through the channel's lanes in state order (lane sl continues lane
//     sl - 1's sum, passed by a shuffle);
//   * "scan" (S > 1): one lane per channel, its n states and A's row in
//     registers, the time recurrence a loop inside the thread (the TPU's
//     sequential chunk axis becomes that loop); B and C come through
//     shared memory in tiles of TS steps, widened to float32 once when
//     stored, the next tile's loads in flight in registers while this one
//     is used; the dt and dtx of the next U steps are loaded while this
//     group of U steps is computed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 8;    // steps of dt and dtx loaded ahead, as one group
constexpr int TS = 32;  // steps of B and C per shared-memory tile ("scan")

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// 4 consecutive entries of a read-only float32 or bfloat16 row, widened
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 16 bytes of T widened into 16 / sizeof(T) floats of shared memory
__device__ __forceinline__ void put16(float* dst, uint4 u, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                  __uint_as_float(u.w));
}
__device__ __forceinline__ void put16(float* dst, uint4 u, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int N, int LPC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ dtx,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_last, int S, int di) {
  constexpr int SPL = N / LPC;          // states a lane holds
  constexpr int CPB = THREADS / LPC;    // channels per block
  constexpr int PER = U / LPC;          // steps of dt and dtx a lane loads per group
  constexpr int EPP = 16 / sizeof(T);   // elements per 16-byte piece of B or C
  constexpr int PIECES = TS * N / EPP;  // pieces of one tile of B (and of C)
  constexpr int PPT = (2 * PIECES + THREADS - 1) / THREADS;  // pieces a thread stages
  static_assert(SPL % 4 == 0 && U % LPC == 0 && TS % U == 0, "tile shapes");
  __shared__ __align__(16) float sB[STAGED ? 2 : 1][STAGED ? TS * N : 4];
  __shared__ __align__(16) float sC[STAGED ? 2 : 1][STAGED ? TS * N : 4];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int sl = lane % LPC;            // which SPL states of the channel
  const int base = lane - sl;           // the channel's first lane
  const int c = blockIdx.x * CPB + threadIdx.x / LPC;
  const bool live = c < di;
  const int cc = live ? c : 0;          // dead lanes read channel 0 and store nothing

  float a[SPL], h[SPL];
#pragma unroll
  for (int q = 0; q < SPL; q += 4) {
    const float4 av = load4(A + (long long)cc * N + SPL * sl + q);
    const float4 hv = load4(h0 + ((long long)b * di + cc) * N + SPL * sl + q);
    a[q] = av.x; a[q + 1] = av.y; a[q + 2] = av.z; a[q + 3] = av.w;
    h[q] = hv.x; h[q + 1] = hv.y; h[q + 2] = hv.z; h[q + 3] = hv.w;
  }

  const long long row = (long long)b * S;     // (b, t = 0)
  const T* dtp = dt + row * di + cc;
  const T* dxp = dtx + row * di + cc;
  const T* bg = Bm + row * N;
  const T* cg = Cm + row * N;
  float* yp = y + row * di + c;

  // "scan": the B and C pieces of the tile at t0, in registers until stored
  uint4 st[PPT];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = threadIdx.x + k * THREADS, pp = p % PIECES;
      const bool ok = p < 2 * PIECES && t0 + pp * EPP / N < S;
      st[k] = ok ? __ldg(reinterpret_cast<const uint4*>(
                       (p < PIECES ? bg : cg) + (long long)t0 * N + pp * EPP))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = threadIdx.x + k * THREADS, pp = p % PIECES;
      if (p < 2 * PIECES) put16((p < PIECES ? sB[buf] : sC[buf]) + pp * EPP, st[k], T());
    }
  };

  // lane sl of a channel loads steps t0 + sl + LPC i of a group, so the
  // channel's lanes have U distinct steps in flight; shuffles share them.
  // They stay in T until used: a widening right after each load would
  // wait for it before the next load is issued
  T d[PER], dx[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = sl + LPC * i;
    d[i] = t < S ? dtp[(long long)t * di] : zero<T>();
    dx[i] = t < S ? dxp[(long long)t * di] : zero<T>();
  }
  if (STAGED) {
    fetch(0);
    store(0);
    __syncthreads();
  }
  for (int t0 = 0, buf = 0; t0 < S; t0 += TS, buf ^= 1) {
    const bool more = STAGED && t0 + TS < S;
    if (more) fetch(t0 + TS);  // in flight while this tile is used
    for (int g0 = t0; g0 < min(t0 + TS, S); g0 += U) {
      T dn[PER], dxn[PER];  // the next group's, in flight while this one runs
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = g0 + U + sl + LPC * i;
        dn[i] = t < S ? dtp[(long long)t * di] : zero<T>();
        dxn[i] = t < S ? dxp[(long long)t * di] : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = g0 + u;  // the owner lane and register of dt are compile-time
        const float dd = LPC == 1 ? to_f32(d[u])
                                  : __shfl_sync(0xffffffffu, to_f32(d[u / LPC]), base + u % LPC);
        const float ddx = LPC == 1 ? to_f32(dx[u])
                                   : __shfl_sync(0xffffffffu, to_f32(dx[u / LPC]),
                                                 base + u % LPC);
        if (t >= S) break;  // uniform across the block
        float bj[SPL], cj[SPL];
#pragma unroll
        for (int q = 0; q < SPL; q += 4) {
          const float4 bv =
              STAGED ? *reinterpret_cast<const float4*>(sB[buf] + (t - t0) * N + SPL * sl + q)
                     : load4(bg + (long long)t * N + SPL * sl + q);
          const float4 cv =
              STAGED ? *reinterpret_cast<const float4*>(sC[buf] + (t - t0) * N + SPL * sl + q)
                     : load4(cg + (long long)t * N + SPL * sl + q);
          bj[q] = bv.x; bj[q + 1] = bv.y; bj[q + 2] = bv.z; bj[q + 3] = bv.w;
          cj[q] = cv.x; cj[q + 1] = cv.y; cj[q + 2] = cv.z; cj[q + 3] = cv.w;
        }
#pragma unroll
        for (int j = 0; j < SPL; ++j)  // the state update
          h[j] = __fmaf_rn(expf(__fmul_rn(dd, a[j])), h[j], __fmul_rn(ddx, bj[j]));
        // y_t in state order: lane sl continues lane sl - 1's sum
        float yt = 0.f;
#pragma unroll
        for (int r = 0; r < LPC; ++r) {
          const float prev = r == 0 ? 0.f : __shfl_up_sync(0xffffffffu, yt, 1);
          if (sl == r) {
            float acc = prev;
#pragma unroll
            for (int j = 0; j < SPL; ++j) acc = __fmaf_rn(h[j], cj[j], acc);
            yt = acc;
          }
        }
        if (live && sl == LPC - 1) yp[(long long)t * di] = yt;
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        d[i] = dn[i];
        dx[i] = dxn[i];
      }
    }
    if (more) store(buf ^ 1);  // its last readers finished before the last barrier
    if (STAGED) __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < SPL; q += 4)
      *reinterpret_cast<float4*>(h_last + ((long long)b * di + c) * N + SPL * sl + q) =
          make_float4(h[q], h[q + 1], h[q + 2], h[q + 3]);
  }
}

template <typename T, int N, int LPC, bool STAGED>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const float* A, const float* h0, float* y, float* h_last, int B,
                   int S, int di, cudaStream_t stream) {
  constexpr int CPB = THREADS / LPC;
  dim3 grid((di + CPB - 1) / CPB, B);
  mamba_scan_kernel<T, N, LPC, STAGED><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(dtx), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, h0, y, h_last, S, di);
  return cudaGetLastError();
}

// route 0 = "step" (N / 4 lanes a channel), 1 = "scan" (one lane a channel)
template <typename T, int N>
cudaError_t launch_route(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                         const float* A, const float* h0, float* y, float* h_last, int B,
                         int S, int di, int route, cudaStream_t stream) {
  if (route == 0)
    return launch<T, N, N / 4, false>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, stream);
  if (route == 1)
    return launch<T, N, 1, true>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_n(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                     const float* A, const float* h0, float* y, float* h_last, int B,
                     int S, int di, int n, int route, cudaStream_t stream) {
  if (n == 8)
    return launch_route<T, 8>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, route, stream);
  if (n == 16)
    return launch_route<T, 16>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, route, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of dt, dtx, Bmat, Cmat: 0 = float32, 1 = bfloat16.  A, h0, h_last
// and Bmat, Cmat 16-byte aligned (vector accesses).  route: 0 = "step",
// 1 = "scan" (any S works on either; the results are bitwise the same).
// Returns cudaError_t.
extern "C" int mamba_scan_launch(const void* dt, const void* dtx, const void* Bm,
                                 const void* Cm, const void* A, const void* h0, void* y,
                                 void* h_last, int B, int S, int di, int n, int dtype,
                                 int route, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* h = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_last);
  if (dtype == 0)
    return (int)launch_n<float>(dt, dtx, Bm, Cm, a, h, yo, ho, B, S, di, n, route, s);
  if (dtype == 1)
    return (int)launch_n<__nv_bfloat16>(dt, dtx, Bm, Cm, a, h, yo, ho, B, S, di, n, route,
                                        s);
  return (int)cudaErrorInvalidValue;
}
