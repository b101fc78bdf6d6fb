// Blocked flash attention (causal / sliding-window, GQA) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`).  q is
// (B, S, Hq, D), k and v are (B, S, Hkv, D); the output has q's dtype and
// shape.  Online softmax with float32 running max m, sum l and accumulator;
// a query row that sees no key (l == 0) writes zeros; the scale defaults to
// 1/sqrt(D) in the wrapper.
//
// What bounds it on this card: at the stablelm-1.6b serving shape
// (B = 8, S = 128, 32 heads of 64, causal) the kernel reads q, k, v and
// writes o once -- 16.8 MB, 5.0 us at 3.35 TB/s -- while the causal work is
// about 0.54 GFLOP, 0.55 us at the bf16 tensor-core peak: it is bound by
// bytes.  The design keeps every intermediate on chip and touches each
// input element once per query tile:
//   * grid (64-row query tile, q head, batch): the TPU's sequential kv grid
//     axis becomes a loop inside the block, m / l / acc live in registers;
//   * each 64-key tile of K and V is staged in shared memory (float32,
//     rows padded by one word so the row-parallel reads are conflict-free);
//   * the kv loop starts at the window edge and stops at the causal
//     diagonal, so fully masked tiles are neither loaded nor computed;
//   * GQA reads kv head h / (Hq / Hkv); ragged S is masked;
//   * 4 threads share a query row: each scores 16 of the 64 keys and owns
//     D / 4 output columns; the row max and sum are combined by shuffles.
// The products run on CUDA cores; at this shape that is not the limit.
// Head dims 64, 128 and 256 are compiled.  At D = 256 (recurrentgemma-9b,
// 16 query heads on one kv head) the float32 tiles take 209 KB of dynamic
// shared memory -- above the 48 KB default, so the launch raises the
// kernel's limit with cudaFuncSetAttribute -- and one block fits an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;  // 4 threads per query row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
         (size_t)BQ * (BKV + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
             int Hkv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [BQ][D + 1]
  float* ks = qs + BQ * (D + 1);         // [BKV][D + 1]
  float* vs = ks + BKV * (D + 1);        // [BKV][D]
  float* ps = vs + BKV * D;              // [BQ][BKV + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row within the tile
  const int l4 = tid & 3;   // lane within the row's 4 threads
  const int qp = q0 + r;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int row = e / D, d = e % D, s = q0 + row;
    qs[row * (D + 1) + d] =
        s < S ? to_f32(q[(((long long)b * S + s) * Hq + h) * D + d]) : 0.f;
  }

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);                 // stop at the diagonal
  if (window > 0) k_lo = max(0, q0 - window + 1);     // start at the window edge

  float m_i = -INFINITY, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and q is staged)
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int row = e / D, d = e % D, s = k0 + row;
      const long long g = (((long long)b * S + s) * Hkv + hk) * D + d;
      const bool in = s < S;
      ks[row * (D + 1) + d] = in ? to_f32(k[g]) : 0.f;
      vs[row * D + d] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[BKV / 4];
    float mloc = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int c = l4 + 4 * j;
      const int kp = k0 + c;
      const bool ok = kp < S && (!causal || kp <= qp) &&
                      (window <= 0 || qp - kp < window);
      float s = -INFINITY;
      if (ok) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * (D + 1) + d], ks[c * (D + 1) + d], dot);
        s = dot * scale;
      }
      sc[j] = s;
      mloc = fmaxf(mloc, s);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_i, mloc);
    float alpha = 1.f, lsum = 0.f;
    if (m_new != -INFINITY) {  // else: no key seen yet, p = 0 and acc stays 0
      alpha = expf(m_i - m_new);
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j) {
        const float p = expf(sc[j] - m_new);  // exp(-inf) = 0 for masked keys
        ps[r * (BKV + 1) + l4 + 4 * j] = p;
        lsum += p;
      }
    } else {
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j) ps[r * (BKV + 1) + l4 + 4 * j] = 0.f;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l_i = l_i * alpha + lsum;
    m_i = m_new;
    __syncthreads();  // the row's probabilities are all in shared memory

#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < BKV; ++c) {
      const float p = ps[r * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = fmaf(p, vs[c * D + l4 + 4 * j], acc[j]);
    }
  }

  if (qp < S) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;  // l == 0: write zeros
    T* orow = o + (((long long)b * S + qp) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[l4 + 4 * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Hq, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Hq, int Hkv, int D, int causal,
                     int window, float scale, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, stream);
  if (D == 128) return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, stream);
  if (D == 256) return launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int Hq, int Hkv,
                                      int D, int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (Hq > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, o, B, S, Hq, Hkv, D, causal, window, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
