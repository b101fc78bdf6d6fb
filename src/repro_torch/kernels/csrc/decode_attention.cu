// One-query grouped-query attention against a KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`).  q is
// (B, Hq, D), the caches k and v are (B, Smax, Hkv, D), lengths (B,) int32
// gives each row's valid prefix; the output (B, Hq, D) has q's dtype.
// Float32 online softmax; a row of length 0 writes exact zeros (the
// kernel's l == 0 guard); the scale defaults to 1/sqrt(D) in the wrapper.
//
// What bounds it on this card: every valid cache byte is read once and the
// arithmetic is 4 * D operations per (query head, key) -- one operation per
// byte read in bf16, far below the ~295 where the tensor cores would be the
// limit.  It is bound by bytes: q + out + sum_b lengths[b] * Hkv * D * 2
// elements.  At the stablelm-1.6b decode shape (B = 8, 32 heads of 64,
// Smax = 128) that is at most 4.2 MB, 1.3 us at 3.35 TB/s.  The design reads
// only the valid prefix and keeps everything else on chip:
//   * grid (kv head, batch row): a block owns the G = Hq / Hkv query heads
//     of one kv head, so each k/v row is read once for all of them;
//   * the TPU's sequential kv grid axis becomes a loop inside the block over
//     64-key tiles; the loop stops at lengths[b], so a tile past the length
//     is never loaded; m / l live in shared memory, the accumulator in
//     registers (each thread owns fixed (head, column) outputs);
//   * a tile of k and v is staged in shared memory as float32 with 16-byte
//     loads (rows of k padded by one word, so the key-parallel dot products
//     read distinct banks); Smax need not be a multiple of the tile;
//   * one warp per query head takes the tile's max and sum by shuffles;
//   * every sum runs in a fixed order, so one shape gives the same bits on
//     every launch.
// Head dims 64 and 128 are compiled; G may be 1 to 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;     // keys per tile: two per lane in the softmax pass
constexpr int GMAX = 16;   // query heads per kv head

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  return (size_t)G * D + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)G * BK +
         3 * (size_t)G;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int Smax, int Hq, int Hkv, float scale) {
  static_assert(BK == 64, "the softmax pass takes two keys per lane");
  constexpr int V = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int PER = GMAX * D / THREADS;  // outputs a thread may own
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                  // [G][D]
  float* ks = qs + G * D;            // [BK][D + 1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [G][BK] scores, then probabilities
  float* m_s = ps + G * BK;          // [G] running max
  float* l_s = m_s + G;              // [G] running sum
  float* a_s = l_s + G;              // [G] this tile's rescale factor

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int L = min(max(lengths[b], 0), Smax);
  const long long base = ((long long)b * Hq + (long long)hk * G) * D;

  for (int e = tid * V; e < G * D; e += THREADS * V) {
    float t[V];
    load16(q + base + e, t);
#pragma unroll
    for (int i = 0; i < V; ++i) qs[e + i] = t[i];
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (q, m, l staged)
    const int rows = min(BK, L - k0);
    for (int e = tid * V; e < BK * D; e += THREADS * V) {
      const int r = e / D, d = e % D;
      float tk[V], tv[V];
      if (r < rows) {
        const long long g = (((long long)b * Smax + k0 + r) * Hkv + hk) * D + d;
        load16(k + g, tk);
        load16(v + g, tv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) tk[i] = tv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ks[r * (D + 1) + d + i] = tk[i];
        vs[r * D + d + i] = tv[i];
      }
    }
    __syncthreads();

    for (int e = tid; e < G * BK; e += THREADS) {
      const int g = e / BK, c = e % BK;
      float s = -INFINITY;
      if (c < rows) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], ks[c * (D + 1) + d], dot);
        s = dot * scale;
      }
      ps[g * BK + c] = s;
    }
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31;
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = ps[g * BK + lane], s1 = ps[g * BK + lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);  // finite: key k0 is valid
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);  // masked -> 0
      ps[g * BK + lane] = p0;
      ps[g * BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = tid + j * THREADS;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[j] * a_s[g];
        for (int c = 0; c < rows; ++c) a = fmaf(ps[g * BK + c], vs[c * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // l is visible to every thread, also when L == 0

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * THREADS;
    if (e < G * D) {
      const float l = l_s[e / D];
      o[base + e] = from_f32<T>(l > 0.f ? acc[j] / l : 0.f);  // l == 0: zeros
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* o, int B, int Smax, int Hq, int Hkv, float scale,
                   cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation: the largest G's size
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(GMAX, D) * sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t bytes = smem_floats(Hq / Hkv, D) * sizeof(float);
  dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), Smax, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* lengths,
                     void* o, int B, int Smax, int Hq, int Hkv, int D, float scale,
                     cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(q, k, v, lengths, o, B, Smax, Hq, Hkv, scale, stream);
  if (D == 128) return launch<T, 128>(q, k, v, lengths, o, B, Smax, Hq, Hkv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, D), k and v (B, Smax, Hkv, D), lengths (B,) int32, o (B, Hq, D),
// all contiguous and 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* o, int B, int Smax,
                                       int Hq, int Hkv, int D, float scale, int dtype,
                                       void* stream) {
  if (B < 0 || Smax < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (Hq / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, len, o, B, Smax, Hq, Hkv, D, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, len, o, B, Smax, Hq, Hkv, D, scale, s);
  return (int)cudaErrorInvalidValue;
}
