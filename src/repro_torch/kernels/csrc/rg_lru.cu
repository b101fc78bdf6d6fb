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
// Arithmetic, the same in every route and every launch: a_t and b_t are
// widened to float32, then h = __fmaf_rn(a_t, h, b_t) in time order from h0,
// one rounding a step (one FFMA: an unfused a * h + b would round twice).
// No route reorders the recurrence (a parallel prefix scan would round
// differently), so every route gives the same bits at every shape, and a
// scan of S steps equals S chained S = 1 launches carrying h_last.
//
// What bounds it on this card: one multiply-add per element against 12
// bytes (f32: a, b read, y written), so bytes.  At the recurrentgemma-9b
// serve shape (B = 8, S = 128, d = 4096, f32) that is 50 MB, 15.1 us at
// 3.35 TB/s; at its decode step (S = 1) 655 KB, 0.2 us, under the ~1.1 us a
// launch costs.  Three routes, picked by the wrapper from shape and
// alignment alone (kernels/rg_lru.py: route):
//
// "scan" -- S > 1, rows of 16 bytes (d * element size % 16 == 0) and 16-byte
// aligned pointers.  Reaching the memory rate takes several MB in flight; a
// thread-per-channel loop holds only what its registers prefetch (~2 MB at
// the serve shape, 67% of the rate).  So the loads are handed to the TMA:
//   * a block is one warp owning CT = 32 channels of one batch row (grid
//     (d / CT, B): 1024 blocks at the serve shape, all resident at once);
//   * 3-D tensor maps over (d, S, B) cut a and b into boxes of TS steps x CT
//     channels x 1 row (a box never crosses batch rows); lane 0 keeps a ring
//     of STAGES boxes of each in shared memory, each stage completed on an
//     mbarrier by the TMA's byte count, so the bytes in flight (up to 16 KB a
//     block, ~16 MB on the card) cost no registers;
//   * each lane keeps its channel's h in a register and walks a stage's rows
//     in time order, lane c reading column c (conflict-free), storing y as
//     one coalesced 128-byte row a step; after the warp is done with a stage,
//     lane 0 refills it with the boxes STAGES tiles ahead;
//   * the TMA zero-fills boxes past S and past d; a = 0 would zero h, so the
//     loop stops at S and never applies a filled step, and lanes past d
//     compute nothing (they still wait on every stage).
//
// "step" -- S = 1 (a decode step, replayed in CUDA graphs), same alignment.
// Elementwise over B * d: each thread loads 4 channels of a, b (16 bytes
// f32, 8 bytes bf16) and h0 with all three loads issued before any use, no
// loop and no shared memory, and stores y and h_last as 16 bytes each.
//
// "plain" -- every other shape (rows not a multiple of 16 bytes, or a view
// starting mid-row): one thread per (row, channel), the loads of UNROLL
// steps issued before any of them is used, scalar accesses.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// route "plain"
// ---------------------------------------------------------------------------

namespace plain {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rg_lru_plain_kernel(const T* __restrict__ a, const T* __restrict__ bv,
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
        h = __fmaf_rn(av[u], h, bb[u]);
        y[((long long)b * S + t0 + u) * d + c] = h;
      }
    }
  }
  h_last[(long long)b * d + c] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* y, float* h_last,
                   int B, int S, int d, cudaStream_t stream) {
  dim3 grid((d + THREADS - 1) / THREADS, B);
  rg_lru_plain_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, y, h_last, S, d);
  return cudaGetLastError();
}

}  // namespace plain

// ---------------------------------------------------------------------------
// route "step"
// ---------------------------------------------------------------------------

namespace step {

constexpr int THREADS = 64;  // 128 blocks at the decode shape: one an SM

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// a, b, h0, y, h_last are all (B * d) elements here (S = 1), n4 = B * d / 4.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rg_lru_step_kernel(const T* __restrict__ a, const T* __restrict__ bv,
                   const float* __restrict__ h0, float* __restrict__ y,
                   float* __restrict__ h_last, long long n4) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  float av[4], bb[4], h[4];
  load4(a + 4 * i, av);
  load4(bv + 4 * i, bb);
  load4(h0 + 4 * i, h);
#pragma unroll
  for (int u = 0; u < 4; ++u) h[u] = __fmaf_rn(av[u], h[u], bb[u]);
  const float4 out = make_float4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<float4*>(y)[i] = out;
  reinterpret_cast<float4*>(h_last)[i] = out;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* y, float* h_last,
                   int B, int d, cudaStream_t stream) {
  const long long n4 = (long long)B * d / 4;
  const long long blocks = (n4 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rg_lru_step_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, y, h_last, n4);
  return cudaGetLastError();
}

}  // namespace step

// ---------------------------------------------------------------------------
// route "scan"
// ---------------------------------------------------------------------------

namespace scan {

constexpr int CT = 32;      // channels of a block: one lane each
constexpr int STAGES = 4;   // boxes of a and b in flight a block
template <typename T> struct Tile;  // TS: time steps of a box (2 KB of a, 2 KB of b)
template <> struct Tile<float> { static constexpr int TS = 16; };
template <> struct Tile<__nv_bfloat16> { static constexpr int TS = 32; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(32)
rg_lru_scan_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const float* __restrict__ h0, float* __restrict__ y,
                   float* __restrict__ h_last, int S, int d) {
  constexpr int TS = Tile<T>::TS;
  constexpr int BOX = TS * CT;  // elements of one box
  __shared__ __align__(128) T ring[STAGES][2][BOX];
  __shared__ __align__(8) uint64_t full[STAGES];

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CT;
  const int b = blockIdx.y;
  const int c = c0 + lane;
  const bool live = c < d;
  const int tiles = (S + TS - 1) / TS;

  auto issue = [&](int k) {  // lane 0: the boxes of tile k into stage k % STAGES
    const int s = k % STAGES;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, 2 * BOX * sizeof(T));
    tma_load_3d(smem_u32(ring[s][0]), &a_map, bar, c0, k * TS, b);
    tma_load_3d(smem_u32(ring[s][1]), &b_map, bar, c0, k * TS, b);
  };

  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&a_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&b_map))
                 : "memory");
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < STAGES && k < tiles; ++k) issue(k);
  }
  __syncwarp();

  float h = live ? h0[(long long)b * d + c] : 0.f;
  float* yc = y + (long long)b * S * d + c;
  for (int k = 0; k < tiles; ++k) {
    const int s = k % STAGES;
    mbar_wait(smem_u32(&full[s]), (k / STAGES) & 1);
    const T* as = ring[s][0] + lane;
    const T* bs = ring[s][1] + lane;
    float* yk = yc + (long long)k * TS * d;
    if (live) {
      if ((k + 1) * TS <= S) {
#pragma unroll
        for (int t = 0; t < TS; ++t) {
          h = __fmaf_rn(to_f32(as[t * CT]), h, to_f32(bs[t * CT]));
          yk[(long long)t * d] = h;
        }
      } else {  // the last tile: steps past S are the TMA's zero fill
        for (int t = 0; t < S - k * TS; ++t) {
          h = __fmaf_rn(to_f32(as[t * CT]), h, to_f32(bs[t * CT]));
          yk[(long long)t * d] = h;
        }
      }
    }
    __syncwarp();  // every lane has read stage s
    if (lane == 0 && k + STAGES < tiles) {
      // order the lanes' shared-memory reads before the TMA's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + STAGES);
    }
  }
  if (live) h_last[(long long)b * d + c] = h;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: looked up through the runtime,
// so the library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, d) tensor read in (1, TS, CT) boxes, no swizzle (a box lands as
// TS rows of CT elements); out-of-range elements of a box are zero-filled.
template <typename T>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T), (cuuint64_t)S * d * sizeof(T)};
  const cuuint32_t box[3] = {CT, Tile<T>::TS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* y, float* h_last,
                   int B, int S, int d, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap a_map, b_map;
  if (!encode<T>(fn, &a_map, a, B, S, d) || !encode<T>(fn, &b_map, b, B, S, d))
    return cudaErrorInvalidValue;
  dim3 grid((d + CT - 1) / CT, B);
  rg_lru_scan_kernel<T><<<grid, 32, 0, stream>>>(a_map, b_map, h0, y, h_last, S, d);
  return cudaGetLastError();
}

}  // namespace scan

// route 0 = "scan", 1 = "step", 2 = "plain" (kernels/rg_lru.py: ROUTES)
template <typename T>
cudaError_t launch_route(const void* a, const void* b, const float* h0, float* y,
                         float* h_last, int B, int S, int d, int route, cudaStream_t stream) {
  if (route == 2) return plain::launch<T>(a, b, h0, y, h_last, B, S, d, stream);
  // the TMA and the vector accesses need 16-byte rows and 16-byte aligned data
  if ((d * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(h_last)) & 15)
    return cudaErrorMisalignedAddress;
  if (route == 0) return scan::launch<T>(a, b, h0, y, h_last, B, S, d, stream);
  if (route == 1 && S == 1) return step::launch<T>(a, b, h0, y, h_last, B, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of a and b: 0 = float32, 1 = bfloat16; route as launch_route's.
// Returns cudaError_t.
extern "C" int rg_lru_launch(const void* a, const void* b, const void* h0, void* y,
                             void* h_last, int B, int S, int d, int dtype, int route,
                             void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_last);
  if (dtype == 0) return (int)launch_route<float>(a, b, h, yo, ho, B, S, d, route, s);
  if (dtype == 1) return (int)launch_route<__nv_bfloat16>(a, b, h, yo, ho, B, S, d, route, s);
  return (int)cudaErrorInvalidValue;
}
