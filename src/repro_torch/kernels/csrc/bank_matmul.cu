// Suffix-bank grouped GEMM for Hopper: out[n] = x[n] @ w[n] (+ b[n]).
//
// Replaces the Pallas TPU kernel `bank_matmul` in
// src/repro/kernels/bank_matmul.py (bodies `_bank_kernel` and
// `_bank_bias_kernel`).  x is banked (N, M, K) or broadcast (M, K), w is
// (N, K, F), the optional bias (N, F); inputs are float32 or bfloat16 and the
// output is float32 (N, M, F).  Two routes, chosen by the wrapper from dtype
// and shape alone (kernels/bank_matmul.py: route):
//
// "wgmma" -- bf16 with K % 8 == 0 and F % 8 == 0 (every LM head of the repo:
// vocabularies are padded to a multiple of 256).
//   What bounds it on this card: at the stablelm-1.6b serving head (M = 1024
//   rows, K = 2048, F = 100352, N = 3) the work is 1.26 TFLOP against 2.5 GB
//   of traffic, ~500 operations per byte, so it is bound by operations: 1.28
//   ms at the bf16 tensor-core peak.  At the decode heads (M = 8) it is bound
//   by bytes: w (1.2-1.6 GB) streamed once at 3.35 TB/s.
//   Design: a persistent warp-specialised kernel, one block of 384 threads
//   per SM walking 128 x 256 output tiles (m fastest, so blocks running
//   together share one column tile of w and x stays in L2):
//   * warpgroup 2 is the producer: one thread starts TMA loads of a 128 x 64
//     tile of x and four 64 x 64 boxes of w per stage into a ring of 4
//     stages (48 KB each, 128-byte swizzle), each stage signalled by a "full"
//     mbarrier and released by an "empty" one; it drops to 40 registers;
//   * warpgroups 0 and 1 are consumers of 64 rows each (up to 232
//     registers): four wgmma.mma_async m64n256k16 bf16 -> f32 per stage,
//     x read K-major and w read MN-major (the transpose bit of 16-bit
//     wgmma), one group left in flight while the next stage is waited on;
//   * the f32 accumulator (128 registers a thread) stays in registers; each
//     warp stages its 16 rows through shared memory 32 columns at a time and
//     stores them as coalesced 128-byte rows, adding the bias once, masking
//     M and F; the producer already loads the next tile meanwhile;
//   * the TMA maps are 3-D (inner dim, rows, member), so the ragged edges of
//     M and K are zero-filled per member, never read from the next one;
//   * bf16 products are exact in f32, so this is the reference's arithmetic
//     in another summation order; that order (64-deep stages of four 16-deep
//     steps, k ascending) depends on K alone: no split-K and one tile shape,
//     so a row's result is the same bits at any M, for banked or broadcast x
//     and for any N.
//
// "simt" -- float32 (small_cnn's heads, F = 4: TF32 would keep about three
// digits where the reference sums exact f32 products) and bf16 shapes the
// TMA cannot describe (K or F not a multiple of 8).  A CUDA-core kernel:
// grid (F tiles, M tiles, member), 64 x 64 output tiles, 16-deep k slices
// staged in shared memory as f32, a 4 x 4 register tile of sums per thread,
// ragged M, K and F masked on load and store, the bias added once.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// route "simt"
// ---------------------------------------------------------------------------

namespace simt {

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

}  // namespace simt

// ---------------------------------------------------------------------------
// route "wgmma"
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;                     // two consumer warpgroups of 64 rows
constexpr int BN = 256;                     // one m64n256k16 per 16-deep step
constexpr int BK = 64;                      // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;                // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;        // 16 KB: x tile, K-major
constexpr int B_BOX = 64;                   // w columns per TMA box (128 bytes)
constexpr int B_BOX_BYTES = B_BOX * BK * 2; // 8 KB: 64 k rows of 128 bytes
constexpr int B_BYTES = BN * BK * 2;        // 32 KB: four boxes, MN-major
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_COLS = 32;                // columns a warp stages at a time
constexpr int EPI_LD = EPI_COLS + 8;        // floats a row; the pad spreads rows over banks
constexpr int EPI_WARP_FLOATS = 16 * EPI_LD;
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + STAGES * STAGE_BYTES +
                           CONSUMER_WARPS * EPI_WARP_FLOATS * 4 + 2 * STAGES * 8;

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
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

// Shared-memory matrix descriptor of a 128-byte-swizzled tile.  K-major (x):
// sbo = 1024 bytes between 8-row groups, lbo unused.  MN-major (w): lbo =
// bytes between 64-column swizzle atoms, sbo = bytes between 8-deep k groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Orders later register reads after a wgmma wait: the compiler may not move
// a read of the accumulator above this point.
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 256 f32, 128 registers a thread) += A (64 x 16, K-major) * B (16 x
// 256, MN-major), or = when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1)
bank_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __nv_bfloat16* __restrict__ bias, float* __restrict__ out,
                  int N, int M, int K, int F, int broadcast) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on a 1024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_tiles = smem;
  uint8_t* b_tiles = smem + STAGES * A_BYTES;
  float* epi = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + CONSUMER_WARPS * EPI_WARP_FLOATS);
  const uint32_t full0 = smem_u32(bars);             // STAGES "full" barriers
  const uint32_t empty0 = smem_u32(bars + STAGES);   // STAGES "empty" barriers

  const int m_tiles = (M + BM - 1) / BM;
  const int f_tiles = (F + BN - 1) / BN;
  const int tiles = N * m_tiles * f_tiles;
  const int k_tiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring of TMA loads full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mt = t % m_tiles;
        const int ft = (t / m_tiles) % f_tiles;
        const int n = t / (m_tiles * f_tiles);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load_3d(smem_u32(a_tiles + stage * A_BYTES), &x_map, full, kt * BK, mt * BM,
                      broadcast ? 0 : n);
#pragma unroll
          for (int j = 0; j < BN / B_BOX; ++j)
            tma_load_3d(smem_u32(b_tiles + stage * B_BYTES + j * B_BOX_BYTES), &w_map, full,
                        ft * BN + j * B_BOX, kt * BK, n);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, wgmma from the ring, f32 in registers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    float* ebuf = epi + (wg * 4 + warp) * EPI_WARP_FLOATS;
    float d[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t % m_tiles;
      const int ft = (t / m_tiles) % f_tiles;
      const int n = t / (m_tiles * f_tiles);
      const bool live = mt * BM + wg * 64 < M;  // else this warpgroup's rows are all padding
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        if (live) {
          const uint32_t a_base = smem_u32(a_tiles + stage * A_BYTES) + wg * 64 * 128;
          const uint32_t b_base = smem_u32(b_tiles + stage * B_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n256k16(d, sw128_desc(a_base + kk * 32, 16, 1024),
                             sw128_desc(b_base + kk * 16 * 128, B_BOX_BYTES, 1024),
                             (kt > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done
        }
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      if (live) {
        wgmma_wait<0>();
        fence_operands(d);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      if (!live) continue;

      // epilogue: this warp owns rows gm0 .. gm0 + 15 of the tile
      const int gm0 = mt * BM + wg * 64 + warp * 16;
      const int r_lo = lane / 4, c_lo = (lane % 4) * 2;
#pragma unroll
      for (int c = 0; c < BN / EPI_COLS; ++c) {
        __syncwarp();  // the previous chunk's reads are done
#pragma unroll
        for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
          const int j = c * (EPI_COLS / 8) + jj;  // n8 group of the accumulator
          *reinterpret_cast<float2*>(ebuf + r_lo * EPI_LD + jj * 8 + c_lo) =
              make_float2(d[4 * j], d[4 * j + 1]);
          *reinterpret_cast<float2*>(ebuf + (r_lo + 8) * EPI_LD + jj * 8 + c_lo) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int r = it * 4 + lane / 8, c4 = (lane % 8) * 4;
          const int gm = gm0 + r, gf = ft * BN + c * EPI_COLS + c4;
          if (gm < M && gf < F) {  // F % 8 == 0: the 4 columns are all in or all out
            float4 v = *reinterpret_cast<const float4*>(ebuf + r * EPI_LD + c4);
            if (bias != nullptr) {
              const __nv_bfloat16* bp = bias + (size_t)n * F + gf;
              v.x += __bfloat162float(bp[0]);
              v.y += __bfloat162float(bp[1]);
              v.z += __bfloat162float(bp[2]);
              v.w += __bfloat162float(bp[3]);
            }
            *reinterpret_cast<float4*>(out + ((size_t)n * M + gm) * F + gf) = v;
          }
        }
      }
    }
  }
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

// A bf16 tensor (d2, d1, d0) read in (1, b1, b0) boxes with the 128-byte
// swizzle; out-of-range elements of a box are zero-filled.
bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
               uint64_t d2, uint32_t b0, uint32_t b1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const void* x, const void* w, const void* b, void* out, int N, int M,
                   int K, int F, int broadcast, cudaStream_t stream) {
  if (K % 8 != 0 || F % 8 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorMisalignedAddress;
  const long long tiles = (long long)N * ((M + BM - 1) / BM) * ((F + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  if (!encode_3d(fn, &x_map, x, K, M, broadcast ? 1 : N, BK, BM) ||
      !encode_3d(fn, &w_map, w, F, K, N, B_BOX, BK))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bank_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  bank_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out), N, M, K,
      F, broadcast);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Route "simt".  dtype: 0 = float32, 1 = bfloat16.  b may be null.  Returns
// cudaError_t.
extern "C" int bank_matmul_simt_launch(const void* x, const void* w, const void* b,
                                       void* out, int N, int M, int K, int F,
                                       int broadcast, int dtype, void* stream) {
  if (N <= 0 || M <= 0 || K <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if ((M + simt::BM - 1) / simt::BM > 65535 || N > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)simt::launch<float>(x, w, b, out, N, M, K, F, broadcast, s);
  if (dtype == 1)
    return (int)simt::launch<__nv_bfloat16>(x, w, b, out, N, M, K, F, broadcast, s);
  return (int)cudaErrorInvalidValue;
}

// Route "wgmma": bfloat16 x and w with K % 8 == 0, F % 8 == 0 and 16-byte
// aligned pointers; b (bf16) may be null.  Returns cudaError_t.
extern "C" int bank_matmul_wgmma_launch(const void* x, const void* w, const void* b,
                                        void* out, int N, int M, int K, int F,
                                        int broadcast, void* stream) {
  if (N <= 0 || M <= 0 || K <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  return (int)tc::launch(x, w, b, out, N, M, K, F, broadcast,
                         static_cast<cudaStream_t>(stream));
}
