// Blocked flash attention (causal / sliding-window, GQA) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_flash_kernel`).  q is
// (B, S, Hq, D), k and v are (B, S, Hkv, D); the output has q's dtype and
// shape.  Online softmax with float32 running max m, sum l and accumulator;
// a query row that sees no key (l == 0) writes zeros; the scale defaults to
// 1/sqrt(D) in the wrapper; GQA reads kv head h / (Hq / Hkv); the kv loop
// starts at the window edge and stops at the causal diagonal, so fully
// masked tiles are neither loaded nor computed; ragged S is masked.  Two
// routes, chosen by the wrapper from dtype and head dim alone
// (kernels/flash_attention.py: route):
//
// What bounds it on this card: at the stablelm-1.6b serving shape (B = 8,
// S = 128, 32 heads of 64, causal) the kernel reads q, k, v and writes o
// once -- 16.8 MB, 5.0 us at 3.35 TB/s -- while the causal work is about
// 0.54 GFLOP, 0.55 us at the bf16 tensor-core peak: it is bound by bytes.
// At recurrentgemma-9b's (16 query heads of 256 on one kv head) likewise.
//
// "mma" -- bf16 at head dims 16, 64, 128 and 256: FlashAttention-2's shape
// on the tensor cores (at D = 16, QK^T is one k-step of the m16n8k16 product
// and PV two 8-wide column tiles).
//   * grid (64-row query tile, q head, batch), 4 warps of 16 query rows;
//   * the q tile and a double buffer of K and V tiles (64 keys, 32 at
//     D = 256) are copied into shared memory as bf16 with cp.async (a ragged
//     S zero-fills), rows XOR-swizzled in 16-byte chunks so that ldmatrix
//     reads them without bank conflicts; the next tile's copy overlaps this
//     tile's products;
//   * ldmatrix loads the Q and K fragments, ldmatrix.trans the V ones;
//     mma.sync m16n8k16 bf16 -> f32 computes S = Q K^T in registers;
//   * the online softmax runs on the accumulator fragments (row max and sum
//     reduced across the 4 threads of a row by shuffles, exp2 with the
//     scale folded in); P is rounded to bf16 in registers and used directly
//     as the A fragment of O += P V, as the Pallas kernel rounds p to v's
//     dtype before its product; the row sums stay f32;
//   * Q fragments stay in registers at D <= 128.  At D = 256 a warp's O
//     accumulator alone would take 128 f32 registers a thread, so two warps
//     share each 16-row group, each owning 128 of the O columns (S is
//     computed by both), Q is re-read from shared memory per tile and the
//     key tile is 32 deep;
//   * the output is staged through the warp's own q rows in shared memory
//     and stored as 16-byte chunks of whole rows.
//
// "simt" -- float32 (TF32 would keep about three digits where the reference
// sums f32 products): the products on CUDA cores.
//   * grid as above; 256 threads, 4 to a query row: each scores 16 of the
//     64 keys of a tile and owns D / 4 output columns; the row max and sum
//     are combined by shuffles;
//   * each 64-key tile of K and V is staged in shared memory as float32,
//     rows padded by one word so the row-parallel reads are conflict-free;
//     at D = 256 the tiles take 209 KB, so one block fits an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// route "simt"
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;  // 4 threads per query row

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
         (size_t)BQ * (BKV + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int Hq,
             int Hkv, int causal, int window, float scale) {
  extern __shared__ float smem_f[];
  float* qs = smem_f;                    // [BQ][D + 1]
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
    qs[row * (D + 1) + d] = s < S ? q[(((long long)b * S + s) * Hq + h) * D + d] : 0.f;
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
      ks[row * (D + 1) + d] = in ? k[g] : 0.f;
      vs[row * D + d] = in ? v[g] : 0.f;
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
    float* orow = o + (((long long)b * S + qp) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[l4 + 4 * j] = acc[j] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Hq, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// route "mma"
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;  // 4 row groups of 16 query rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BKV = D == 256 ? 32 : 64;  // keys per tile
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int DSPLIT = D == 256 ? 2 : 1;  // warps sharing a row group's O columns
  static constexpr int THREADS = 128 * DSPLIT;
  static constexpr int CH = D / 8;                 // 16-byte chunks per row
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BKV) * D * 2;  // q + 2 x (k, v)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `row` in a tile of CH chunks a
// row: the chunk index is XORed with the row's low 3 bits, or at D = 16 (two
// chunks a row) with its lowest bit, so the chunk stays inside its row
template <int CH>
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  constexpr int MASK = CH < 8 ? CH - 1 : 7;
  return (uint32_t)(row * CH + (ch ^ (row & MASK))) * 16u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 int Hq, int Hkv, int causal, int window, float scale_log2) {
  constexpr int BKV = Cfg<D>::BKV, CH = Cfg<D>::CH, THREADS = Cfg<D>::THREADS;
  constexpr int KD = D / 16;                 // 16-deep steps over the head dim
  constexpr int NK = BKV / 8;                // 8-key column tiles of S
  constexpr int ND = D / 8 / Cfg<D>::DSPLIT;  // 8-wide column tiles of O this warp owns
  extern __shared__ __align__(128) uint8_t smem_b[];
  uint8_t* qs = smem_b;                            // [BQ][D]
  uint8_t* ks = qs + BQ * D * 2;                   // [2][BKV][D]
  uint8_t* vs = ks + 2 * BKV * D * 2;              // [2][BKV][D]
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks), vs_a = smem_u32(vs);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = (tid / 32) % 4;      // row group: query rows 16 warp .. 16 warp + 15
  const int dcol = (tid / 128) * ND;    // first O column tile of this warp
  const size_t q_row = (size_t)Hq * D, kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* qg = q + ((size_t)b * S * Hq + h) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * S * Hkv + hk) * D;
  const __nv_bfloat16* vg = v + ((size_t)b * S * Hkv + hk) * D;

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);              // stop at the diagonal
  if (window > 0) k_lo = max(0, q0 - window + 1);  // start at the window edge
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int row = c / CH, ch = c % CH, s = q0 + row;
    cp_async16(qs_a + swz<CH>(row, ch), qg + (size_t)min(s, S - 1) * q_row + ch * 8, s < S);
  }
  auto load_kv = [&](int tile, int buf) {
    const int k0 = k_lo + tile * BKV;
    const uint32_t kb = ks_a + buf * BKV * D * 2, vb = vs_a + buf * BKV * D * 2;
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int row = c / CH, ch = c % CH, s = k0 + row;
      const size_t off = (size_t)min(s, S - 1) * kv_row + ch * 8;
      cp_async16(kb + swz<CH>(row, ch), kg + off, s < S);
      cp_async16(vb + swz<CH>(row, ch), vg + off, s < S);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group: q and the first kv tile

  const int qrow0 = q0 + warp * 16 + lane / 4;  // rows qrow0 and qrow0 + 8
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  uint32_t qf[Cfg<D>::Q_IN_REGS ? KD : 1][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this tile (and q) landed
    __syncthreads();
    const uint32_t kb = ks_a + buf * BKV * D * 2, vb = vs_a + buf * BKV * D * 2;

    if (Cfg<D>::Q_IN_REGS && t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[Cfg<D>::Q_IN_REGS ? kd : 0],
                    qs_a + swz<CH>(warp * 16 + (lane & 15), 2 * kd + (lane >> 4)));
    }

    // S = Q K^T for this warp's 16 rows and the tile's BKV keys
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if (Cfg<D>::Q_IN_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[Cfg<D>::Q_IN_REGS ? kd : 0][i];
      } else {
        ldmatrix_x4(a, qs_a + swz<CH>(warp * 16 + (lane & 15), 2 * kd + (lane >> 4)));
      }
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kb + swz<CH>(jp * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kd + ((lane >> 3) & 1)));
        mma16816(sc[2 * jp], a, bf[0], bf[1]);
        mma16816(sc[2 * jp + 1], a, bf[2], bf[3]);
      }
    }

    // mask, scale into log2 units, online softmax per row
    const int k0 = k_lo + t * BKV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qrow0 + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane & 3) + e;
          const bool ok = kp < S && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
          const float s = ok ? sc[j][2 * r + e] * scale_log2 : -INFINITY;
          sc[j][2 * r + e] = s;
          mx = fmaxf(mx, s);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: every p is 0
      const float alpha = exp2f(m_r[r] - m_use);             // exp2(-inf) = 0
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[j][2 * r + e] - m_use);
          sc[j][2 * r + e] = p;
          sum += p;
        }
      l_r[r] = l_r[r] * alpha + sum;  // this thread's share; reduced at the end
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers as the A fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vb + swz<CH>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           dcol + 2 * dp + (lane >> 4)));
        mma16816(acc[2 * dp], a, bf[0], bf[1]);
        mma16816(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // normalise, stage the warp's rows and columns in its q rows, store them
  cp_async_wait<0>();
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // l == 0: write zeros
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + lane / 4 + 8 * r;
      *reinterpret_cast<uint32_t*>(qs + swz<CH>(row, dcol + j) + (lane & 3) * 4) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
  __syncwarp();
  for (int c = lane; c < 16 * ND; c += 32) {
    const int row = warp * 16 + c / ND, ch = dcol + c % ND, s = q0 + row;
    if (s < S)
      *reinterpret_cast<uint4*>(o + (((size_t)b * S + s) * Hq + h) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<CH>(row, ch));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int Hq, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_mma_kernel<D><<<grid, Cfg<D>::THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Hq, Hkv,
      causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

bool valid_shape(int B, int S, int Hq, int Hkv) {
  return B > 0 && S > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0;
}

}  // namespace

// Route "simt": float32 q, k, v, o.  window <= 0 means no window.  Returns
// cudaError_t.
extern "C" int flash_attention_simt_launch(const void* q, const void* k, const void* v,
                                           void* o, int B, int S, int Hq, int Hkv, int D,
                                           int causal, int window, float scale,
                                           void* stream) {
  if (!valid_shape(B, S, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  if (Hq > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return (int)simt::launch<16>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 64) return (int)simt::launch<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 128) return (int)simt::launch<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 256) return (int)simt::launch<256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Route "mma": bfloat16 q, k, v, o; D in {16, 64, 128, 256}.  window <= 0 means
// no window.  Returns cudaError_t.
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v,
                                          void* o, int B, int S, int Hq, int Hkv, int D,
                                          int causal, int window, float scale,
                                          void* stream) {
  if (!valid_shape(B, S, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  if (Hq > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return (int)tc::launch<16>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 64) return (int)tc::launch<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 128) return (int)tc::launch<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  if (D == 256) return (int)tc::launch<256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
