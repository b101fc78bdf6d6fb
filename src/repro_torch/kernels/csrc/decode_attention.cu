// One-query grouped-query attention against a KV cache, for Hopper.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (body `_decode_kernel`).  q is
// (B, Hq, D), the caches k and v are (B, Smax, Hkv, D), lengths (B,) int32
// gives each row's valid prefix; the output (B, Hq, D) has q's dtype.
// Float32 online softmax over k and v widened to float32, as the Pallas
// body does; a row of length 0 writes exact zeros (the kernel's l == 0
// guard); the scale defaults to 1/sqrt(D) in the wrapper.
//
// What bounds it on this card: every valid cache byte is read once and the
// arithmetic is 4 * D operations per (query head, key) -- at G = Hq / Hkv
// query heads per kv head, 2 G operations per bf16 byte read, below the
// float32 rate's ~20 operations a byte up to G = 8 and near it at G = 16.
// It is bound by bytes: q + out + sum_b lengths[b] * Hkv * D * 2 elements
// (1.3 us at the stablelm-1.6b decode shape, 47 us at a 4096-key cache).
// The design ("flash decoding", keys split across blocks):
//   * a row's keys are cut into fixed chunks of CHUNK keys; the boundaries
//     are key positions alone (they do not depend on Smax, on B or on the
//     other rows), so a row gives the same bits alone or in any batch;
//   * grid (kv head, chunk, batch row): a block owns one chunk of one
//     (row, kv head) for all G query heads, so each k/v row is read once;
//     the kv heads run fastest, so neighbouring blocks read neighbouring
//     128-byte pieces of the same key rows; a chunk at or past the row's
//     length returns at once;
//   * inside a block the 4 warps take disjoint keys (key j of the chunk
//     goes to key group j % NKG); a lane holds a 16-byte slice of D of its
//     key, loaded straight from global memory into registers, one batch of
//     KB keys in flight while the batch before it is computed; LPK lanes
//     reduce a dot product by shuffles; q (pre-scaled by scale * log2 e,
//     its load issued beside the length's) and each lane group's running
//     max, sum and accumulator live in registers.  Where G * 16 bytes of
//     accumulator would crowd the registers, the lane groups of a warp
//     split the G heads between them (HGR groups) and read the same key;
//   * the key groups of a warp merge by shuffles in a fixed tree, the
//     warps through shared memory in warp order; a row of one chunk writes
//     its output there.  Rows of more chunks write (m, l, acc) partials to
//     a workspace; the last block of a (row, kv head) to finish (an atomic
//     counter the wrapper owns, reset to zero by that block) merges them in
//     chunk order.  So one wrapper call is one launch, and every sum runs
//     in an order fixed by the key positions: repeat launches give the
//     same bits.
// Head dims 16, 64 and 128 are compiled; G may be 1 to 16 (compiled for 1, 2,
// 4, 8 and 16 heads; a G in between runs the next one with idle heads).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;  // keys per chunk: the wrapper's CHUNK must agree
constexpr int GMAX = 16;    // query heads per kv head
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T widened to float32
template <typename T> struct Wide;
template <> struct Wide<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Wide<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void get(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// How a block lays out one chunk for element type T, head dim D and GT
// compiled query heads.
template <typename T, int D, int GT>
struct Plan {
  static constexpr int V = Wide<T>::V;                 // elements of D a lane holds
  static constexpr int LPK = D / V;                    // lanes per key row
  static constexpr int KPW = 32 / LPK;                 // lane groups per warp
  static constexpr int HGR = cmin(cmin(cmax(GT * V / 32, 1), KPW), GT);  // head groups
  static constexpr int GL = GT / HGR;                  // heads per lane
  static constexpr int KG = KPW / HGR;                 // key groups per warp
  static constexpr int NKG = WARPS * KG;               // key groups per block
  static constexpr int KB = GL * V <= 32 ? 4 : 2;      // keys per batch, two batches in flight
  static_assert(LPK <= 32 && 32 % LPK == 0, "a key row spans whole lanes of one warp");
  static_assert(CHUNK % NKG == 0, "every key group gets the same share of a chunk");
};

// (m, l, acc) of one head merged with a partner's: the symmetric form, so
// both partners hold the same bits
template <int V>
__device__ __forceinline__ void merge_partner(float& m, float& l, float* acc, int off) {
  const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
  const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
  const float M = fmaxf(m, m2);
  const float Mref = M == -INFINITY ? 0.f : M;  // both empty: every weight 0
  const float w1 = ex2(__fsub_rn(m, Mref)), w2 = ex2(__fsub_rn(m2, Mref));
  l = __fadd_rn(__fmul_rn(l, w1), __fmul_rn(l2, w2));
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float a2 = __shfl_xor_sync(0xffffffffu, acc[i], off);
    acc[i] = __fadd_rn(__fmul_rn(acc[i], w1), __fmul_rn(a2, w2));
  }
  m = M;
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ ws, int* __restrict__ counters,
              int Smax, int Hq, int Hkv, int cmax_chunks, float scale) {
  using P = Plan<T, D, GT>;
  constexpr int V = P::V, LPK = P::LPK, HGR = P::HGR, GL = P::GL, KG = P::KG;
  constexpr int NKG = P::NKG, KB = P::KB;
  __shared__ float sm_m[WARPS][GT];
  __shared__ float sm_l[WARPS][GT];
  __shared__ __align__(16) float sm_acc[WARPS][GT][D];
  __shared__ int sm_last;

  const int hk = blockIdx.x;  // kv heads fastest: neighbouring blocks read one key row
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int dl = lane % LPK;                 // which 16-byte slice of D
  const int hg = (lane / LPK) % HGR;         // which group of heads
  const int kgw = lane / (LPK * HGR);        // key group in the warp
  const int kgi = warp * KG + kgw;           // key group in the block
  const long long obase = ((long long)b * Hq + (long long)hk * G) * D;

  // q first: its load overlaps the length's
  float qf[GL][V], acc[GL][V], m[GL], l[GL];
#pragma unroll
  for (int gi = 0; gi < GL; ++gi) {
    const int g = hg * GL + gi;
    if (g < G) {
      const uint4 u = *reinterpret_cast<const uint4*>(q + obase + (long long)g * D + dl * V);
      Wide<T>::get(u, qf[gi]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) qf[gi][i] = 0.f;
    }
  }
  const int L = min(max(lengths[b], 0), Smax);
  const int nch = (L + CHUNK - 1) / CHUNK;  // this row's chunks
  if (c >= max(nch, 1)) return;
  if (L == 0) {  // chunk 0 of an empty row: exact zeros
    for (int e = tid; e < G * D; e += THREADS) o[obase + e] = from_f32<T>(0.f);
    return;
  }

  const float qscale = scale * LOG2E;
#pragma unroll
  for (int gi = 0; gi < GL; ++gi) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qf[gi][i] *= qscale;
      acc[gi][i] = 0.f;
    }
    m[gi] = -INFINITY;
    l[gi] = 0.f;
  }

  const int k0 = c * CHUNK;
  const int kend = min(k0 + CHUNK, L);
  const long long row_stride = (long long)Hkv * D;
  const T* kb = k + ((long long)b * Smax * Hkv + hk) * D + dl * V;
  const T* vb = v + ((long long)b * Smax * Hkv + hk) * D + dl * V;
  auto load_batch = [&](int i0, uint4* kr, uint4* vr) {
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int j = k0 + kgi + NKG * (i0 + u);
      if (j < kend) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + j * row_stride));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + j * row_stride));
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // every key group has at most ceil((kend - k0) / NKG) keys of this chunk
  const int per_group = (kend - k0 + NKG - 1) / NKG;
  uint4 kr[KB], vr[KB];
  load_batch(0, kr, vr);
  for (int i0 = 0; i0 < per_group; i0 += KB) {
    uint4 kn[KB], vn[KB];  // the next batch, in flight while this one runs
    load_batch(i0 + KB, kn, vn);
#pragma unroll
    for (int gi = 0; gi < GL; ++gi) {
      float s[KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float kf[V];
        Wide<T>::get(kr[u], kf);
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) d = __fmaf_rn(qf[gi][i], kf[i], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
        s[u] = k0 + kgi + NKG * (i0 + u) < kend ? d : -INFINITY;
      }
      float mb = m[gi];
#pragma unroll
      for (int u = 0; u < KB; ++u) mb = fmaxf(mb, s[u]);
      const float mref = mb == -INFINITY ? 0.f : mb;  // no valid key yet: all terms 0
      const float alpha = ex2(__fsub_rn(m[gi], mref));
      float p[KB];
      float lsum = __fmul_rn(l[gi], alpha);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        p[u] = ex2(__fsub_rn(s[u], mref));
        lsum = __fadd_rn(lsum, p[u]);
      }
      l[gi] = lsum;
      m[gi] = mb;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[gi][i] = __fmul_rn(acc[gi][i], alpha);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float vf[V];
        Wide<T>::get(vr[u], vf);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[gi][i] = __fmaf_rn(p[u], vf[i], acc[gi][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // the warp's key groups merged by shuffles in a fixed tree, then the
  // warps' partials through shared memory in warp order
#pragma unroll
  for (int off = LPK * HGR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GL; ++gi) merge_partner<V>(m[gi], l[gi], acc[gi], off);
  }
  if (kgw == 0) {
#pragma unroll
    for (int gi = 0; gi < GL; ++gi) {
      const int g = hg * GL + gi;
      if (dl == 0) {
        sm_m[warp][g] = m[gi];
        sm_l[warp][g] = l[gi];
      }
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(&sm_acc[warp][g][dl * V + i]) =
            make_float4(acc[gi][i], acc[gi][i + 1], acc[gi][i + 2], acc[gi][i + 3]);
    }
  }
  __syncthreads();

  // workspace: acc [B][Hkv][cmax][G][D], then m and l [B][Hkv][cmax][G]
  const long long slots = (long long)gridDim.z * Hkv * cmax_chunks * G;
  float* ws_acc = ws;
  float* ws_m = ws + slots * D;
  float* ws_l = ws_m + slots;
  const long long rowslot = ((long long)b * Hkv + hk) * cmax_chunks;  // chunk 0 of this row
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);  // finite: k0 < L
    float Ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = ex2(__fsub_rn(sm_m[w][g], M));
      Ls = __fmaf_rn(sm_l[w][g], wt, Ls);
      a = __fmaf_rn(sm_acc[w][g][d], wt, a);
    }
    if (nch == 1) {  // the whole row in this block
      o[obase + e] = from_f32<T>(__fdiv_rn(a, Ls));
    } else {
      ws_acc[(rowslot + c) * G * D + e] = a;
      if (d == 0) {
        ws_m[(rowslot + c) * G + g] = M;
        ws_l[(rowslot + c) * G + g] = Ls;
      }
    }
  }
  if (nch == 1) return;

  __threadfence();
  __syncthreads();
  int* counter = counters + (long long)b * Hkv + hk;
  if (tid == 0) sm_last = atomicAdd(counter, 1) == nch - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // the last block of (row, kv head): merge the chunks in chunk order, the
  // partials of CB chunks loaded together
  constexpr int CB = 4;
  const float* wm = ws_m + rowslot * G;
  const float* wl = ws_l + rowslot * G;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    float M = -INFINITY;
    for (int c0 = 0; c0 < nch; c0 += CB) {
      float mv[CB];
#pragma unroll
      for (int k = 0; k < CB; ++k)
        mv[k] = c0 + k < nch ? __ldcg(wm + (c0 + k) * G + g) : -INFINITY;
#pragma unroll
      for (int k = 0; k < CB; ++k) M = fmaxf(M, mv[k]);
    }
    float Ls = 0.f, a = 0.f;
    for (int c0 = 0; c0 < nch; c0 += CB) {
      float mv[CB], lv[CB], av[CB];
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const bool ok = c0 + k < nch;
        mv[k] = ok ? __ldcg(wm + (c0 + k) * G + g) : -INFINITY;
        lv[k] = ok ? __ldcg(wl + (c0 + k) * G + g) : 0.f;
        av[k] = ok ? __ldcg(ws_acc + (rowslot + c0 + k) * G * D + e) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        if (c0 + k < nch) {
          const float wt = ex2(__fsub_rn(mv[k], M));
          Ls = __fmaf_rn(lv[k], wt, Ls);
          a = __fmaf_rn(av[k], wt, a);
        }
      }
    }
    o[obase + e] = from_f32<T>(__fdiv_rn(a, Ls));
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int D, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* o, float* ws, int* counters, int B, int Smax, int Hq, int Hkv,
                   float scale, cudaStream_t stream) {
  const int cmax_chunks = Smax > 0 ? (Smax + CHUNK - 1) / CHUNK : 1;
  dim3 grid(Hkv, cmax_chunks, B);
  decode_kernel<T, D, GT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), ws, counters, Smax, Hq, Hkv, cmax_chunks, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k, const void* v, const int* lengths,
                     void* o, float* ws, int* counters, int B, int Smax, int Hq, int Hkv,
                     float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
#define DECODE_G(GT)                                                                     \
  if (G <= GT)                                                                           \
    return launch<T, D, GT>(q, k, v, lengths, o, ws, counters, B, Smax, Hq, Hkv, scale, \
                            stream);
  DECODE_G(1) DECODE_G(2) DECODE_G(4) DECODE_G(8) DECODE_G(16)
#undef DECODE_G
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* lengths,
                     void* o, float* ws, int* counters, int B, int Smax, int Hq, int Hkv,
                     int D, float scale, cudaStream_t stream) {
  if (D == 16)
    return launch_g<T, 16>(q, k, v, lengths, o, ws, counters, B, Smax, Hq, Hkv, scale, stream);
  if (D == 64)
    return launch_g<T, 64>(q, k, v, lengths, o, ws, counters, B, Smax, Hq, Hkv, scale, stream);
  if (D == 128)
    return launch_g<T, 128>(q, k, v, lengths, o, ws, counters, B, Smax, Hq, Hkv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, D), k and v (B, Smax, Hkv, D), lengths (B,) int32, o (B, Hq, D),
// all contiguous and 16-byte aligned.  ws: B * Hkv * ceil(Smax / chunk) *
// (Hq / Hkv) * (D + 2) float32 (unused when Smax <= chunk); counters: B * Hkv
// int32, zero before the launch and zero after it.  chunk must be the
// compiled CHUNK.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* o, void* ws,
                                       void* counters, int B, int Smax, int Hq, int Hkv,
                                       int D, int chunk, float scale, int dtype,
                                       void* stream) {
  if (B < 0 || Smax < 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || chunk != CHUNK)
    return (int)cudaErrorInvalidValue;
  if (Hq / Hkv > GMAX) return (int)cudaErrorInvalidValue;
  if (B > 65535 || (Smax + CHUNK - 1) / CHUNK > 65535) return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return (int)launch_d<float>(q, k, v, len, o, w, cnt, B, Smax, Hq, Hkv, D, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, len, o, w, cnt, B, Smax, Hq, Hkv, D, scale,
                                        s);
  return (int)cudaErrorInvalidValue;
}
