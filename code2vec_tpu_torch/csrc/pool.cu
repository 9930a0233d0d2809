// K1: masked attention pool over encoded contexts; K1b, its backward
// (below pool_kernel).
//
// Replaces code2vec_tpu/ops/pallas_attention.py:_forward (pl.pallas_call
// at :114, kernel _make_kernel :63, body _tile_pool :38), the kernel of
// pallas_impl="pool_only". In: ctx [B, L, H] and a [H], both f32 or both
// bf16 (the model's compute dtype), mask [B, L] f32. Out: cv [B, H] f32,
// w [B, L] f32. bf16 is read as it is (8 bytes where f32 takes 16) and
// widened on load, as _tile_pool widens its tile and the attention vector
// (:50, :97); everything after the load is the f32 arithmetic.
//
// Semantics (code2vec_tpu/ops/attention.py): s = <ctx_l, a>; a masked slot
// scores the FINITE sentinel NINF via s*m + (1-m)*NINF; softmax over the
// bag; cv = sum_l w_l ctx_l. An all-masked row gets uniform weights 1/L.
//
// Bound on an H100: bytes. The pool reads each context once and does 4
// flops per element of it, far below the card's ~20 flops per byte of f32
// ridge, so the kernel's job is to keep enough loads in flight that one
// HBM round trip, not a chain of them, sets its time. Design, one launch
// per call:
//
// - grid (S, B): S CTAs per batch row (pool_ctas in ops/pool_kernel.py,
//   1..8), launched as one thread-block cluster of S CTAs per row (a plain
//   launch when S = 1);
// - a CTA is kWarps warps. A warp takes in_flight(N) whole contexts at a
//   time straight into registers, each lane holding N float4 slices of a
//   context (H = 100: 25 lanes, one float4 each; H = 300: three), with
//   16-byte loads (8 for bf16) when H % 4 == 0 and scalar loads otherwise.
//   It scores
//   them with a warp sum and folds them into its own online softmax state
//   (max m, denominator d, acc[H]) in registers; the raw scores go to
//   shared memory (to w when a CTA's share of the bag does not fit);
// - the warps merge once through shared memory into the CTA's partial,
//   and the cluster's CTAs merge their partials through distributed
//   shared memory (cooperative_groups map_shared_rank): every CTA derives
//   the row's max M and denominator D in the same order, writes its slice
//   of cv = sum acc_c exp(m_c - M) / D and its contexts' weights
//   w = exp(s - M) / D, each once.
//
// The TPU kernel's batch tiles of 8 and 128-lane bag padding exist for
// the TPU's vector unit and are not copied.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "pool.cuh"

namespace cg = cooperative_groups;

namespace {

using c2v::kNinf;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;           // portable cluster size
constexpr int kMaxSlices = 8;            // float4 slices per lane: H <= 1024
static_assert(kWarps <= kMaxCluster, "stat[] holds the warps' scales, then the CTAs'");

// Contexts a warp keeps in flight: N float4 slices of each in registers,
// 32 floats a lane in all.
__host__ __device__ constexpr int in_flight(int n) { return n >= 8 ? 1 : 8 / n; }

// Floats of shared memory before the scores: kWarps warp partials and the
// CTA's partial ([H] acc, then m, d each), and the cluster's merge scales.
__host__ __device__ constexpr size_t partial_floats(int H) {
  return (size_t)(kWarps + 1) * (H + 2) + kMaxCluster + 2;
}

// One element, or four consecutive ones (one 16-byte f32 or 8-byte bf16
// load), of global memory widened to f32: a bf16 value is the top half of
// its f32 (little-endian, the lower address in the low half of a word).
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// The same stores, a bf16 output rounded to nearest even (as astype rounds).
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// Lane `lane`'s N float4 slices of a row of H elements (f32 or bf16,
// widened): slice k holds elements 4 * (lane + 32 k) .. + 3, zero past H.
template <class T, int N>
__device__ __forceinline__ void load_slices(const T* __restrict__ row, int H, bool vec, int lane,
                                            float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (vec) {
      x[k] = e < H ? load4(row + e) : make_float4(0, 0, 0, 0);
    } else {
      x[k].x = e < H ? load1(row + e) : 0.f;
      x[k].y = e + 1 < H ? load1(row + e + 1) : 0.f;
      x[k].z = e + 2 < H ? load1(row + e + 2) : 0.f;
      x[k].w = e + 3 < H ? load1(row + e + 3) : 0.f;
    }
  }
}

// Four consecutive elements as stored (a float4 of f32, a uint2 of four
// bf16), loaded as they are and widened apart from the load.
template <class T>
struct QuadOf;
template <>
struct QuadOf<float> {
  using type = float4;
};
template <>
struct QuadOf<bf16> {
  using type = uint2;
};
template <class T>
using Quad = typename QuadOf<T>::type;

__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load_quad(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Lane `lane`'s slices (as load_slices) of the U contexts cb .. cb+U-1 of a
// batch row starting at row `row0`, each clamped to `last`. With vector
// loads every load is issued before any value is used: bf16 arrives as raw
// words and is widened only after the last load, since a widen placed
// between the loads would wait for its own and hold the next back (the warp
// issues in order), so one round trip serves the U contexts.
template <class T, int U, int N>
__device__ __forceinline__ void load_contexts(const T* __restrict__ ctx, size_t row0, int cb,
                                              int last, int H, bool vec, int lane,
                                              float4 (&x)[U][N]) {
  if (!vec) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_slices<T, N>(ctx + (row0 + min(cb + u, last)) * H, H, false, lane, x[u]);
    }
    return;
  }
  Quad<T> r[U][N];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* row = ctx + (row0 + min(cb + u, last)) * H;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int e = 4 * (lane + 32 * k);
      r[u][k] = e < H ? load_quad(row + e) : Quad<T>{};
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[u][k] = widen4(r[u][k]);
  }
}

template <class T, int N>
__device__ __forceinline__ void store_slices(T* row, int H, int lane, const float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (e < H) store1(row + e, x[k].x);
    if (e + 1 < H) store1(row + e + 1, x[k].y);
    if (e + 2 < H) store1(row + e + 2, x[k].z);
    if (e + 3 < H) store1(row + e + 3, x[k].w);
  }
}

// exp(m - M), 0 for a partial that folded nothing (m = -inf).
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <class T, int N>
__global__ void __launch_bounds__(kThreads) pool_kernel(
    const T* __restrict__ ctx, const float* __restrict__ mask, const T* __restrict__ attn,
    float* __restrict__ cv, float* __restrict__ w, int L, int H, int per_cta, bool vec,
    bool scores_in_smem) {
  constexpr int U = in_flight(N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  extern __shared__ float smem[];
  float* part = smem;                               // [kWarps][H + 2] warp partials
  float* cpart = part + (size_t)kWarps * (H + 2);   // [H + 2] the CTA's partial
  float* stat = cpart + H + 2;                      // [kMaxCluster] scales, then M, D
  const int c0 = min(L, rank * per_cta), c1 = min(L, c0 + per_cta);
  float* sraw = scores_in_smem ? stat + kMaxCluster + 2 : w + (size_t)b * L + c0;
  float* w_row = w + (size_t)b * L + c0;
  // a row whose bag fits one step of warp 0 is finished by warp 0 alone
  const bool one_warp = n_cta == 1 && per_cta <= U;
  if (one_warp && warp != 0) return;

  float4 a[N];
  load_slices<T, N>(attn, H, vec, lane, a);
  const float* row_mask = mask + (size_t)b * L;
  float m = -INFINITY, d = 0.f;
  float4 acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = make_float4(0, 0, 0, 0);

  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    // every load of the step is issued before any is used
    // (a slot past the CTA's share reloads its last context and scores -inf)
    float4 x[U][N];
    load_contexts<T, U, N>(ctx, (size_t)b * L, cb, c1 - 1, H, vec, lane, x);
    const float mk_lane = lane < U && cb + lane < c1 ? __ldg(row_mask + cb + lane) : 0.f;
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        v = fmaf(x[u][k].x, a[k].x, v);
        v = fmaf(x[u][k].y, a[k].y, v);
        v = fmaf(x[u][k].z, a[k].z, v);
        v = fmaf(x[u][k].w, a[k].w, v);
      }
      v = c2v::warp_sum(v);
      const float mk = __shfl_sync(0xffffffffu, mk_lane, u);
      s[u] = cb + u < c1 ? v * mk + (1.f - mk) * kNinf : -INFINITY;
      if (lane == u && cb + u < c1) sraw[cb + u - c0] = s[u];
      mx = fmaxf(mx, s[u]);
    }
    const float scale = rescale(m, mx);
    d *= scale;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc[k].x *= scale;
      acc[k].y *= scale;
      acc[k].z *= scale;
      acc[k].w *= scale;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float e = expf(s[u] - mx);  // 0 for a slot past the share (s = -inf)
      d += e;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        acc[k].x = fmaf(e, x[u][k].x, acc[k].x);
        acc[k].y = fmaf(e, x[u][k].y, acc[k].y);
        acc[k].z = fmaf(e, x[u][k].z, acc[k].z);
        acc[k].w = fmaf(e, x[u][k].w, acc[k].w);
      }
    }
    m = mx;
  }

  if (one_warp) {
    __syncwarp();  // the lanes' raw scores
    float* cv_row = cv + (size_t)b * H;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int e = 4 * (lane + 32 * k);
      if (e < H) cv_row[e] = acc[k].x / d;
      if (e + 1 < H) cv_row[e + 1] = acc[k].y / d;
      if (e + 2 < H) cv_row[e + 2] = acc[k].z / d;
      if (e + 3 < H) cv_row[e + 3] = acc[k].w / d;
    }
    for (int c = lane; c < c1 - c0; c += 32) w_row[c] = expf(sraw[c] - m) / d;
    return;
  }

  // the warps' partials -> the CTA's partial
  float* mine = part + (size_t)warp * (H + 2);
  store_slices<float, N>(mine, H, lane, acc);
  if (lane == 0) {
    mine[H] = m;
    mine[H + 1] = d;
  }
  __syncthreads();
  if (warp == 0) {
    const float mw = lane < kWarps ? part[(size_t)lane * (H + 2) + H] : -INFINITY;
    const float M = c2v::warp_max(mw);
    const float sw = lane < kWarps ? rescale(mw, M) : 0.f;
    const float D = c2v::warp_sum(lane < kWarps ? part[(size_t)lane * (H + 2) + H + 1] * sw : 0.f);
    if (lane < kWarps) stat[lane] = sw;
    if (lane == 0) {
      cpart[H] = M;
      cpart[H + 1] = D;
    }
  }
  __syncthreads();
  if (n_cta == 1) {  // the CTA's partial is the row's
    const float D = cpart[H + 1];
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) v = fmaf(part[(size_t)q * (H + 2) + h], stat[q], v);
      cv[(size_t)b * H + h] = v / D;
    }
    for (int c = threadIdx.x; c < c1 - c0; c += kThreads) w_row[c] = expf(sraw[c] - cpart[H]) / D;
    return;
  }
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v = fmaf(part[(size_t)q * (H + 2) + h], stat[q], v);
    cpart[h] = v;
  }

  // the cluster's partials -> the row's M, D (the same in every CTA)
  cluster.sync();
  if (warp == 0) {
    const float mq = lane < n_cta ? cluster.map_shared_rank(cpart, lane)[H] : -INFINITY;
    const float dq = lane < n_cta ? cluster.map_shared_rank(cpart, lane)[H + 1] : 0.f;
    const float M = c2v::warp_max(mq);
    const float sq = lane < n_cta ? rescale(mq, M) : 0.f;
    const float D = c2v::warp_sum(dq * sq);
    if (lane < n_cta) stat[lane] = sq;
    if (lane == 0) {
      stat[kMaxCluster] = M;
      stat[kMaxCluster + 1] = D;
    }
  }
  __syncthreads();
  const float M = stat[kMaxCluster], D = stat[kMaxCluster + 1];
  for (int h = rank * kThreads + threadIdx.x; h < H; h += n_cta * kThreads) {
    float v = 0.f;
    for (int q = 0; q < n_cta; ++q) v = fmaf(cluster.map_shared_rank(cpart, q)[h], stat[q], v);
    cv[(size_t)b * H + h] = v / D;
  }
  // done reading the peers; no CTA leaves before every peer is done with it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  for (int c = threadIdx.x; c < c1 - c0; c += kThreads) w_row[c] = expf(sraw[c] - M) / D;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <class T, int N>
cudaError_t launch(const T* ctx, const float* mask, const T* attn, float* cv, float* w,
                   int B, int L, int H, int ctas, bool vec, cudaStream_t stream) {
  const int per_cta = (L + ctas - 1) / ctas;
  size_t smem = sizeof(float) * partial_floats(H);
  const bool scores_in_smem = smem + sizeof(float) * per_cta <= c2v::kMaxSmem;
  if (scores_in_smem) smem += sizeof(float) * per_cta;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas == 1) {  // a row of one CTA needs no cluster
    pool_kernel<T, N><<<dim3(1, B), kThreads, smem, stream>>>(ctx, mask, attn, cv, w, L, H,
                                                              per_cta, vec, scores_in_smem);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pool_kernel<T, N>, ctx, mask, attn, cv, w, L, H, per_cta,
                            vec, scores_in_smem);
}

// K1b: the pool's backward, the closed-form softmax VJP over the saved
// weights that the JAX package leaves to XLA (_pool_bwd,
// code2vec_tpu/ops/pallas_attention.py:224-250). In: ctx [B, L, H] and a
// [H], both f32 or both bf16, mask [B, L], the forward's w [B, L], g_cv
// [B, H], g_w [B, L] or null (all f32). Out: d_ctx [B, L, H] in ctx's dtype (bf16
// rounded to nearest even, as :247 casts; the arithmetic is f32 on the
// widened contexts) and d_attn_part [B * S, H] f32, one partial of
// d_attn = sum_{b,l} ds ctx per CTA, which the caller sums in a fixed
// order (no float atomics, so a call is bitwise repeatable).
//
//   dldw_l = <g_cv, ctx_l> + g_w_l,   T = sum_l w_l dldw_l,
//   ds_l = w_l (dldw_l - T) mask_l,   d_ctx_l = w_l g_cv + ds_l a.
//
// Bound: bytes (ctx read once, d_ctx written once). Grid and cluster as
// K1: S CTAs per row (pool_ctas), one cluster per row when S > 1. Pass 1
// streams the CTA's share of the bag into registers (in_flight(N)
// contexts a warp), keeps dldw per context and, where it fits, the rows
// themselves in shared memory, and folds the CTA's part of T; the
// cluster's CTAs add their parts in rank order through DSMEM, so every
// CTA holds the same T. Pass 2 writes d_ctx and accumulates the CTA's
// d_attn partial from the kept rows (re-read from ctx when they did not
// fit).
template <int N>
__device__ __forceinline__ void load_shared_slices(const float* row, int H, bool vec, int lane,
                                                   float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (vec) {
      x[k] = e < H ? *reinterpret_cast<const float4*>(row + e) : make_float4(0, 0, 0, 0);
    } else {
      x[k].x = e < H ? row[e] : 0.f;
      x[k].y = e + 1 < H ? row[e + 1] : 0.f;
      x[k].z = e + 2 < H ? row[e + 2] : 0.f;
      x[k].w = e + 3 < H ? row[e + 3] : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ float dot_slices(const float4 (&x)[N], const float4 (&y)[N]) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v = fmaf(x[k].x, y[k].x, v);
    v = fmaf(x[k].y, y[k].y, v);
    v = fmaf(x[k].z, y[k].z, v);
    v = fmaf(x[k].w, y[k].w, v);
  }
  return v;
}

// Floats of shared memory before dldw: kWarps d_attn partials [H] and the
// T partials (kWarps warps, the CTA's, the row's), rounded to float4s.
__host__ __device__ constexpr size_t bwd_head_floats(int H) {
  return (size_t)kWarps * ((H + 3) / 4 * 4) + 12;
}

template <class T, int N>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(
    const T* __restrict__ ctx, const float* __restrict__ mask, const T* __restrict__ attn,
    const float* __restrict__ w, const float* __restrict__ g_cv, const float* __restrict__ g_w,
    T* __restrict__ d_ctx, float* __restrict__ d_attn_part, int L, int H, int per_cta, bool vec,
    bool keep_rows) {
  constexpr int U = in_flight(N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int hs = (H + 3) / 4 * 4;  // row stride of the shared partials and kept rows
  extern __shared__ __align__(16) float bwd_smem[];
  float* part = bwd_smem;                                // [kWarps][hs] d_attn partials
  float* stat = part + (size_t)kWarps * hs;              // [kWarps] warps' T, CTA's, row's
  float* dl = bwd_smem + bwd_head_floats(H);             // [per_cta] dldw
  float* rows = dl + (per_cta + 3) / 4 * 4;              // [per_cta][hs] kept contexts, f32
  const int c0 = min(L, rank * per_cta), c1 = min(L, c0 + per_cta);
  const size_t row0 = (size_t)b * L;

  float4 gv[N];
  load_slices<float, N>(g_cv + (size_t)b * H, H, vec, lane, gv);
  float t = 0.f;  // the same in every lane
  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    float4 x[U][N];
    load_contexts<T, U, N>(ctx, row0, cb, c1 - 1, H, vec, lane, x);
    const bool mine = lane < U && cb + lane < c1;
    const float w_lane = mine ? __ldg(w + row0 + cb + lane) : 0.f;
    const float gw_lane = mine && g_w ? __ldg(g_w + row0 + cb + lane) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float d = c2v::warp_sum(dot_slices<N>(x[u], gv)) +
                      __shfl_sync(0xffffffffu, gw_lane, u);
      if (cb + u < c1) {
        t = fmaf(__shfl_sync(0xffffffffu, w_lane, u), d, t);
        if (lane == 0) dl[cb + u - c0] = d;
        if (keep_rows) store_slices<float, N>(rows + (size_t)(cb + u - c0) * hs, H, lane, x[u]);
      }
    }
  }
  if (lane == 0) stat[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tc = 0.f;
    for (int q = 0; q < kWarps; ++q) tc += stat[q];
    stat[kWarps] = tc;
    stat[kWarps + 1] = tc;
  }
  if (n_cta > 1) {
    cluster.sync();
    if (threadIdx.x == 0) {
      float tr = 0.f;
      for (int q = 0; q < n_cta; ++q) tr += cluster.map_shared_rank(stat, q)[kWarps];
      stat[kWarps + 1] = tr;
    }
    // done reading the peers; no CTA leaves before every peer is done with it
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  __syncthreads();
  const float t_row = stat[kWarps + 1];  // T

  float4 a[N], acc[N];
  load_slices<T, N>(attn, H, vec, lane, a);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = make_float4(0, 0, 0, 0);
  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    float4 x[U][N];
    if (keep_rows) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_shared_slices<N>(rows + (size_t)(min(cb + u, c1 - 1) - c0) * hs, H, vec, lane, x[u]);
      }
    } else {
      load_contexts<T, U, N>(ctx, row0, cb, c1 - 1, H, vec, lane, x);
    }
    const bool mine = lane < U && cb + lane < c1;
    const float w_lane = mine ? __ldg(w + row0 + cb + lane) : 0.f;
    const float m_lane = mine ? __ldg(mask + row0 + cb + lane) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cb + u >= c1) break;  // uniform over the warp
      const float wl = __shfl_sync(0xffffffffu, w_lane, u);
      const float ds = wl * (dl[cb + u - c0] - t_row) * __shfl_sync(0xffffffffu, m_lane, u);
      float4 y[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        y[k] = make_float4(fmaf(ds, a[k].x, wl * gv[k].x), fmaf(ds, a[k].y, wl * gv[k].y),
                           fmaf(ds, a[k].z, wl * gv[k].z), fmaf(ds, a[k].w, wl * gv[k].w));
        acc[k].x = fmaf(ds, x[u][k].x, acc[k].x);
        acc[k].y = fmaf(ds, x[u][k].y, acc[k].y);
        acc[k].z = fmaf(ds, x[u][k].z, acc[k].z);
        acc[k].w = fmaf(ds, x[u][k].w, acc[k].w);
      }
      T* out = d_ctx + (row0 + cb + u) * H;
      if (vec) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int e = 4 * (lane + 32 * k);
          if (e < H) store4(out + e, y[k]);
        }
      } else {
        store_slices<T, N>(out, H, lane, y);
      }
    }
  }
  store_slices<float, N>(part + (size_t)warp * hs, H, lane, acc);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += part[(size_t)q * hs + h];
    d_attn_part[((size_t)b * n_cta + rank) * H + h] = v;
  }
  if (n_cta > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <class T, int N>
cudaError_t launch_bwd(const T* ctx, const float* mask, const T* attn, const float* w,
                       const float* g_cv, const float* g_w, T* d_ctx, float* d_attn_part, int B,
                       int L, int H, int ctas, bool vec, cudaStream_t stream) {
  const int per_cta = (L + ctas - 1) / ctas;
  const int hs = (H + 3) / 4 * 4;
  size_t smem = sizeof(float) * (bwd_head_floats(H) + (size_t)(per_cta + 3) / 4 * 4);
  if (smem > c2v::kMaxSmem) return cudaErrorInvalidValue;
  const bool keep_rows = smem + sizeof(float) * (size_t)per_cta * hs <= c2v::kMaxSmem;
  if (keep_rows) smem += sizeof(float) * (size_t)per_cta * hs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas == 1) {
    pool_bwd_kernel<T, N><<<dim3(1, B), kThreads, smem, stream>>>(
        ctx, mask, attn, w, g_cv, g_w, d_ctx, d_attn_part, L, H, per_cta, vec, keep_rows);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pool_bwd_kernel<T, N>, ctx, mask, attn, w, g_cv, g_w, d_ctx,
                            d_attn_part, L, H, per_cta, vec, keep_rows);
}

// Vector loads need H % 4 == 0 and every vector-read row aligned to its
// four elements: 16 bytes for f32, 8 for bf16 contexts.
template <class T>
bool aligned4(const T* p) {
  return (uintptr_t)p % (4 * sizeof(T)) == 0;
}

// The launch of N slices a lane for H: (H + 127) / 128 slices, 8 above 4.
template <class F>
cudaError_t with_slices(int H, F f) {
  switch ((H + 127) / 128) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 8>());
  }
}

template <class T>
int pool_backward(const T* ctx, const float* mask, const T* attn, const float* w,
                  const float* g_cv, const float* g_w, T* d_ctx, float* d_attn_part, int B, int L,
                  int H, int ctas, cudaStream_t s) {
  const bool vec = H % 4 == 0 && aligned4(ctx) && aligned4(attn) && aligned4(g_cv) &&
                   aligned4(d_ctx);
  const cudaError_t err = with_slices(H, [&](auto n) {
    return launch_bwd<T, decltype(n)::value>(ctx, mask, attn, w, g_cv, g_w, d_ctx, d_attn_part,
                                             B, L, H, ctas, vec, s);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T>
int pool_forward(const T* ctx, const float* mask, const T* attn, float* cv, float* w, int B,
                 int L, int H, int ctas, cudaStream_t s) {
  const bool vec = H % 4 == 0 && aligned4(ctx) && aligned4(attn);
  const cudaError_t err = with_slices(H, [&](auto n) {
    return launch<T, decltype(n)::value>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launch K1b on `stream`: `ctas` CTAs (one cluster) per batch row, as K1.
// ctx_dtype: 0 = f32, 1 = bf16 (ctx, attn and d_ctx); g_w may be null.
// d_attn_part is [B * ctas, H] f32. Returns a cudaError_t, or the negated
// code of an error already pending before the launch.
int c2v_pool_backward(int ctx_dtype, const void* ctx, const float* mask, const void* attn,
                      const float* w, const float* g_cv, const float* g_w, void* d_ctx,
                      float* d_attn_part, int B, int L, int H, int ctas, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 128 * kMaxSlices || ctas < 1 ||
      ctas > kMaxCluster || (ctx_dtype != 0 && ctx_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctx_dtype == 1) {
    return pool_backward((const bf16*)ctx, mask, (const bf16*)attn, w, g_cv, g_w, (bf16*)d_ctx,
                         d_attn_part, B, L, H, ctas, s);
  }
  return pool_backward((const float*)ctx, mask, (const float*)attn, w, g_cv, g_w, (float*)d_ctx,
                       d_attn_part, B, L, H, ctas, s);
}

// Launch K1 on `stream`: one kernel, `ctas` CTAs (one cluster) per batch
// row; ctx_dtype: 0 = f32, 1 = bf16 (ctx and attn). Returns a cudaError_t,
// or the negated code of an error already pending before the launch.
int c2v_pool_forward(int ctx_dtype, const void* ctx, const float* mask, const void* attn,
                     float* cv, float* w, int B, int L, int H, int ctas, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 128 * kMaxSlices || ctas < 1 ||
      ctas > kMaxCluster || (ctx_dtype != 0 && ctx_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctx_dtype == 1) {
    return pool_forward((const bf16*)ctx, mask, (const bf16*)attn, cv, w, B, L, H, ctas, s);
  }
  return pool_forward((const float*)ctx, mask, (const float*)attn, cv, w, B, L, H, ctas, s);
}

}  // extern "C"
