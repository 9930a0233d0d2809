// K1: masked attention pool over encoded contexts; K1b, its backward
// (below pool_kernel, one streaming pass on a grid of its own).
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
// [H], both f32 or both bf16, mask [B, L], the forward's w [B, L] and code
// vector cv [B, H], g_cv [B, H], g_w [B, L] or null (all f32). Out: d_ctx
// [B, L, H] in ctx's dtype (bf16 rounded to nearest even, as :247 casts;
// the arithmetic is f32 on the widened contexts) and d_attn = sum_{b,l}
// ds ctx [H] f32, added from one partial a CTA in a fixed order (no float
// atomics, so a call is bitwise repeatable).
//
//   dldw_l = <g_cv, ctx_l> + g_w_l,   ds_l = w_l (dldw_l - T) mask_l,
//   d_ctx_l = w_l g_cv + ds_l a,      d_attn += ds_l ctx_l,
//
// with the row's T = sum_l w_l dldw_l taken from the forward's code vector
// (cv = sum_l w_l ctx_l): T = <g_cv, cv> + <w, g_w>, the D = rowsum(dO o O)
// step of FlashAttention-2's backward. T needs no pass over the contexts,
// so each context is read once and its d_ctx written in the same step.
// <g_cv, cv> is summed exactly as <g_cv, ctx_l> is (the same lanes, the
// same warp sum), so a one-context row gets ds = 0 exactly, as the JAX
// formulation does.
//
// Bound on an H100: bytes (ctx read once, d_ctx written once; 7 flops an
// element). Design, one launch per call:
//
// - a task is U = in_flight(N) consecutive contexts of one row; the
//   B * ceil(L / U) tasks are cut into G * kWarps contiguous runs, one per
//   warp of a persistent grid of G CTAs (bwd_grid: as many as the card
//   holds at once, fewer when the work runs out), a static assignment;
// - the registers a thread may use: 128 up to N = 2 (H <= 256), so two
//   CTAs fit an SM; above that the slices, the contexts in flight and
//   the accumulators outgrow 128 and spill, so the cap is lifted there
//   and the grid holds as many CTAs as then fit (bwd_min_ctas);
// - each warp streams its tasks through its own ring of kBwdStages
//   shared-memory stages with cp.async in the widest pieces the task's
//   byte range allows (16 bytes at top11 widths), two tasks ahead of the
//   one it computes: ~100 KB (f32) or ~50 KB (bf16) of loads in flight per
//   SM at top11 widths. Deeper rings measured slower on the H100 (the
//   queue grows, not the rate). A stage holds the task's contexts as
//   stored (bf16 stays bf16 and is widened in registers) and their w,
//   mask and g_w;
// - the warp computes a task's d_ctx in registers, writes it back over the
//   stage in ctx's dtype and copies the stage out with 16-byte stores (8
//   bf16 values a store); d_attn accumulates in registers across all of
//   the warp's tasks;
// - before its first task a CTA computes T and g_cv of the rows its runs
//   touch (up to row_cap of them, kBwdRowBytes of shared memory; H + 2L
//   floats a row), its loads issued just before the warps' first copies
//   (behind them they queue, measured slower), so a warp
//   that enters a new row reads them from shared memory (a row past the
//   table, only on a long run of short bags, is computed by the warp);
//   after that barrier no warp waits on another until the end;
// - each CTA adds its warps' d_attn partials in warp order and writes the
//   sum to d_attn_part; the last CTA to finish (a ticket, reset for the
//   next launch) adds the CTAs' partials in a fixed order into d_attn, 16
//   independent loads in flight a thread, so the call needs no second
//   kernel.
constexpr int kBwdStages = 3;
__host__ __device__ constexpr int bwd_min_ctas(int n) { return n >= 3 ? 1 : 2; }
constexpr size_t kBwdRowBytes = 8 * 1024;  // a CTA's row table (T and g_cv)
constexpr int kBwdMaxRows = 16;
constexpr int kSumBatch = 16;  // loads in flight a thread in the last CTA's sum

// Bytes of one stage: U contexts as stored (rounded up to 16), then the
// w, mask and g_w of those U contexts.
__host__ __device__ constexpr size_t bwd_ctx_bytes(int U, int H, int item) {
  return ((size_t)U * H * item + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t bwd_stage_bytes(int U, int H, int item) {
  return bwd_ctx_bytes(U, H, item) + ((size_t)3 * U * sizeof(float) + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The widest piece (16, 8, 4 or 2 bytes) that a byte range starting at p
// of `bytes` bytes splits into, each piece aligned to its size.
__device__ __forceinline__ int piece_bytes(const void* p, size_t bytes) {
  const uintptr_t a = (uintptr_t)p | (uintptr_t)bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

// A warp copies `bytes` bytes of global memory into a 16-byte aligned
// shared stage with cp.async (a range only 2-byte aligned, bf16 at an odd
// H, with plain loads and stores).
__device__ __forceinline__ void copy_in(unsigned char* dst, const unsigned char* src, size_t bytes,
                                        int lane) {
  const int g = piece_bytes(src, bytes);
  if (g == 16) {
    for (size_t i = 16 * lane; i < bytes; i += 16 * 32) cp_async16(dst + i, src + i);
  } else if (g == 8) {
    for (size_t i = 8 * lane; i < bytes; i += 8 * 32) cp_async8(dst + i, src + i);
  } else if (g == 4) {
    for (size_t i = 4 * lane; i < bytes; i += 4 * 32) cp_async4(dst + i, src + i);
  } else {
    for (size_t i = 2 * lane; i < bytes; i += 2 * 32) {
      *reinterpret_cast<unsigned short*>(dst + i) =
          __ldg(reinterpret_cast<const unsigned short*>(src + i));
    }
  }
}

// A warp copies a shared stage out to global memory in the widest pieces
// the destination allows.
__device__ __forceinline__ void copy_out(unsigned char* dst, const unsigned char* src, size_t bytes,
                                         int lane) {
  const int g = piece_bytes(dst, bytes);
  if (g == 16) {
    for (size_t i = 16 * lane; i < bytes; i += 16 * 32) {
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
    }
  } else if (g == 8) {
    for (size_t i = 8 * lane; i < bytes; i += 8 * 32) {
      *reinterpret_cast<uint2*>(dst + i) = *reinterpret_cast<const uint2*>(src + i);
    }
  } else if (g == 4) {
    for (size_t i = 4 * lane; i < bytes; i += 4 * 32) {
      *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(src + i);
    }
  } else {
    for (size_t i = 2 * lane; i < bytes; i += 2 * 32) {
      *reinterpret_cast<unsigned short*>(dst + i) =
          *reinterpret_cast<const unsigned short*>(src + i);
    }
  }
}

// Lane `lane`'s N float4 slices (as load_slices) of a context in shared
// memory, widened: 16-byte (f32) or 8-byte (bf16) reads when H % 4 == 0.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float lds1(const float* p) { return *p; }
__device__ __forceinline__ float lds1(const bf16* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}
template <class T, int N>
__device__ __forceinline__ void load_smem_slices(const T* row, int H, bool vec, int lane,
                                                 float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (vec) {
      x[k] = e < H ? lds4(row + e) : make_float4(0, 0, 0, 0);
    } else {
      x[k].x = e < H ? lds1(row + e) : 0.f;
      x[k].y = e + 1 < H ? lds1(row + e + 1) : 0.f;
      x[k].z = e + 2 < H ? lds1(row + e + 2) : 0.f;
      x[k].w = e + 3 < H ? lds1(row + e + 3) : 0.f;
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

// Row b's T = <g_cv, cv> + <w, g_w> (the same in every lane) and the
// lane's slices of g_cv, in two steps: start() issues the loads of g_cv,
// cv and the lane's first kRowPre values of w and g_w, finish() adds them
// up (and the rest of the bag), so other loads can be issued in between.
// <g_cv, cv> is summed as K1b sums <g_cv, ctx_l>; <w, g_w> in bag order.
constexpr int kRowPre = 8;
template <int N>
struct RowTerm {
  float4 gv[N], cvs[N];
  float wv[kRowPre], gwv[kRowPre];

  __device__ __forceinline__ void start(const float* __restrict__ cv,
                                        const float* __restrict__ g_cv,
                                        const float* __restrict__ w,
                                        const float* __restrict__ g_w, int b, int L, int H,
                                        bool vec, int lane) {
    load_slices<float, N>(g_cv + (size_t)b * H, H, vec, lane, gv);
    load_slices<float, N>(cv + (size_t)b * H, H, vec, lane, cvs);
    const size_t r0 = (size_t)b * L;
#pragma unroll
    for (int j = 0; j < kRowPre; ++j) {
      const int l = lane + 32 * j;
      wv[j] = g_w && l < L ? __ldg(w + r0 + l) : 0.f;
      gwv[j] = g_w && l < L ? __ldg(g_w + r0 + l) : 0.f;
    }
  }

  __device__ __forceinline__ float finish(const float* __restrict__ w,
                                          const float* __restrict__ g_w, int b, int L,
                                          int lane) const {
    float wg = 0.f;
    if (g_w) {
#pragma unroll
      for (int j = 0; j < kRowPre; ++j) wg = fmaf(wv[j], gwv[j], wg);
      const size_t r0 = (size_t)b * L;
#pragma unroll 8
      for (int l = lane + 32 * kRowPre; l < L; l += 32) {
        wg = fmaf(__ldg(w + r0 + l), __ldg(g_w + r0 + l), wg);
      }
    }
    return c2v::warp_sum(dot_slices<N>(cvs, gv)) + c2v::warp_sum(wg);
  }
};

template <class T, int N>
__global__ void __launch_bounds__(kThreads, bwd_min_ctas(N)) pool_bwd_kernel(
    const T* __restrict__ ctx, const float* __restrict__ mask, const T* __restrict__ attn,
    const float* __restrict__ w, const float* __restrict__ cv, const float* __restrict__ g_cv,
    const float* __restrict__ g_w, T* __restrict__ d_ctx, float* __restrict__ d_attn_part,
    float* __restrict__ d_attn, unsigned int* __restrict__ ticket, int B, int L, int H,
    int row_cap, bool vec) {
  constexpr int U = in_flight(N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hs = (H + 3) / 4 * 4;  // row stride of the shared g_cv rows
  extern __shared__ __align__(16) unsigned char bwd_ring[];
  __shared__ bool last_cta;
  const size_t ctx_bytes = bwd_ctx_bytes(U, H, sizeof(T));
  const size_t stage = bwd_stage_bytes(U, H, sizeof(T));
  unsigned char* ring = bwd_ring + (size_t)warp * kBwdStages * stage;
  float* row_t = reinterpret_cast<float*>(bwd_ring + (size_t)kWarps * kBwdStages * stage);
  float* row_g = row_t + (row_cap + 3) / 4 * 4;  // [row_cap][hs]

  // this warp's run of tasks [t0, t1)
  const int per_row = (L + U - 1) / U;
  const unsigned long long tasks = (unsigned long long)B * per_row;
  const unsigned long long n_warps = (unsigned long long)gridDim.x * kWarps;
  const unsigned long long me = (unsigned long long)blockIdx.x * kWarps + warp;
  const long long t0 = (long long)(tasks * me / n_warps);
  const long long t1 = (long long)(tasks * (me + 1) / n_warps);
  // the CTA's runs [c0, c1) touch rows r_lo .. ; the first `staged` go to the table
  const unsigned long long first = (unsigned long long)blockIdx.x * kWarps;
  const long long c0 = (long long)(tasks * first / n_warps);
  const long long c1 = (long long)(tasks * (first + kWarps) / n_warps);
  const int r_lo = (int)(c0 / per_row);
  const int staged = c1 > c0 ? min(row_cap, (int)((c1 - 1) / per_row) - r_lo + 1) : 0;

  // start task t's copies into stage `slot` (an empty group past the run)
  auto issue = [&](long long t, int slot) {
    if (t < t1) {
      const int b = (int)(t / per_row), l0 = (int)(t % per_row) * U, n = min(U, L - l0);
      const size_t r = (size_t)b * L + l0;
      unsigned char* st = ring + (size_t)slot * stage;
      copy_in(st, reinterpret_cast<const unsigned char*>(ctx + r * H), (size_t)n * H * sizeof(T),
              lane);
      float* f = reinterpret_cast<float*>(st + ctx_bytes);
      if (lane < n) {
        cp_async4(f + lane, w + r + lane);
        cp_async4(f + U + lane, mask + r + lane);
        if (g_w) cp_async4(f + 2 * U + lane, g_w + r + lane);
      }
    }
    cp_async_commit();
  };

  float4 a[N], gv[N], acc[N];  // gv: g_cv slices of `row`
  load_slices<T, N>(attn, H, vec, lane, a);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = make_float4(0, 0, 0, 0);
  int row = -1;
  float t_row = 0.f;  // T of `row`, the same in every lane
  // the row table: each warp's first row issued before the first copies,
  // added up after them; the rest (more than kWarps rows) after that
  RowTerm<N> rt;
  if (warp < staged) rt.start(cv, g_cv, w, g_w, r_lo + warp, L, H, vec, lane);
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) issue(t0 + s, s);
  for (int j = warp; j < staged; j += kWarps) {
    if (j != warp) rt.start(cv, g_cv, w, g_w, r_lo + j, L, H, vec, lane);
    const float tj = rt.finish(w, g_w, r_lo + j, L, lane);
    store_slices<float, N>(row_g + (size_t)j * hs, H, lane, rt.gv);
    if (lane == 0) row_t[j] = tj;
  }
  __syncthreads();

  for (long long t = t0; t < t1; ++t) {
    const int i = (int)(t - t0);
    __syncwarp();  // every lane is done with the stage refilled next
    issue(t + kBwdStages - 1, (i + kBwdStages - 1) % kBwdStages);
    const int b = (int)(t / per_row), l0 = (int)(t % per_row) * U, n = min(U, L - l0);
    if (b != row) {
      row = b;
      if (b - r_lo < staged) {
        load_smem_slices<float, N>(row_g + (size_t)(b - r_lo) * hs, H, vec, lane, gv);
        t_row = row_t[b - r_lo];
      } else {
        rt.start(cv, g_cv, w, g_w, b, L, H, vec, lane);
        t_row = rt.finish(w, g_w, b, L, lane);
#pragma unroll
        for (int k = 0; k < N; ++k) gv[k] = rt.gv[k];
      }
    }
    cp_async_wait<kBwdStages - 1>();  // task t's group has landed
    __syncwarp();
    unsigned char* st = ring + (size_t)(i % kBwdStages) * stage;
    T* xs = reinterpret_cast<T*>(st);
    const float* f = reinterpret_cast<const float*>(st + ctx_bytes);
    float4 x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_smem_slices<T, N>(xs + (size_t)min(u, n - 1) * H, H, vec, lane, x[u]);
    }
    float dl[U];
#pragma unroll
    for (int u = 0; u < U; ++u) dl[u] = c2v::warp_sum(dot_slices<N>(x[u], gv));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= n) break;  // uniform over the warp
      const float wl = f[u];
      const float ds = wl * ((dl[u] + (g_w ? f[2 * U + u] : 0.f)) - t_row) * f[U + u];
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
      // d_ctx over the context it came from: each lane rewrites its own slices
      T* out = xs + (size_t)u * H;
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
    __syncwarp();
    copy_out(reinterpret_cast<unsigned char*>(d_ctx + ((size_t)b * L + l0) * H), st,
             (size_t)n * H * sizeof(T), lane);
  }

  // the warps' d_attn partials, each in its own ring, added in warp order
  cp_async_wait<0>();
  __syncwarp();
  store_slices<float, N>(reinterpret_cast<float*>(ring), H, lane, acc);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      v += reinterpret_cast<const float*>(bwd_ring + (size_t)q * kBwdStages * stage)[h];
    }
    d_attn_part[(size_t)blockIdx.x * H + h] = v;
  }

  // the last CTA to finish adds the CTAs' partials in CTA order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_cta = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  // thread (q, g) of kThreads = S x G sums column g (a float4 of columns
  // when vec, else one) over the partials of CTAs q, q + S, ..., batches of
  // kSumBatch loads issued before any is added; then the S sums of each
  // column are added in order q = 0 .. S - 1
  const int width = vec ? H / 4 : H;
  const int G = min(width, kThreads), S = kThreads / G;
  float4* red = reinterpret_cast<float4*>(bwd_ring);  // [S][G]
  const int q = threadIdx.x / G, g = threadIdx.x % G;
  const int n_part = (int)gridDim.x;
  for (int g0 = 0; g0 < width; g0 += G) {
    float4 sum = make_float4(0, 0, 0, 0);
    if (q < S && g0 + g < width) {
      for (int c0 = q; c0 < n_part; c0 += kSumBatch * S) {
        float4 x[kSumBatch];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) {
          const int c = c0 + j * S;
          const float* p = d_attn_part + (size_t)c * H;
          x[j] = c >= n_part ? make_float4(0, 0, 0, 0)
                 : vec       ? __ldcg(reinterpret_cast<const float4*>(p) + g0 + g)
                             : make_float4(__ldcg(p + g0 + g), 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) {
          sum.x += x[j].x;
          sum.y += x[j].y;
          sum.z += x[j].z;
          sum.w += x[j].w;
        }
      }
    }
    if (q < S) red[(size_t)q * G + g] = sum;
    __syncthreads();
    if (threadIdx.x < G && g0 + threadIdx.x < width) {
      float4 v = red[threadIdx.x];
      for (int r = 1; r < S; ++r) {
        const float4 y = red[(size_t)r * G + threadIdx.x];
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
      }
      if (vec) {
        reinterpret_cast<float4*>(d_attn)[g0 + threadIdx.x] = v;
      } else {
        d_attn[g0 + threadIdx.x] = v.x;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch on this stream
}

// K1b's shared memory for width H (rings, then the row table: row_cap T
// values rounded to 4, row_cap g_cv rows; the last CTA's sum reuses it
// all, kThreads float4s), with the kernel allowed to take it.
template <class T, int N>
cudaError_t bwd_smem(int H, size_t* smem, int* row_cap) {
  const size_t stage = bwd_stage_bytes(in_flight(N), H, sizeof(T));
  const size_t row_floats = (size_t)(H + 3) / 4 * 4 + 1;
  *row_cap = (int)min((size_t)kBwdMaxRows, kBwdRowBytes / (sizeof(float) * row_floats));
  *smem = max(sizeof(float4) * kThreads,
              (size_t)kWarps * kBwdStages * stage +
                  sizeof(float) * ((size_t)(*row_cap + 3) / 4 * 4 +
                                   (size_t)*row_cap * ((H + 3) / 4 * 4)));
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pool_bwd_kernel<T, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// K1b's persistent grid on the current device: one CTA per kWarps tasks,
// at most as many CTAs as its SMs hold at once (their registers and
// shared memory), so the grid is one wave.
template <class T, int N>
cudaError_t bwd_grid(int B, int L, int H, int* ctas, long long* tasks) {
  size_t smem;
  int row_cap, dev, sms, per_sm;
  cudaError_t err = bwd_smem<T, N>(H, &smem, &row_cap);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_bwd_kernel<T, N>, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *tasks = (long long)B * ((L + in_flight(N) - 1) / in_flight(N));
  *ctas = (int)max(1LL, min((*tasks + kWarps - 1) / kWarps, (long long)sms * per_sm));
  return cudaSuccess;
}

template <class T, int N>
cudaError_t launch_bwd(const T* ctx, const float* mask, const T* attn, const float* w,
                       const float* cv, const float* g_cv, const float* g_w, T* d_ctx,
                       float* d_attn_part, float* d_attn, unsigned int* ticket, int B, int L,
                       int H, int ctas, bool vec, cudaStream_t stream) {
  size_t smem;
  int row_cap;
  const cudaError_t err = bwd_smem<T, N>(H, &smem, &row_cap);
  if (err != cudaSuccess) return err;
  pool_bwd_kernel<T, N><<<ctas, kThreads, smem, stream>>>(
      ctx, mask, attn, w, cv, g_cv, g_w, d_ctx, d_attn_part, d_attn, ticket, B, L, H, row_cap,
      vec);
  return cudaSuccess;
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
int pool_backward(const T* ctx, const float* mask, const T* attn, const float* w, const float* cv,
                  const float* g_cv, const float* g_w, T* d_ctx, float* d_attn_part,
                  float* d_attn, unsigned int* ticket, int B, int L, int H, int ctas,
                  cudaStream_t s) {
  const bool vec = H % 4 == 0 && aligned4(attn) && aligned4(cv) && aligned4(g_cv) &&
                   aligned4(d_attn_part) && aligned4(d_attn);
  const cudaError_t err = with_slices(H, [&](auto n) {
    return launch_bwd<T, decltype(n)::value>(ctx, mask, attn, w, cv, g_cv, g_w, d_ctx,
                                             d_attn_part, d_attn, ticket, B, L, H, ctas, vec, s);
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

// K1b's persistent grid for a launch on the current device: `ctas` CTAs
// (the size of c2v_pool_backward's d_attn_part) over `tasks` tasks of a
// few contexts of one row. ctx_dtype as c2v_pool_backward's. Returns a
// cudaError_t.
int c2v_pool_backward_grid(int ctx_dtype, int B, int L, int H, int* ctas, long long* tasks) {
  if (B < 1 || L < 1 || H < 1 || H > 128 * kMaxSlices || (ctx_dtype != 0 && ctx_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)with_slices(H, [&](auto n) {
    return ctx_dtype == 1 ? bwd_grid<bf16, decltype(n)::value>(B, L, H, ctas, tasks)
                          : bwd_grid<float, decltype(n)::value>(B, L, H, ctas, tasks);
  });
}

// Launch K1b on `stream`: a persistent grid of `ctas` CTAs
// (c2v_pool_backward_grid).
// ctx_dtype: 0 = f32, 1 = bf16 (ctx, attn and d_ctx); cv is the forward's
// code vector; g_w may be null. d_attn_part is [ctas, H] f32 scratch,
// d_attn [H] f32; ticket is one zeroed unsigned int used by no other
// launch in flight (the kernel leaves it zeroed). Returns a cudaError_t,
// or the negated code of an error already pending before the launch.
int c2v_pool_backward(int ctx_dtype, const void* ctx, const float* mask, const void* attn,
                      const float* w, const float* cv, const float* g_cv, const float* g_w,
                      void* d_ctx, float* d_attn_part, float* d_attn, unsigned int* ticket,
                      int B, int L, int H, int ctas, void* stream) {
  if (B < 1 || L < 1 || H < 1 || H > 128 * kMaxSlices || ctas < 1 ||
      (ctx_dtype != 0 && ctx_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctx_dtype == 1) {
    return pool_backward((const bf16*)ctx, mask, (const bf16*)attn, w, cv, g_cv, g_w,
                         (bf16*)d_ctx, d_attn_part, d_attn, ticket, B, L, H, ctas, s);
  }
  return pool_backward((const float*)ctx, mask, (const float*)attn, w, cv, g_cv, g_w,
                       (float*)d_ctx, d_attn_part, d_attn, ticket, B, L, H, ctas, s);
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
