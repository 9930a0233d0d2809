// K1: masked attention pool over encoded contexts; K1b, its backward
// (below pool_kernel).
//
// Replaces code2vec_tpu/ops/pallas_attention.py:_forward (pl.pallas_call
// at :114, kernel _make_kernel :63, body _tile_pool :38), the kernel of
// pallas_impl="pool_only". In: ctx [B, L, H] f32, mask [B, L] f32,
// a [H] f32. Out: cv [B, H] f32, w [B, L] f32.
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
//   16-byte loads when H % 4 == 0 and scalar loads otherwise. It scores
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
#include <stdint.h>

#include "pool.cuh"

namespace cg = cooperative_groups;

namespace {

using c2v::kNinf;

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

// Lane `lane`'s N float4 slices of a row of H floats: slice k holds
// elements 4 * (lane + 32 k) .. + 3, zero past H.
template <int N>
__device__ __forceinline__ void load_slices(const float* __restrict__ row, int H, bool vec,
                                            int lane, float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (vec) {
      x[k] = e < H ? __ldg(reinterpret_cast<const float4*>(row + e)) : make_float4(0, 0, 0, 0);
    } else {
      x[k].x = e < H ? __ldg(row + e) : 0.f;
      x[k].y = e + 1 < H ? __ldg(row + e + 1) : 0.f;
      x[k].z = e + 2 < H ? __ldg(row + e + 2) : 0.f;
      x[k].w = e + 3 < H ? __ldg(row + e + 3) : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_slices(float* row, int H, int lane, const float4 (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int e = 4 * (lane + 32 * k);
    if (e < H) row[e] = x[k].x;
    if (e + 1 < H) row[e + 1] = x[k].y;
    if (e + 2 < H) row[e + 2] = x[k].z;
    if (e + 3 < H) row[e + 3] = x[k].w;
  }
}

// exp(m - M), 0 for a partial that folded nothing (m = -inf).
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <int N>
__global__ void __launch_bounds__(kThreads) pool_kernel(
    const float* __restrict__ ctx, const float* __restrict__ mask, const float* __restrict__ attn,
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
  load_slices<N>(attn, H, vec, lane, a);
  const float* row_mask = mask + (size_t)b * L;
  float m = -INFINITY, d = 0.f;
  float4 acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = make_float4(0, 0, 0, 0);

  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    // every load of the step is issued before any is used
    // (a slot past the CTA's share reloads its last context and scores -inf)
    float4 x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_slices<N>(ctx + ((size_t)b * L + min(cb + u, c1 - 1)) * H, H, vec, lane, x[u]);
    }
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
  store_slices<N>(mine, H, lane, acc);
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

template <int N>
cudaError_t launch(const float* ctx, const float* mask, const float* attn, float* cv, float* w,
                   int B, int L, int H, int ctas, bool vec, cudaStream_t stream) {
  const int per_cta = (L + ctas - 1) / ctas;
  size_t smem = sizeof(float) * partial_floats(H);
  const bool scores_in_smem = smem + sizeof(float) * per_cta <= c2v::kMaxSmem;
  if (scores_in_smem) smem += sizeof(float) * per_cta;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas == 1) {  // a row of one CTA needs no cluster
    pool_kernel<N><<<dim3(1, B), kThreads, smem, stream>>>(ctx, mask, attn, cv, w, L, H,
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
  return cudaLaunchKernelEx(&cfg, pool_kernel<N>, ctx, mask, attn, cv, w, L, H, per_cta, vec,
                            scores_in_smem);
}

// K1b: the pool's backward, the closed-form softmax VJP over the saved
// weights that the JAX package leaves to XLA (_pool_bwd,
// code2vec_tpu/ops/pallas_attention.py:224-250). In: ctx [B, L, H], mask
// [B, L], a [H], the forward's w [B, L], g_cv [B, H], g_w [B, L] or null.
// Out: d_ctx [B, L, H] and d_attn_part [B * S, H], one partial of
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

template <int N>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(
    const float* __restrict__ ctx, const float* __restrict__ mask, const float* __restrict__ attn,
    const float* __restrict__ w, const float* __restrict__ g_cv, const float* __restrict__ g_w,
    float* __restrict__ d_ctx, float* __restrict__ d_attn_part, int L, int H, int per_cta,
    bool vec, bool keep_rows) {
  constexpr int U = in_flight(N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int hs = (H + 3) / 4 * 4;  // row stride of the shared partials and kept rows
  extern __shared__ __align__(16) float bwd_smem[];
  float* part = bwd_smem;                                // [kWarps][hs] d_attn partials
  float* stat = part + (size_t)kWarps * hs;              // [kWarps] warps' T, CTA's, row's
  float* dl = bwd_smem + bwd_head_floats(H);             // [per_cta] dldw
  float* rows = dl + (per_cta + 3) / 4 * 4;              // [per_cta][hs] kept contexts
  const int c0 = min(L, rank * per_cta), c1 = min(L, c0 + per_cta);
  const size_t row0 = (size_t)b * L;

  float4 gv[N];
  load_slices<N>(g_cv + (size_t)b * H, H, vec, lane, gv);
  float t = 0.f;  // the same in every lane
  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    float4 x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_slices<N>(ctx + (row0 + min(cb + u, c1 - 1)) * H, H, vec, lane, x[u]);
    }
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
        if (keep_rows) store_slices<N>(rows + (size_t)(cb + u - c0) * hs, H, lane, x[u]);
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
  const float T = stat[kWarps + 1];

  float4 a[N], acc[N];
  load_slices<N>(attn, H, vec, lane, a);
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = make_float4(0, 0, 0, 0);
  for (int cb = c0 + warp * U; cb < c1; cb += kWarps * U) {
    float4 x[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = min(cb + u, c1 - 1);
      if (keep_rows) {
        load_shared_slices<N>(rows + (size_t)(c - c0) * hs, H, vec, lane, x[u]);
      } else {
        load_slices<N>(ctx + (row0 + c) * H, H, vec, lane, x[u]);
      }
    }
    const bool mine = lane < U && cb + lane < c1;
    const float w_lane = mine ? __ldg(w + row0 + cb + lane) : 0.f;
    const float m_lane = mine ? __ldg(mask + row0 + cb + lane) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cb + u >= c1) break;  // uniform over the warp
      const float wl = __shfl_sync(0xffffffffu, w_lane, u);
      const float ds = wl * (dl[cb + u - c0] - T) * __shfl_sync(0xffffffffu, m_lane, u);
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
      float* out = d_ctx + (row0 + cb + u) * H;
      if (vec) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int e = 4 * (lane + 32 * k);
          if (e < H) *reinterpret_cast<float4*>(out + e) = y[k];
        }
      } else {
        store_slices<N>(out, H, lane, y);
      }
    }
  }
  store_slices<N>(part + (size_t)warp * hs, H, lane, acc);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += part[(size_t)q * hs + h];
    d_attn_part[((size_t)b * n_cta + rank) * H + h] = v;
  }
  if (n_cta > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int N>
cudaError_t launch_bwd(const float* ctx, const float* mask, const float* attn, const float* w,
                       const float* g_cv, const float* g_w, float* d_ctx, float* d_attn_part,
                       int B, int L, int H, int ctas, bool vec, cudaStream_t stream) {
  const int per_cta = (L + ctas - 1) / ctas;
  const int hs = (H + 3) / 4 * 4;
  size_t smem = sizeof(float) * (bwd_head_floats(H) + (size_t)(per_cta + 3) / 4 * 4);
  if (smem > c2v::kMaxSmem) return cudaErrorInvalidValue;
  const bool keep_rows = smem + sizeof(float) * (size_t)per_cta * hs <= c2v::kMaxSmem;
  if (keep_rows) smem += sizeof(float) * (size_t)per_cta * hs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas == 1) {
    pool_bwd_kernel<N><<<dim3(1, B), kThreads, smem, stream>>>(
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
  return cudaLaunchKernelEx(&cfg, pool_bwd_kernel<N>, ctx, mask, attn, w, g_cv, g_w, d_ctx,
                            d_attn_part, L, H, per_cta, vec, keep_rows);
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launch K1b on `stream`: `ctas` CTAs (one cluster) per batch row, as K1.
// g_w may be null. d_attn_part is [B * ctas, H]. Returns a cudaError_t, or
// the negated code of an error already pending before the launch.
int c2v_pool_backward(const float* ctx, const float* mask, const float* attn, const float* w,
                      const float* g_cv, const float* g_w, float* d_ctx, float* d_attn_part,
                      int B, int L, int H, int ctas, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 128 * kMaxSlices || ctas < 1 ||
      ctas > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const bool vec = H % 4 == 0 && (uintptr_t)ctx % 16 == 0 && (uintptr_t)attn % 16 == 0 &&
                   (uintptr_t)g_cv % 16 == 0 && (uintptr_t)d_ctx % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define C2V_BWD(n) \
  launch_bwd<n>(ctx, mask, attn, w, g_cv, g_w, d_ctx, d_attn_part, B, L, H, ctas, vec, s)
  switch ((H + 127) / 128) {
    case 1: err = C2V_BWD(1); break;
    case 2: err = C2V_BWD(2); break;
    case 3: err = C2V_BWD(3); break;
    case 4: err = C2V_BWD(4); break;
    default: err = C2V_BWD(8); break;
  }
#undef C2V_BWD
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch K1 on `stream`: one kernel, `ctas` CTAs (one cluster) per batch
// row. Returns a cudaError_t, or the negated code of an error already
// pending before the launch.
int c2v_pool_forward(const float* ctx, const float* mask, const float* attn, float* cv,
                     float* w, int B, int L, int H, int ctas, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 128 * kMaxSlices || ctas < 1 ||
      ctas > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const bool vec = H % 4 == 0 && (uintptr_t)ctx % 16 == 0 && (uintptr_t)attn % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch ((H + 127) / 128) {
    case 1: err = launch<1>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s); break;
    case 2: err = launch<2>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s); break;
    case 3: err = launch<3>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s); break;
    case 4: err = launch<4>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s); break;
    default: err = launch<8>(ctx, mask, attn, cv, w, B, L, H, ctas, vec, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
