// K1: masked attention pool over encoded contexts.
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

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

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
