// Shared device code of the encode-pool kernels K2/K3/K4
// (fused_encode_pool.cu): they score, fold and finish a batch row's pool
// with these routines, as _pool_f32 is shared by the TPU kernels
// (code2vec_tpu/ops/fused_encode_pool.py:174). K1 (pool.cu) uses the
// constants and warp reductions; its own fold keeps the softmax state in
// registers.
//
// Semantics (code2vec_tpu/ops/attention.py): s = <enc_l, a>; a user-masked
// slot scores the FINITE sentinel NINF via s*m + (1-m)*NINF; softmax over
// the bag; cv = sum_l w_l enc_l. An all-masked row therefore gives uniform
// weights 1/L and cv = mean of the encoded rows, never NaN. The TPU
// kernels' hard -inf for lane padding has no counterpart here: nothing is
// padded, a chunk simply holds fewer than kChunk rows.
//
// The bag is split into chunks of kChunk contexts. Each chunk's CTA
// writes the chunk's own softmax partial to the workspace — max m_c,
// denominator d_c = sum exp(s - m_c), weighted sum acc_c[H] =
// sum exp(s - m_c) enc — and the raw scores to the weights output; then
// pool_combine_kernel merges a row's partials in chunk order with the
// rescaling of the online softmax (_make_fused_kernel's "online" mode,
// fused_encode_pool.py:392-442): M = max m_c, D = sum d_c exp(m_c - M),
// cv = sum acc_c exp(m_c - M) / D, w = exp(s - M) / D. A row's result is
// therefore a function of its bag alone, whichever CTA encoded which
// chunk: the same request gives the same bits in a micro-batch of any
// size (the hot-swap gate's invariant, JAX serve/swap.py:211-245). Shared
// memory stays O(kChunk*H) at any bag length; the workspace is
// B * chunks * (H + 2) floats, allocated by the caller.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace c2v {

constexpr int kChunk = 32;            // contexts per fold step (one per lane of warp 0)
constexpr float kNinf = -3.4e38f;     // NINF, code2vec_tpu/ops/attention.py:22
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block may use on sm_90

// A launcher returns 0, its own launch's cudaError_t, or the NEGATED code
// of an error that was already pending in this thread before it launched
// (an earlier failure, reported here instead of being cleared unseen).
static inline int pending_error() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : -(int)err;
}

// Threads per block: one per output column where possible.
static inline int block_threads(int H) {
  int t = ((H + 31) / 32) * 32;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A CTA's pool scratch, in shared memory.
struct PoolState {
  float* e;     // [kChunk] exp weights of the chunk being summed
  float* stat;  // [4] the row max (two_pass pass B), pad
};

__host__ __device__ constexpr size_t pool_state_floats(int) { return (size_t)kChunk + 4; }

__device__ __forceinline__ PoolState make_pool_state(float* base, int) {
  return PoolState{base, base + kChunk};
}

// The partial of a chunk of n (1..kChunk) encoded rows to out ([H] acc,
// then m, d). Online: m is the chunk's max score, the scores come from s
// and go raw to w_chunk. With fixed_max (two_pass pass B,
// fused_encode_pool.py:432-436) m is that max and the scores come from
// w_chunk. Needs blockDim.x >= 32; ends synchronised.
__device__ __forceinline__ void pool_chunk_partial(const float* enc, const float* s, int n,
                                                   int H, PoolState st, float* out,
                                                   float* w_chunk, const float* fixed_max) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float sc = lane < n ? (fixed_max ? w_chunk[lane] : s[lane]) : -INFINITY;
    const float m = fixed_max ? *fixed_max : warp_max(sc);
    const float ex = lane < n ? expf(sc - m) : 0.f;
    const float esum = warp_sum(ex);
    st.e[lane] = ex;
    if (!fixed_max && lane < n) w_chunk[lane] = sc;
    if (lane == 0) {
      out[H] = m;
      out[H + 1] = esum;
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < n; ++c) a = fmaf(st.e[c], enc[(size_t)c * H + h], a);
    out[h] = a;
  }
  __syncthreads();
}

// Merge a row's chunk partials in chunk order (one CTA per batch row) and
// normalise the raw scores the chunk CTAs left in w.
static __global__ void pool_combine_kernel(const float* __restrict__ part, int n_chunks, int L,
                                           int H, float* __restrict__ cv, float* __restrict__ w) {
  extern __shared__ float scale[];  // [n_chunks] exp(m_c - M), then M, D
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * n_chunks * (H + 2);
  if (threadIdx.x == 0) {
    float m = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, pb[(size_t)c * (H + 2) + H]);
    float d = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float sc = expf(pb[(size_t)c * (H + 2) + H] - m);
      scale[c] = sc;
      d = fmaf(pb[(size_t)c * (H + 2) + H + 1], sc, d);
    }
    scale[n_chunks] = m;
    scale[n_chunks + 1] = d;
  }
  __syncthreads();
  const float m = scale[n_chunks], d = scale[n_chunks + 1];
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < n_chunks; ++c) a = fmaf(pb[(size_t)c * (H + 2) + h], scale[c], a);
    cv[(size_t)b * H + h] = a / d;
  }
  float* w_b = w + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) w_b[l] = expf(w_b[l] - m) / d;
}

// Launch the combine step over the n_chunks partials per row that the
// kernel before it wrote.
static inline cudaError_t launch_combine(const float* part, int n_chunks, int B, int L, int H,
                                         float* cv, float* w, cudaStream_t stream) {
  pool_combine_kernel<<<B, block_threads(H), (n_chunks + 2) * sizeof(float), stream>>>(
      part, n_chunks, L, H, cv, w);
  return cudaGetLastError();
}

}  // namespace c2v
