// Shared device code of the attention-pool kernels: K1 (pool.cu) and
// K2/K3/K4 (fused_encode_pool.cu) score, fold and finish a batch row's pool
// with these same routines, as _tile_pool / _pool_f32 are shared by the
// TPU kernels (code2vec_tpu/ops/pallas_attention.py:38,
// code2vec_tpu/ops/fused_encode_pool.py:174).
//
// Semantics (code2vec_tpu/ops/attention.py): s = <enc_l, a>; a user-masked
// slot scores the FINITE sentinel NINF via s*m + (1-m)*NINF; softmax over
// the bag; cv = sum_l w_l enc_l. An all-masked row therefore gives uniform
// weights 1/L and cv = mean of the encoded rows, never NaN. The TPU
// kernels' hard -inf for lane padding has no counterpart here: nothing is
// padded, a chunk simply holds fewer than kChunk rows.
//
// The bag is split into chunks of kChunk contexts, one CTA per (chunk,
// batch row), so a short batch of long bags still fills the card. Each CTA
// folds its chunk into a softmax partial — max m, denominator
// d = sum exp(s - m), weighted sum acc[H] = sum exp(s - m) enc — and writes
// the raw scores to the weights output. A row of one chunk finishes in
// place; otherwise pool_combine_kernel merges the row's partials with the
// rescaling of the online softmax (_make_fused_kernel's "online" mode,
// fused_encode_pool.py:392-442): M = max m_c, D = sum d_c exp(m_c - M),
// cv = sum acc_c exp(m_c - M) / D, w = exp(s - M) / D. Shared memory stays
// O(kChunk*H) at any bag length; the workspace is B * chunks * (H + 2)
// floats, allocated by the caller (K4: B * S * (H + 2) for S CTAs per row,
// each folding many chunks).
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

// One batch row's running pool state, in shared memory.
struct PoolState {
  float* acc;   // [H] running weighted sum of encoded rows
  float* e;     // [kChunk] exp weights of the chunk being folded
  float* stat;  // [4] running max m, denominator d, last rescale, pad
};

__host__ __device__ constexpr size_t pool_state_floats(int H) {
  return (size_t)H + kChunk + 4;
}

__device__ __forceinline__ PoolState make_pool_state(float* base, int H) {
  return PoolState{base, base + H, base + H + kChunk};
}

__device__ __forceinline__ void pool_init(PoolState st, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) st.acc[h] = 0.f;
  if (threadIdx.x == 0) {
    st.stat[0] = -INFINITY;
    st.stat[1] = 0.f;
    st.stat[2] = 0.f;
  }
}

// Masked scores of the n rows of enc ([n, H], row-major): one warp per row.
// mask points at the chunk's first slot of the row's [L] mask.
__device__ __forceinline__ void score_rows(const float* enc, int n, int H,
                                           const float* __restrict__ attn,
                                           const float* __restrict__ mask, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c = warp; c < n; c += nwarps) {
    float v = 0.f;
    for (int h = lane; h < H; h += 32) v = fmaf(enc[(size_t)c * H + h], attn[h], v);
    v = warp_sum(v);
    if (lane == 0) {
      const float m = mask[c];
      s[c] = v * m + (1.f - m) * kNinf;
    }
  }
}

// Fold a chunk of n (1..kChunk) scored rows into the state; the raw scores
// go to w_chunk. Needs blockDim.x >= 32; ends synchronised.
__device__ __forceinline__ void pool_fold(const float* enc, const float* s, int n, int H,
                                          PoolState st, float* w_chunk) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float sc = lane < n ? s[lane] : -INFINITY;
    const float m_old = st.stat[0];
    const float m_new = fmaxf(m_old, warp_max(sc));
    const float ex = lane < n ? expf(sc - m_new) : 0.f;
    const float esum = warp_sum(ex);
    st.e[lane] = ex;
    if (lane < n) w_chunk[lane] = sc;
    __syncwarp();  // every lane has read m_old before lane 0 overwrites it
    if (lane == 0) {
      const float scale = expf(m_old - m_new);  // exp(-inf) = 0 on the first chunk
      st.stat[0] = m_new;
      st.stat[1] = st.stat[1] * scale + esum;
      st.stat[2] = scale;
    }
  }
  __syncthreads();
  const float scale = st.stat[2];
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float a = st.acc[h] * scale;
    for (int c = 0; c < n; ++c) a = fmaf(st.e[c], enc[(size_t)c * H + h], a);
    st.acc[h] = a;
  }
  __syncthreads();
}

// Fold a chunk of n rows against a max fixed in advance in st.stat[0]
// (two_pass pass B, fused_encode_pool.py:432-436): the raw scores come
// from w_chunk, nothing is rescaled. Ends synchronised.
__device__ __forceinline__ void pool_fold_fixed_max(const float* enc, const float* w_chunk, int n,
                                                    int H, PoolState st) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float ex = lane < n ? expf(w_chunk[lane] - st.stat[0]) : 0.f;
    const float esum = warp_sum(ex);
    st.e[lane] = ex;
    if (lane == 0) st.stat[1] += esum;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float a = st.acc[h];
    for (int c = 0; c < n; ++c) a = fmaf(st.e[c], enc[(size_t)c * H + h], a);
    st.acc[h] = a;
  }
  __syncthreads();
}

// cv = acc / d and w = exp(s - m) / d over the row's L raw scores.
__device__ __forceinline__ void pool_finish(PoolState st, int L, int H, float* cv_row,
                                            float* w_row) {
  const float m = st.stat[0], d = st.stat[1];
  for (int h = threadIdx.x; h < H; h += blockDim.x) cv_row[h] = st.acc[h] / d;
  for (int l = threadIdx.x; l < L; l += blockDim.x) w_row[l] = expf(w_row[l] - m) / d;
}

// End of a chunk CTA (blockIdx.x = chunk, gridDim.x = chunks of the row):
// a single-chunk row finishes in place, otherwise the partial (acc[H], m,
// d) goes to part[b][chunk].
__device__ __forceinline__ void pool_chunk_done(PoolState st, int L, int H, int b, float* cv,
                                                float* w, float* part) {
  if (gridDim.x == 1) {
    pool_finish(st, L, H, cv + (size_t)b * H, w + (size_t)b * L);
    return;
  }
  float* out = part + ((size_t)b * gridDim.x + blockIdx.x) * (H + 2);
  for (int h = threadIdx.x; h < H; h += blockDim.x) out[h] = st.acc[h];
  if (threadIdx.x == 0) {
    out[H] = st.stat[0];
    out[H + 1] = st.stat[1];
  }
}

// Merge a row's chunk partials (one CTA per batch row) and normalise the
// raw scores the chunk CTAs left in w.
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

// Launch the combine step over the n_parts partials per row that the
// kernel before it wrote (a no-op for one part: that row finished in place).
static inline cudaError_t launch_combine_parts(const float* part, int n_parts, int B, int L, int H,
                                               float* cv, float* w, cudaStream_t stream) {
  if (n_parts == 1) return cudaSuccess;
  pool_combine_kernel<<<B, block_threads(H), (n_parts + 2) * sizeof(float), stream>>>(
      part, n_parts, L, H, cv, w);
  return cudaGetLastError();
}

// The combine step after a kernel of one CTA per (chunk, batch row).
static inline cudaError_t launch_combine(const float* part, int B, int L, int H, float* cv,
                                         float* w, cudaStream_t stream) {
  return launch_combine_parts(part, (L + kChunk - 1) / kChunk, B, L, H, cv, w, stream);
}

}  // namespace c2v
