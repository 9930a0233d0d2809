// K1: masked attention pool over encoded contexts.
//
// Replaces code2vec_tpu/ops/pallas_attention.py:_forward (pl.pallas_call
// at :114, kernel _make_kernel :63, body _tile_pool :38), the kernel of
// pallas_impl="pool_only". In: ctx [B, L, H] f32, mask [B, L] f32,
// a [H] f32. Out: cv [B, H] f32, w [B, L] f32.
//
// Bound on an H100: bytes. The pool reads each context once and does 4
// flops per element of it (score and weighted sum), far below the card's
// ~20 flops per byte of f32 ridge. Design: one CTA per (chunk of kChunk
// contexts, batch row) copies its contexts into shared memory, scores each
// with a warp reduction and folds the chunk into a softmax partial; rows of
// more than one chunk are merged by pool_combine_kernel (pool.cuh). Every
// context is read from device memory once, a short batch of long bags
// still spreads over the SMs, and besides cv and w only B * chunks * (H+2)
// floats of partials are written. The TPU kernel's batch tiles of 8 and
// 128-lane bag padding exist for the TPU's vector unit and are not copied.
#include "pool.cuh"

namespace {

__global__ void pool_kernel(const float* __restrict__ ctx, const float* __restrict__ mask,
                            const float* __restrict__ attn, float* __restrict__ cv,
                            float* __restrict__ w, float* __restrict__ part, int L, int H) {
  using c2v::kChunk;
  extern __shared__ float smem[];
  float* enc = smem;                    // [kChunk, H] the chunk's contexts
  float* s = enc + (size_t)kChunk * H;  // [kChunk] masked scores
  c2v::PoolState st = c2v::make_pool_state(s + kChunk, H);
  const int b = blockIdx.y, base = blockIdx.x * kChunk;
  const int n = min(kChunk, L - base);
  c2v::pool_init(st, H);
  const float* src = ctx + ((size_t)b * L + base) * H;
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) enc[i] = src[i];
  __syncthreads();
  c2v::score_rows(enc, n, H, attn, mask + (size_t)b * L + base, s);
  __syncthreads();
  c2v::pool_fold(enc, s, n, H, st, w + (size_t)b * L + base);
  c2v::pool_chunk_done(st, L, H, b, cv, w, part);
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launch K1 on `stream`: the chunk kernel, then (bags longer than kChunk)
// the combine step over `part` [B, chunks, H + 2]. Returns a cudaError_t.
int c2v_pool_forward(const float* ctx, const float* mask, const float* attn, float* cv,
                     float* w, float* part, int B, int L, int H, void* stream) {
  using c2v::kChunk;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * ((size_t)kChunk * H + kChunk + c2v::pool_state_floats(H));
  if (B < 1 || B > 65535 || L < 1 || H < 1 || smem > c2v::kMaxSmem ||
      (n_chunks > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  pool_kernel<<<dim3(n_chunks, B), c2v::block_threads(H), smem, s>>>(ctx, mask, attn, cv, w, part,
                                                                     L, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)c2v::launch_combine(part, B, L, H, cv, w, s);
}

}  // extern "C"
