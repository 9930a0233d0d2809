// K5: IVF-PQ cell scoring by LUT.
//
// Replaces code2vec_tpu/ann/lut_kernel.py:pallas_lut_score_cells
// (pl.pallas_call at :206, kernel _make_kernel :63) and the GPU sketch
// gpu_lut_score_cells (:171, _make_gpu_kernel :139), as one kernel:
//
//   out[q, p, c] = scales[cell, c] * sum_m LUT[q, m, codes[cell, c, m]] + bias[cell, c]
//   with cell = probed[q, p]
//
// In: lut f32 [Q, M, 256], probed int32 [Q, P], codes uint8 [n_list, C, M],
// scales / bias f32 [n_list, C]. Out: f32 [Q, P, C]. Pad slots carry scale
// 0 and bias -inf, so they score exactly -inf.
//
// Bound on an H100: bytes. A row costs M bytes of codes and 8 bytes of
// scale and bias for M table lookups and adds, far below the f32 ridge.
// Design: one CTA per (probed cell, query) reads the cell's slab directly
// through probed[q, p] (no pre-gather: the TPU kernel's DMA of the cell and
// the GPU sketch's XLA gather both become plain loads here). The CTA first
// stages the query's [M, 256] LUT in shared memory (20 KB at M = 20); the
// TPU's one-hot compare-and-reduce, a workaround for a machine with no
// vector gather, becomes M shared-memory lookups per row. Each thread
// scores rows c = tid, tid + blockDim, ...: its M codes come as 32-bit
// words when M % 4 == 0 (a row then starts on a word boundary; M = 20 is
// not 16-byte aligned, so no wider loads), else as bytes; neighbouring
// threads read neighbouring rows, so a warp's loads cover one contiguous
// span of the slab.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEntries = 256;  // one uint8 code per subspace
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

__global__ void lut_score_kernel(const float* __restrict__ lut, const int* __restrict__ probed,
                                 const uint8_t* __restrict__ codes,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ bias, float* __restrict__ out,
                                 int P, int n_list, int C, int M, bool words) {
  extern __shared__ float lut_s[];  // [M][256]
  const int p = blockIdx.x, q = blockIdx.y;
  const float* lq = lut + (size_t)q * M * kEntries;
  for (int i = threadIdx.x; i < M * kEntries; i += blockDim.x) lut_s[i] = lq[i];
  int cell = probed[(size_t)q * P + p];
  cell = cell < 0 ? 0 : (cell >= n_list ? n_list - 1 : cell);  // clamp, as a JAX gather does
  __syncthreads();
  const uint8_t* slab = codes + (size_t)cell * C * M;
  const float* sc = scales + (size_t)cell * C;
  const float* bi = bias + (size_t)cell * C;
  float* o = out + ((size_t)q * P + p) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const uint8_t* row = slab + (size_t)c * M;
    float acc = 0.f;
    if (words) {
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
      for (int j = 0; j < M / 4; ++j) {
        const uint32_t v = rw[j];
        const float* t = lut_s + 4 * j * kEntries;
        acc += t[v & 0xffu];
        acc += t[kEntries + ((v >> 8) & 0xffu)];
        acc += t[2 * kEntries + ((v >> 16) & 0xffu)];
        acc += t[3 * kEntries + (v >> 24)];
      }
    } else {
      for (int m = 0; m < M; ++m) acc += lut_s[m * kEntries + row[m]];
    }
    o[c] = sc[c] * acc + bi[c];
  }
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launch K5 on `stream`. Returns the launch's cudaError_t, or the negated
// code of an error already pending before it.
int c2v_lut_score_cells(const float* lut, const int* probed, const uint8_t* codes,
                        const float* scales, const float* bias, float* out, int Q, int P,
                        int n_list, int C, int M, void* stream) {
  const size_t smem = sizeof(float) * (size_t)M * kEntries;
  if (Q < 1 || Q > 65535 || P < 1 || n_list < 1 || C < 1 || M < 1 || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return -(int)pending;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool words = (M % 4 == 0) && ((uintptr_t)codes % 4 == 0);
  lut_score_kernel<<<dim3(P, Q), kThreads, smem, (cudaStream_t)stream>>>(
      lut, probed, codes, scales, bias, out, P, n_list, C, M, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
