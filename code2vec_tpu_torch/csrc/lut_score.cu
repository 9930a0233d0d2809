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
// Design, so that each thread keeps loads in flight while it computes:
//
// - grid (tiles, P / G, Q): a CTA scores a tile of T rows in each of G
//   probed cells of one query (lut_grid in ann/lut_kernel.py: tiles of a
//   cell at a neighbors query, whole cells, G of them, when the call is
//   large), so a query's LUT is staged as few times as filling the card
//   allows;
// - the CTA's only shared memory is the query's [M, 256] LUT (20 KB at
//   M = 20), copied with 16-byte cp.async.cg by all threads; several CTAs
//   fit on an SM, so one CTA's waits overlap another's;
// - while the LUT is in flight, the probed cell id comes (the one
//   dependent load); a thread then takes rows r = tid, tid + 256, ... two
//   at a time, straight into registers: first their bias, then, for real
//   rows only, scale and codes (M / 4 32-bit words; bytes when M % 4 != 0
//   or the codes are not word-aligned). A pad row costs its 4 bytes of
//   bias, not M + 8. The loads run ahead of the lookups, a step's bias two
//   steps and its codes one step before it is scored; the first step's
//   are issued before the CTA waits on the LUT;
// - the M lookups of a row go to four independent partial sums; a pad
//   row (bias -inf) is written -inf without them, which equals
//   0 * acc + -inf for the finite LUT of a query; every slot of out is
//   written, neighbouring threads on neighbouring slots.
//
// The TPU's one-hot compare-and-reduce, a workaround for a machine with no
// vector gather, becomes M shared-memory lookups per row; the TPU kernel's
// DMA of the cell and the GPU sketch's XLA gather both become the loads
// above, addressed through probed[q, p] (no pre-gather).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEntries = 256;  // one uint8 code per subspace
constexpr int kThreads = 256;
constexpr int kRows = 2;       // rows a thread takes per step
constexpr int kStep = kRows * kThreads;
constexpr int kMaxWords = 8;   // M <= 32 takes the word path
constexpr size_t kMaxSmem = 232448;

// A thread's kRows rows of one step: the bias first, then, for the real
// rows only, the scale and W code words (W = 0: the codes are read as
// bytes when the row is scored).
struct Bias {
  float v[kRows];
};

template <int W>
struct Codes {
  float scale[kRows];
  uint32_t word[kRows][W > 0 ? W : 1];
};

__device__ __forceinline__ void load_bias(Bias& b, int base, int n,
                                          const float* __restrict__ bias) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = base + k * kThreads;
    b.v[k] = r < n ? __ldg(bias + r) : -INFINITY;
  }
}

// Waits on b: a pad row (bias -inf) loads nothing more.
template <int W>
__device__ __forceinline__ void load_codes(Codes<W>& c, const Bias& b, int base, int n, int M,
                                           const float* __restrict__ scales,
                                           const uint8_t* __restrict__ codes) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = base + k * kThreads;
    const bool real = r < n && b.v[k] != -INFINITY;
    c.scale[k] = real ? __ldg(scales + r) : 0.f;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(codes + (size_t)r * M);
#pragma unroll
    for (int j = 0; j < W; ++j) c.word[k][j] = real ? __ldg(words + j) : 0u;
  }
}

// out = scale * sum_m LUT[m, code_m] + bias over four partial sums; a pad
// row is written -inf (0 * acc + -inf) without its lookups.
template <int W>
__device__ __forceinline__ void score_rows(const Bias& b, const Codes<W>& c, int base, int n,
                                           int M, const float* t,
                                           const uint8_t* __restrict__ codes, float* out) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = base + k * kThreads;
    if (r >= n) continue;
    if (b.v[k] == -INFINITY) {
      out[r] = b.v[k];
      continue;
    }
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    if (W > 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint32_t w = c.word[k][j];
        const float* tj = t + 4 * j * kEntries;
        acc0 += tj[w & 0xffu];
        acc1 += tj[kEntries + ((w >> 8) & 0xffu)];
        acc2 += tj[2 * kEntries + ((w >> 16) & 0xffu)];
        acc3 += tj[3 * kEntries + (w >> 24)];
      }
    } else {
      const uint8_t* row = codes + (size_t)r * M;
      int m = 0;
      for (; m + 4 <= M; m += 4) {
        acc0 += t[m * kEntries + __ldg(row + m)];
        acc1 += t[(m + 1) * kEntries + __ldg(row + m + 1)];
        acc2 += t[(m + 2) * kEntries + __ldg(row + m + 2)];
        acc3 += t[(m + 3) * kEntries + __ldg(row + m + 3)];
      }
      for (; m < M; ++m) acc0 += t[m * kEntries + __ldg(row + m)];
    }
    out[r] = fmaf(c.scale[k], (acc0 + acc1) + (acc2 + acc3), b.v[k]);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) lut_score_kernel(
    const float* __restrict__ lut, const int* __restrict__ probed,
    const uint8_t* __restrict__ codes, const float* __restrict__ scales,
    const float* __restrict__ bias, float* __restrict__ out, int P, int n_list, int C, int M,
    int T, int G) {
  extern __shared__ __align__(16) float t[];  // [M][256] the query's LUT
  const int q = blockIdx.z, p0 = blockIdx.y * G, p1 = min(P, p0 + G);
  const int r0 = blockIdx.x * T, n = min(T, C - r0);
  const float* lq = lut + (size_t)q * M * kEntries;
  for (int i = threadIdx.x; i < M * kEntries / 4; i += kThreads) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(t + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(lq + 4 * i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int p = p0; p < p1; ++p) {  // G probed cells of one query share the LUT
    int cell = __ldg(probed + (size_t)q * P + p);
    cell = cell < 0 ? 0 : (cell >= n_list ? n_list - 1 : cell);  // clamp, as a JAX gather does
    const size_t row0 = (size_t)cell * C + r0;
    const float* bi = bias + row0;
    const float* sc = scales + row0;
    const uint8_t* cd = codes + row0 * M;
    float* o = out + ((size_t)q * P + p) * C + r0;

    // A step's bias is loaded two steps ahead and its codes one step ahead
    // of its lookups, so a thread's loads are in flight while it scores.
    Bias b0, b1;
    Codes<W> c0;
    const int base = threadIdx.x;
    load_bias(b0, base, n, bi);
    load_bias(b1, base + kStep, n, bi);
    load_codes<W>(c0, b0, base, n, M, sc, cd);
    if (p == p0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int r = base; r < n; r += kStep) {
      Bias b2;
      Codes<W> c1;
      load_codes<W>(c1, b1, r + kStep, n, M, sc, cd);
      load_bias(b2, r + 2 * kStep, n, bi);
      score_rows<W>(b0, c0, r, n, M, t, cd, o);
      b0 = b1;
      b1 = b2;
      c0 = c1;
    }
  }
}

template <int W>
cudaError_t launch(const float* lut, const int* probed, const uint8_t* codes,
                   const float* scales, const float* bias, float* out, int Q, int P, int n_list,
                   int C, int M, int T, int G, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_score_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  lut_score_kernel<W><<<dim3((C + T - 1) / T, (P + G - 1) / G, Q), kThreads, smem, stream>>>(
      lut, probed, codes, scales, bias, out, P, n_list, C, M, T, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launch K5 on `stream`: a CTA scores a tile of T rows in each of G probed
// cells of one query. The LUT must be 16-byte aligned. Returns the launch's
// cudaError_t, or the negated code of an error already pending before it.
int c2v_lut_score_cells(const float* lut, const int* probed, const uint8_t* codes,
                        const float* scales, const float* bias, float* out, int Q, int P,
                        int n_list, int C, int M, int T, int G, void* stream) {
  const size_t smem = sizeof(float) * (size_t)M * kEntries;
  if (Q < 1 || Q > 65535 || P < 1 || P > 65535 || n_list < 1 || C < 1 || M < 1 || T < 1 || G < 1 ||
      smem > kMaxSmem || (uintptr_t)lut % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return -(int)pending;
  const cudaStream_t s = (cudaStream_t)stream;
  const int W = (M % 4 == 0 && (uintptr_t)codes % 4 == 0 && M / 4 <= kMaxWords) ? M / 4 : 0;
  switch (W) {
#define C2V_LUT_CASE(w) \
  case w:               \
    return (int)launch<w>(lut, probed, codes, scales, bias, out, Q, P, n_list, C, M, T, G, smem, s);
    C2V_LUT_CASE(1)
    C2V_LUT_CASE(2)
    C2V_LUT_CASE(3)
    C2V_LUT_CASE(4)
    C2V_LUT_CASE(5)
    C2V_LUT_CASE(6)
    C2V_LUT_CASE(7)
    C2V_LUT_CASE(8)
#undef C2V_LUT_CASE
    default:
      return (int)launch<0>(lut, probed, codes, scales, bias, out, Q, P, n_list, C, M, T, G, smem,
                            s);
  }
}

}  // extern "C"
