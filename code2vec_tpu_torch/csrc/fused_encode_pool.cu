// K2 and K3: encode -> attend -> pool over a bag of path-contexts.
//
// Replaces code2vec_tpu/ops/fused_encode_pool.py:_kernel_forward
// (pl.pallas_call at :651): K2 is _make_split_kernel (:190,
// pallas_impl="gather_split", rows gathered before the kernel), K3 is
// _make_fused_kernel (:219, pallas_impl="fused", softmax="materialize",
// rows gathered inside the kernel by id, dequantized on load). Both are one
// kernel here, templated on where a row comes from. K4 is _make_fused_kernel
// with softmax="online" (:389-414) or "two_pass" (:415-438): the same chain
// with the bag softmax streamed, so that a bag of any length runs in a
// bounded workspace (encode_pool_online_kernel, encode_score_kernel +
// encode_pool_fixed_max_kernel, below).
//
// Per context l of batch row b (D = 2*Et + Ep):
//   x   = [start | path | end] rows          (end rows come from the terminal table)
//   y   = x @ W                              W = input_dense/kernel [D, H]
//   enc = tanh(LayerNorm(y))                 eps 1e-6, biased variance, f32 scale/bias
//   then the K1 pool (pool.cuh) over enc with the row's mask.
//
// Bound on an H100: operations. The encode is 2*D*H flops per context
// (180 kflop at the top11 widths) against 3 gathered rows of 400 bytes, so
// the chain sits above the f32 ridge. Design: one CTA per (chunk of kChunk
// contexts, batch row), so a short batch of long bags still spreads over
// the SMs. A CTA loads its chunk's rows into shared memory as f32,
// transposed [D][kChunk] (int8 as q*scale, bf16 widened, ids clamped like a
// JAX gather, 64-bit row offsets), and multiplies them by W streamed
// through shared memory in tiles of kTileK rows: each thread owns a
// register tile of 8 contexts x 4 columns, so one float4 of W and two of x
// feed 32 FMAs. A warp per context then applies LayerNorm + tanh in place
// and the pool folds the chunk (pool.cuh). Gathered rows and encoded
// contexts never reach device memory. Compute stays f32 on the FMA pipes:
// tensor cores would need TF32 or bf16 and change the numbers the JAX
// package is held to.
//
// K4's bound is K3's: operations, counted once per context. The TPU kernel
// streams because VMEM cannot hold an encoded bag of thousands of contexts;
// here K3's one-CTA-per-chunk grid already bounds shared memory, but its
// partials workspace grows with L. K4 gives each batch row a fixed S CTAs
// that loop over the row's chunks, so the workspace is B * S * (H + 2)
// floats at any L. two_pass encodes every context twice (the TPU kernel's
// price for never rescaling); online encodes once.
#include <cuda_bf16.h>
#include <stdint.h>

#include "pool.cuh"

namespace {

using c2v::kChunk;

constexpr float kLnEps = 1e-6f;  // flax nn.LayerNorm default, fused_encode_pool.py:84
constexpr int kTileK = 32;       // rows of W per shared-memory tile
constexpr int kRowsPerThread = 8;  // contexts of a thread's register tile
constexpr int kColsPerThread = 4;  // output columns of a thread's register tile

// K2's row source: rows gathered (and dequantized) before the kernel.
struct GatheredRows {
  const float* gs;  // [B, L, Et]
  const float* gp;  // [B, L, Ep]
  const float* ge;  // [B, L, Et]
};

// K3's row source: the tables themselves, indexed by the id tensors.
template <class T>
struct TableRows {
  const T* tv;         // terminal table [Vt, Et]
  const float* ts;     // its per-row int8 scale [Vt, 1], or nullptr
  const T* pv;         // path table [Vp, Ep]
  const float* ps;     // its per-row int8 scale [Vp, 1], or nullptr
  long long vt, vp;    // table rows
  const int* starts;   // [B, L] ids
  const int* paths;
  const int* ends;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// Fill xT [D][kChunk] with the chunk's rows (contexts base .. base+n of row
// b), zeros for c >= n. A warp covers one k for 32 contexts, so the segment
// branch is uniform and the shared-memory stores are conflict-free.
__device__ __forceinline__ void load_chunk(const GatheredRows& r, float* xT, int* /*ids*/,
                                           int b, int base, int n, int L, int Et, int Ep) {
  const int D = 2 * Et + Ep;
  const size_t row0 = (size_t)b * L + base;
  for (int i = threadIdx.x; i < D * kChunk; i += blockDim.x) {
    const int k = i / kChunk, c = i % kChunk;
    float v = 0.f;
    if (c < n) {
      const size_t row = row0 + c;
      if (k < Et) {
        v = r.gs[row * Et + k];
      } else if (k < Et + Ep) {
        v = r.gp[row * Ep + (k - Et)];
      } else {
        v = r.ge[row * Et + (k - Et - Ep)];
      }
    }
    xT[i] = v;
  }
}

template <class T>
__device__ __forceinline__ void load_chunk(const TableRows<T>& r, float* xT, int* ids, int b,
                                           int base, int n, int L, int Et, int Ep) {
  const size_t row0 = (size_t)b * L + base;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    const int seg = i / n, c = i - seg * n;
    const int* src = seg == 0 ? r.starts : (seg == 1 ? r.paths : r.ends);
    const long long v = seg == 1 ? r.vp : r.vt;
    long long id = src[row0 + c];
    id = id < 0 ? 0 : (id >= v ? v - 1 : id);  // clamp out-of-range ids, as a JAX gather does
    ids[seg * kChunk + c] = (int)id;
  }
  __syncthreads();
  const int D = 2 * Et + Ep;
  for (int i = threadIdx.x; i < D * kChunk; i += blockDim.x) {
    const int k = i / kChunk, c = i % kChunk;
    float v = 0.f;
    if (c < n) {
      if (k < Et) {
        const long long id = ids[c];
        v = widen(r.tv[id * Et + k]);
        if (r.ts) v *= r.ts[id];
      } else if (k < Et + Ep) {
        const long long id = ids[kChunk + c];
        v = widen(r.pv[id * Ep + (k - Et)]);
        if (r.ps) v *= r.ps[id];
      } else {
        const long long id = ids[2 * kChunk + c];
        v = widen(r.tv[id * Et + (k - Et - Ep)]);
        if (r.ts) v *= r.ts[id];
      }
    }
    xT[i] = v;
  }
}

// enc [n][H] = x [n][D] @ W [D][H], x given transposed in xe ([D][kChunk]);
// the result overwrites xe. Thread t owns contexts cg*8 .. cg*8+7 and
// columns hg*4 .. hg*4+3; W passes through `wt` in tiles of kTileK rows.
// Each output accumulates over k in order, as a plain dot product does.
__device__ __forceinline__ void encode_chunk(float* xe, float* wt, int n, int D,
                                             const float* __restrict__ W, int H) {
  const int n_hg = (H + kColsPerThread - 1) / kColsPerThread;
  const int hg = threadIdx.x % n_hg, cg = threadIdx.x / n_hg;
  const int h0 = hg * kColsPerThread, c0 = cg * kRowsPerThread;
  const bool active = c0 < n;  // groups past the chunk's contexts only help load W
  const bool vec = (H % 4) == 0;
  float acc[kRowsPerThread][kColsPerThread] = {};
  for (int k0 = 0; k0 < D; k0 += kTileK) {
    const int kt = min(kTileK, D - k0);
    const float* src = W + (size_t)k0 * H;
    if (vec) {
      for (int i = threadIdx.x; i < kt * H / 4; i += blockDim.x)
        reinterpret_cast<float4*>(wt)[i] = reinterpret_cast<const float4*>(src)[i];
    } else {
      for (int i = threadIdx.x; i < kt * H; i += blockDim.x) wt[i] = src[i];
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < kt; ++kk) {
        const float* xr = xe + (size_t)(k0 + kk) * kChunk + c0;
        const float4 xa = *reinterpret_cast<const float4*>(xr);
        const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
        const float xv[kRowsPerThread] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float* wr = wt + (size_t)kk * H + h0;
        float wv[kColsPerThread];
        if (vec) {
          const float4 t = *reinterpret_cast<const float4*>(wr);
          wv[0] = t.x;
          wv[1] = t.y;
          wv[2] = t.z;
          wv[3] = t.w;
        } else {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) wv[j] = h0 + j < H ? wr[j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        if (c0 + i < n && h0 + j < H) xe[(size_t)(c0 + i) * H + h0 + j] = acc[i][j];
      }
    }
  }
  __syncthreads();
}

// In place: enc_c = tanh((enc_c - mean) * rsqrt(var + eps) * scale + bias),
// one warp per context.
__device__ __forceinline__ void layer_norm_tanh(float* enc, int n, int H,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float inv_h = 1.f / (float)H;
  for (int c = warp; c < n; c += nwarps) {
    float* row = enc + (size_t)c * H;
    float sum = 0.f;
    for (int h = lane; h < H; h += 32) sum += row[h];
    const float mu = c2v::warp_sum(sum) * inv_h;
    float sq = 0.f;
    for (int h = lane; h < H; h += 32) {
      const float d = row[h] - mu;
      sq = fmaf(d, d, sq);
    }
    const float r = rsqrtf(c2v::warp_sum(sq) * inv_h + kLnEps);
    for (int h = lane; h < H; h += 32) row[h] = tanhf((row[h] - mu) * r * lns[h] + lnb[h]);
  }
}

// Shared memory: rows/encoded [kChunk * max(D, H)], W tile [kTileK * H],
// scores [kChunk], pool state, then ids [3 * kChunk] ints.
size_t smem_bytes(int D, int H) {
  return sizeof(float) * ((size_t)kChunk * (D > H ? D : H) + (size_t)kTileK * H + kChunk +
                          c2v::pool_state_floats(H)) +
         sizeof(int) * 3 * kChunk;
}

// The carved-up shared memory of one CTA (layout of smem_bytes).
struct Smem {
  float* xe;   // x^T, then the encoded rows
  float* wt;   // [kTileK, H] W tile
  float* s;    // [kChunk] masked scores
  c2v::PoolState st;
  int* ids;    // [3, kChunk]
};

__device__ __forceinline__ Smem carve(float* smem, int D, int H) {
  Smem m;
  m.xe = smem;
  m.wt = m.xe + (size_t)kChunk * (D > H ? D : H);
  m.s = m.wt + (size_t)kTileK * H;
  m.st = c2v::make_pool_state(m.s + kChunk, H);
  m.ids = reinterpret_cast<int*>(m.s + kChunk + c2v::pool_state_floats(H));
  return m;
}

// Gather, encode and LayerNorm+tanh chunk c of row b into m.xe ([n][H]);
// returns n, the chunk's context count. Ends synchronised.
template <class Rows>
__device__ __forceinline__ int encode_rows(const Rows& rows, const Smem& m, int b, int c, int L,
                                           int Et, int Ep, int H, const float* __restrict__ W,
                                           const float* __restrict__ lns,
                                           const float* __restrict__ lnb) {
  const int base = c * kChunk, n = min(kChunk, L - base);
  load_chunk(rows, m.xe, m.ids, b, base, n, L, Et, Ep);
  __syncthreads();
  encode_chunk(m.xe, m.wt, n, 2 * Et + Ep, W, H);
  layer_norm_tanh(m.xe, n, H, lns, lnb);
  __syncthreads();
  return n;
}

// K2/K3 (materialize): one CTA per (chunk, batch row).
template <class Rows>
__global__ void encode_pool_kernel(Rows rows, const float* __restrict__ mask,
                                   const float* __restrict__ W, const float* __restrict__ lns,
                                   const float* __restrict__ lnb,
                                   const float* __restrict__ attn, float* __restrict__ cv,
                                   float* __restrict__ w, float* __restrict__ part, int L, int Et,
                                   int Ep, int H) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, 2 * Et + Ep, H);
  const int b = blockIdx.y, base = blockIdx.x * kChunk;
  c2v::pool_init(m.st, H);
  const int n = encode_rows(rows, m, b, blockIdx.x, L, Et, Ep, H, W, lns, lnb);
  c2v::score_rows(m.xe, n, H, attn, mask + (size_t)b * L + base, m.s);
  __syncthreads();
  c2v::pool_fold(m.xe, m.s, n, H, m.st, w + (size_t)b * L + base);
  c2v::pool_chunk_done(m.st, L, H, b, cv, w, part);
}

// K4 online (fused_encode_pool.py:389-414): gridDim.x = S CTAs per batch
// row, S fixed by the caller from the SM count and B, never from L. CTA s
// streams chunks s, s+S, s+2S, ... carrying (m, d, acc[H]) with the
// online rescaling (pool_fold) and leaves the raw masked scores in w;
// the S partials are merged by pool_combine_kernel, which also normalises w
// (:440-442). Shared memory and workspace stay O(kChunk*D + S*H) at any L.
template <class Rows>
__global__ void encode_pool_online_kernel(Rows rows, const float* __restrict__ mask,
                                          const float* __restrict__ W,
                                          const float* __restrict__ lns,
                                          const float* __restrict__ lnb,
                                          const float* __restrict__ attn, float* __restrict__ cv,
                                          float* __restrict__ w, float* __restrict__ part, int L,
                                          int Et, int Ep, int H) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, 2 * Et + Ep, H);
  const int b = blockIdx.y, n_chunks = (L + kChunk - 1) / kChunk;
  c2v::pool_init(m.st, H);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int n = encode_rows(rows, m, b, c, L, Et, Ep, H, W, lns, lnb);
    c2v::score_rows(m.xe, n, H, attn, mask + (size_t)b * L + c * kChunk, m.s);
    __syncthreads();
    c2v::pool_fold(m.xe, m.s, n, H, m.st, w + (size_t)b * L + c * kChunk);
  }
  c2v::pool_chunk_done(m.st, L, H, b, cv, w, part);
}

// K4 two_pass, pass A (fused_encode_pool.py:416-425): gather, encode and
// score every chunk; the masked scores go to w, each CTA's max to
// rowmax[b][s].
template <class Rows>
__global__ void encode_score_kernel(Rows rows, const float* __restrict__ mask,
                                    const float* __restrict__ W, const float* __restrict__ lns,
                                    const float* __restrict__ lnb,
                                    const float* __restrict__ attn, float* __restrict__ w,
                                    float* __restrict__ rowmax, int L, int Et, int Ep, int H) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, 2 * Et + Ep, H);
  const int b = blockIdx.y, n_chunks = (L + kChunk - 1) / kChunk;
  float mx = -INFINITY;  // meaningful in warp 0
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int n = encode_rows(rows, m, b, c, L, Et, Ep, H, W, lns, lnb);
    c2v::score_rows(m.xe, n, H, attn, mask + (size_t)b * L + c * kChunk, m.s);
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float sc = lane < n ? m.s[lane] : -INFINITY;
      if (lane < n) w[(size_t)b * L + c * kChunk + lane] = sc;
      mx = fmaxf(mx, c2v::warp_max(sc));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) rowmax[(size_t)b * gridDim.x + blockIdx.x] = mx;
}

// K4 two_pass, pass B (:426-438): the row max is fixed by pass A, so each
// chunk is re-gathered and re-encoded and summed as exp(w - M) * enc with
// no rescaling; the denominator d = sum exp(w - M) accumulates beside it.
// Partials (acc, M, d) are merged by pool_combine_kernel as in online.
template <class Rows>
__global__ void encode_pool_fixed_max_kernel(Rows rows, const float* __restrict__ W,
                                             const float* __restrict__ lns,
                                             const float* __restrict__ lnb,
                                             const float* __restrict__ rowmax,
                                             float* __restrict__ cv, float* __restrict__ w,
                                             float* __restrict__ part, int L, int Et, int Ep,
                                             int H) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, 2 * Et + Ep, H);
  const int b = blockIdx.y, n_chunks = (L + kChunk - 1) / kChunk;
  c2v::pool_init(m.st, H);
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int i = 0; i < (int)gridDim.x; ++i) mx = fmaxf(mx, rowmax[(size_t)b * gridDim.x + i]);
    m.st.stat[0] = mx;
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int n = encode_rows(rows, m, b, c, L, Et, Ep, H, W, lns, lnb);
    c2v::pool_fold_fixed_max(m.xe, w + (size_t)b * L + c * kChunk, n, H, m.st);
  }
  c2v::pool_chunk_done(m.st, L, H, b, cv, w, part);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class Rows>
int launch(const Rows& rows, const float* mask, const float* W, const float* lns,
           const float* lnb, const float* attn, float* cv, float* w, float* part, int B, int L,
           int Et, int Ep, int H, void* stream) {
  const int D = 2 * Et + Ep;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes(D, H);
  const int tile_threads = (kChunk / kRowsPerThread) * ((H + kColsPerThread - 1) / kColsPerThread);
  if (B < 1 || B > 65535 || L < 1 || Et < 1 || Ep < 1 || H < 1 || tile_threads > 1024 ||
      smem > c2v::kMaxSmem || (n_chunks > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  if (const cudaError_t err = allow_smem(encode_pool_kernel<Rows>, smem)) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  encode_pool_kernel<Rows><<<dim3(n_chunks, B), c2v::block_threads(tile_threads), smem, s>>>(
      rows, mask, W, lns, lnb, attn, cv, w, part, L, Et, Ep, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)c2v::launch_combine(part, B, L, H, cv, w, s);
}

// K4: mode 0 = online (one kernel), 1 = two_pass (pass A, pass B); then
// the combine over the S partials of each row. `part` is [B, S, H + 2]
// (unused when S == 1), `rowmax` [B, S] (two_pass only).
template <class Rows>
int launch_stream(const Rows& rows, int mode, const float* mask, const float* W,
                  const float* lns, const float* lnb, const float* attn, float* cv, float* w,
                  float* part, float* rowmax, int B, int L, int Et, int Ep, int H, int S,
                  void* stream) {
  const int D = 2 * Et + Ep;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes(D, H);
  const int tile_threads = (kChunk / kRowsPerThread) * ((H + kColsPerThread - 1) / kColsPerThread);
  if (B < 1 || B > 65535 || L < 1 || Et < 1 || Ep < 1 || H < 1 || tile_threads > 1024 ||
      smem > c2v::kMaxSmem || S < 1 || S > n_chunks || (S > 1 && part == nullptr) ||
      (mode != 0 && mode != 1) || (mode == 1 && rowmax == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(S, B);
  const int threads = c2v::block_threads(tile_threads);
  cudaError_t err;
  if (mode == 0) {
    if ((err = allow_smem(encode_pool_online_kernel<Rows>, smem))) return (int)err;
    encode_pool_online_kernel<Rows><<<grid, threads, smem, s>>>(rows, mask, W, lns, lnb, attn, cv,
                                                                 w, part, L, Et, Ep, H);
    if ((err = cudaGetLastError())) return (int)err;
  } else {
    if ((err = allow_smem(encode_score_kernel<Rows>, smem))) return (int)err;
    if ((err = allow_smem(encode_pool_fixed_max_kernel<Rows>, smem))) return (int)err;
    encode_score_kernel<Rows><<<grid, threads, smem, s>>>(rows, mask, W, lns, lnb, attn, w,
                                                           rowmax, L, Et, Ep, H);
    if ((err = cudaGetLastError())) return (int)err;
    encode_pool_fixed_max_kernel<Rows><<<grid, threads, smem, s>>>(rows, W, lns, lnb, rowmax, cv,
                                                                    w, part, L, Et, Ep, H);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return (int)c2v::launch_combine_parts(part, S, B, L, H, cv, w, s);
}

// Dispatch on the table storage: 0 = f32, 1 = bf16, 2 = int8 (+ per-row
// f32 scales ts/ps), then call f(rows).
template <class F>
int with_table_rows(int table_dtype, const void* tv, const float* ts, const void* pv,
                    const float* ps, long long vt, long long vp, const int* starts,
                    const int* paths, const int* ends, F f) {
  switch (table_dtype) {
    case 0:
      return f(TableRows<float>{(const float*)tv, nullptr, (const float*)pv, nullptr, vt, vp,
                                starts, paths, ends});
    case 1:
      return f(TableRows<__nv_bfloat16>{(const __nv_bfloat16*)tv, nullptr,
                                        (const __nv_bfloat16*)pv, nullptr, vt, vp, starts, paths,
                                        ends});
    case 2:
      return f(TableRows<int8_t>{(const int8_t*)tv, ts, (const int8_t*)pv, ps, vt, vp, starts,
                                 paths, ends});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K2: rows gathered before the kernel. `part` is the [B, chunks, H + 2]
// workspace (unused for bags of one chunk). Returns the launch's cudaError_t.
int c2v_encode_pool_gathered(const float* gs, const float* gp, const float* ge,
                             const float* mask, const float* W, const float* lns,
                             const float* lnb, const float* attn, float* cv, float* w,
                             float* part, int B, int L, int Et, int Ep, int H, void* stream) {
  return launch(GatheredRows{gs, gp, ge}, mask, W, lns, lnb, attn, cv, w, part, B, L, Et, Ep, H,
                stream);
}

// K3: rows gathered in the kernel. table_dtype: 0 = f32, 1 = bf16,
// 2 = int8 (+ per-row f32 scales ts/ps). Returns the launch's cudaError_t.
int c2v_encode_pool_fused(int table_dtype, const void* tv, const float* ts, const void* pv,
                          const float* ps, long long vt, long long vp, const int* starts,
                          const int* paths, const int* ends, const float* mask,
                          const float* W, const float* lns, const float* lnb,
                          const float* attn, float* cv, float* w, float* part, int B, int L,
                          int Et, int Ep, int H, void* stream) {
  return with_table_rows(table_dtype, tv, ts, pv, ps, vt, vp, starts, paths, ends,
                         [&](const auto& rows) {
                           return launch(rows, mask, W, lns, lnb, attn, cv, w, part, B, L, Et, Ep,
                                         H, stream);
                         });
}

// K4: the streamed-softmax chain with the gather inside. mode: 0 = online,
// 1 = two_pass; S CTAs per batch row (1 <= S <= chunks of kChunk); `part`
// [B, S, H + 2] and, for two_pass, `rowmax` [B, S] are workspaces.
// table_dtype as for K3. Returns the launches' cudaError_t.
int c2v_encode_pool_stream(int mode, int table_dtype, const void* tv, const float* ts,
                           const void* pv, const float* ps, long long vt, long long vp,
                           const int* starts, const int* paths, const int* ends,
                           const float* mask, const float* W, const float* lns, const float* lnb,
                           const float* attn, float* cv, float* w, float* part, float* rowmax,
                           int B, int L, int Et, int Ep, int H, int S, void* stream) {
  return with_table_rows(table_dtype, tv, ts, pv, ps, vt, vp, starts, paths, ends,
                         [&](const auto& rows) {
                           return launch_stream(rows, mode, mask, W, lns, lnb, attn, cv, w, part,
                                                rowmax, B, L, Et, Ep, H, S, stream);
                         });
}

}  // extern "C"
