// K2, K3 and K4: encode -> attend -> pool over a bag of path-contexts.
//
// Replaces code2vec_tpu/ops/fused_encode_pool.py:_kernel_forward
// (pl.pallas_call at :651): K2 is _make_split_kernel (:190,
// pallas_impl="gather_split", rows gathered before the kernel), K3 is
// _make_fused_kernel (:219, pallas_impl="fused", softmax="materialize",
// rows gathered inside the kernel by id, dequantized on load), K4 is
// _make_fused_kernel with softmax="online" (:389-414) or "two_pass"
// (:415-438): the same chain with the bag softmax streamed, so that a bag of
// any length runs in a bounded workspace. All of them are one chunk step
// here, templated on where a row comes from.
//
// Per context l of batch row b (D = 2*Et + Ep):
//   x   = [start | path | end] rows          (end rows come from the terminal table)
//   y   = x @ W                              W = input_dense/kernel [D, H]
//   enc = tanh(LayerNorm(y))                 eps 1e-6, biased variance, f32 scale/bias
//   enc = enc * drop[b, l]                   training only: the dropout keep mask
//                                            [B, L, H], pre-scaled by 1/keep (K2, K3,
//                                            K4 online and both passes of K4 two_pass;
//                                            the JAX kernel's drop_mask)
//   then the K1 pool (pool.cuh) over enc with the row's mask.
//
// Bound on an H100: operations. The encode is 2*D*H flops per context
// (180 kflop at the top11 widths) against 3 gathered rows of 400 bytes.
// Design: a CTA of 8 encode warps and 4 copy warps owns S of a batch row's
// chunks of kChunk contexts (chunks s, s+S, ...) and writes each one's
// softmax partial.
//   - Gather: the copy warps read the ids of chunk c+2S while chunk c is
//     encoded, then copy every row of chunk c+S at once with cp.async, a
//     warp-wide copy per row, 16/8/4 bytes per lane as the row's width and
//     alignment allow, row-major into shared memory [kChunk][xs]; ids are
//     clamped as a JAX gather clamps. Two row buffers. A copy of a random
//     row stalls its warp for hundreds of cycles (measured), hence warps of
//     their own. The copies go through L1 (cp.async.ca): a row that many
//     slots share (every PAD slot reads row 0) is then served by each SM's
//     L1 instead of queueing at one L2 slice. bf16 / int8 rows land raw and
//     are widened (int8 times its row scale, copied beside it) in shared
//     memory.
//   - W: zero-padded to [Dp, ws] (Dp = D rounded up to 8) and loaded once
//     per CTA where it fits beside the row buffers (top11: 126 KB); else it
//     streams through a double-buffered ring of kTileK-row tiles for every
//     chunk (encode 300: W is 360 KB).
//   - Encode: on the tensor cores, mma.sync m16n8k8 TF32 with f32
//     accumulation, each operand split as x = hi + lo with hi = tf32(x)
//     and acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi: the dropped lo*lo term
//     is < 2^-22 relative, so the result stays within f32 rounding of the
//     plain f32 product (a single TF32 product would not: ~1e-3). A
//     widened bf16 row (K2 under compute_dtype="bfloat16", K3/K4 over a
//     bf16 table) is exact in TF32, its lo is zero, and two products
//     (a_hi*b_hi + a_hi*b_lo) give what three give. The
//     tensor core truncates its sums, so the small products accumulate
//     apart and the large one joins an f32 sum every kGroupK columns. A warp
//     owns 16 contexts x every fourth 8-column tile of H. The padded row
//     strides (xs % 8 == 4, ws % 16 == 8) make the fragment loads free of
//     bank conflicts.
//   - Then LayerNorm + tanh and the score in shared memory, four contexts
//     per warp at once, and the chunk's pool partial (pool.cuh). Gathered
//     rows and encoded contexts never reach device memory.
//
// A CTA holds ~219 KB of shared memory at the top11 widths, so one runs on
// an SM: each batch row gets S CTAs, one wave of the card over the batch;
// the wrapper picks S (ops/fused_encode_pool.stream_ctas) for every entry
// point. K2 and K3 (materialize) run K4's online kernel on that grid.
// two_pass encodes every context twice (the TPU kernel's price for never
// rescaling); online encodes once. pool.cuh's combine kernel merges a
// row's chunk partials in chunk order, so the bits of a row do not depend
// on S (and so not on B): the workspace is B * chunks * (H + 2) floats.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "pool.cuh"

namespace {

using c2v::kChunk;

constexpr float kLnEps = 1e-6f;  // flax nn.LayerNorm default, fused_encode_pool.py:84
constexpr int kBuf = 2;          // row buffers: chunk c+S lands while chunk c is encoded
constexpr int kWarps = 8;        // encode warps: 2 m-tiles of 16 contexts x 4 column groups
constexpr int kThreads = 32 * kWarps;
constexpr int kCopyWarps = 4;    // warps that issue the row copies
constexpr int kBlock = kThreads + 32 * kCopyWarps;
constexpr int kTileK = 32;       // rows of W per tile when W streams
constexpr int kNPass = 4;        // 8-column tiles a warp accumulates at once
constexpr int kGroupK = 64;      // columns of x the tensor core sums before a rounded f32 add

// K2's row source: rows gathered (and dequantized) before the kernel,
// indexed by position b*L + l: f32, or bf16 under compute_dtype="bfloat16"
// (_gather_rows casts the rows to the compute dtype, fused_encode_pool.py:
// 771-777, and the split kernel widens them, :203-207).
template <class T_>
struct GatheredRows {
  using T = T_;
  const T* gs;  // [B, L, Et]
  const T* gp;  // [B, L, Ep]
  const T* ge;  // [B, L, Et]
  __host__ __device__ const void* base(int seg) const {
    return seg == 0 ? gs : (seg == 1 ? gp : ge);
  }
  __device__ const float* scale(int) const { return nullptr; }
  __device__ long long id(int, size_t pos) const { return (long long)pos; }
  __device__ long long row(int, long long id) const { return id; }
};

// K3/K4's row source: the tables themselves, indexed by the id tensors.
template <class T_>
struct TableRows {
  using T = T_;
  const T* tv;         // terminal table [Vt, Et]
  const float* ts;     // its per-row int8 scale [Vt, 1], or nullptr
  const T* pv;         // path table [Vp, Ep]
  const float* ps;     // its per-row int8 scale [Vp, 1], or nullptr
  long long vt, vp;    // table rows
  const int* starts;   // [B, L] ids
  const int* paths;
  const int* ends;
  __host__ __device__ const void* base(int seg) const { return seg == 1 ? pv : tv; }
  __device__ const float* scale(int seg) const { return seg == 1 ? ps : ts; }
  __device__ long long id(int seg, size_t pos) const {
    return (seg == 0 ? starts : (seg == 1 ? paths : ends))[pos];
  }
  __device__ long long row(int seg, long long id) const {
    const long long v = seg == 1 ? vp : vt;
    return id < 0 ? 0 : (id >= v ? v - 1 : id);  // clamp out-of-range ids, as a JAX gather does
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// Sizes and shared-memory offsets of one launch, computed on the host.
struct Layout {
  int L, H, D, Dp, n_chunks;
  int xs;          // row stride of the f32 rows, floats: Dp + 4 (xs % 8 == 4)
  int ws;          // row stride of W in shared memory, floats (ws % 16 == 8)
  int resident;    // W loaded once per CTA (else streamed in kTileK-row tiles)
  int item;        // bytes per stored table element: 4 f32, 2 bf16, 1 int8
  int stride;      // bytes per row of a row buffer
  int seg_off[3], seg_bytes[3], seg_w[3];  // per segment: byte offset in a row, bytes, copy width
  int w_copy;      // copy width of W's rows, bytes
  int off_rows, off_x, off_enc, off_par, off_s, off_mk, off_scl, off_pool, smem;  // bytes (W at 0)
};

// a[seg] without a dynamic index (which would move the Layout to local memory)
__device__ __forceinline__ int pick(const int (&a)[3], int seg) {
  return seg == 0 ? a[0] : (seg == 1 ? a[1] : a[2]);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The widest copy (16, 8, 4 bytes by cp.async; 2, 1 by plain loads) that
// divides the row's bytes, its offset in the buffer and the source's address.
int copy_width(int bytes, int off, const void* src) {
  for (int w = 16; w > 1; w >>= 1) {
    if (bytes % w == 0 && off % w == 0 && (uintptr_t)src % w == 0) return w;
  }
  return 1;
}

template <class Rows>
Layout make_layout(const Rows& rows, const float* W, int L, int Et, int Ep, int H) {
  Layout ly{};
  ly.L = L;
  ly.H = H;
  ly.D = 2 * Et + Ep;
  ly.Dp = round_up(ly.D, 8);
  ly.n_chunks = (L + kChunk - 1) / kChunk;
  ly.xs = ly.Dp + 4;
  ly.ws = round_up(H, 8);
  if (ly.ws % 16 != 8) ly.ws += 8;
  ly.item = (int)sizeof(typename Rows::T);
  ly.stride = ly.item == 4 ? 4 * ly.xs : round_up(ly.D * ly.item, 16);
  const int lens[3] = {Et, Ep, Et};
  for (int s = 0, off = 0; s < 3; off += lens[s++]) {
    ly.seg_off[s] = off * ly.item;
    ly.seg_bytes[s] = lens[s] * ly.item;
    ly.seg_w[s] = copy_width(ly.seg_bytes[s], ly.seg_off[s], rows.base(s));
  }
  ly.w_copy = copy_width(4 * H, 0, W);
  const bool widen = ly.item != 4;
  for (int resident = 1; resident >= 0; --resident) {  // W resident if it fits, else streamed
    ly.resident = resident;
    int off = 4 * (ly.resident ? ly.Dp : 2 * kTileK) * ly.ws;
    ly.off_rows = off;
    off += kBuf * kChunk * ly.stride;
    ly.off_x = off;
    off += widen ? 4 * kChunk * ly.xs : 0;
    ly.off_enc = off;
    off += 4 * round_up(kChunk * H, 4);
    ly.off_par = off;
    off += 4 * round_up(3 * H, 4);
    ly.off_s = off;
    off += 4 * kChunk;
    ly.off_mk = off;
    off += 4 * kBuf * kChunk;
    ly.off_scl = off;
    off += widen ? 4 * kBuf * 3 * kChunk : 0;
    ly.off_pool = off;
    off += 4 * (int)c2v::pool_state_floats(H);
    ly.smem = off;
    if (ly.smem <= (int)c2v::kMaxSmem) break;
  }
  return ly;
}

// The carved-up shared memory of one CTA (layout of make_layout).
struct Smem {
  float* w;      // W, or two tiles of it
  char* rows;    // kBuf row buffers [kChunk][stride bytes]
  float* x;      // the widened f32 rows (bf16 / int8 tables)
  float* enc;    // [kChunk, H] encoded contexts
  float* par;    // [3, H] LayerNorm scale, bias and the attention vector
  float* s;      // [kChunk] masked scores
  float* mk;     // [kBuf][kChunk] the chunks' mask values
  float* scl;    // [kBuf][3][kChunk] int8 row scales
  c2v::PoolState st;
};

__device__ __forceinline__ Smem carve(char* smem, const Layout& ly) {
  auto f = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  return Smem{f(0), smem + ly.off_rows, f(ly.off_x), f(ly.off_enc), f(ly.off_par),
              f(ly.off_s), f(ly.off_mk), f(ly.off_scl), c2v::make_pool_state(f(ly.off_pool), ly.H)};
}

__device__ __forceinline__ void copy_async(void* dst, const void* src, int w) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  switch (w) {
    case 16:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
      break;
    default:
      *reinterpret_cast<uint8_t*>(dst) = *reinterpret_cast<const uint8_t*>(src);
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kRowsPerCopyWarp = 3 * kChunk / kCopyWarps;  // (segment, context) rows
static_assert(kRowsPerCopyWarp <= 32, "a copy warp's row ids fit in one lane each");

// Copy warp cw copies rows cw, cw + kCopyWarps, ... of the chunk's 3*kChunk
// (segment, context) rows; lane j holds the id of its row j as stored (0
// past the bag). Loaded a chunk ahead of issue_rows and not used before,
// so the load's latency hides behind an encode.
template <class Rows>
__device__ __forceinline__ long long load_id(const Rows& rows, const Layout& ly, int b, int c) {
  const int lane = threadIdx.x & 31, cw = (threadIdx.x - kThreads) >> 5;
  const int r = cw + kCopyWarps * lane, base = c * kChunk, ctx = r % kChunk;
  if (lane >= kRowsPerCopyWarp || base + ctx >= ly.L) return 0;
  return rows.id(r / kChunk, (size_t)b * ly.L + base + ctx);
}

// The copy warps issue chunk c's rows into row buffer `buf`, a warp-wide
// copy per row, and beside them each int8 row's scale and, if mask is
// given, the chunk's mask values. A copy of a random row stalls its warp
// for hundreds of cycles, so four warps issue them while the other eight
// encode.
template <class Rows>
__device__ __forceinline__ void issue_rows(const Rows& rows, const Layout& ly, const Smem& m,
                                           const float* __restrict__ mask, int buf, int c,
                                           long long id) {
  const int lane = threadIdx.x & 31, cw = (threadIdx.x - kThreads) >> 5;
  const int n = min(kChunk, ly.L - c * kChunk);
  if (lane < kRowsPerCopyWarp) {
    const int r = cw + kCopyWarps * lane, seg = r / kChunk, ctx = r % kChunk;
    id = rows.row(seg, id);
    const float* sc = rows.scale(seg);
    if (ctx < n && sc) copy_async(m.scl + (buf * 3 + seg) * kChunk + ctx, sc + id, 4);
  }
  for (int ctx = lane; mask && cw == 0 && ctx < n; ctx += 32) {
    copy_async(m.mk + buf * kChunk + ctx, mask + (size_t)blockIdx.y * ly.L + c * kChunk + ctx, 4);
  }
  char* dst0 = m.rows + (size_t)buf * kChunk * ly.stride;
#pragma unroll 4
  for (int j = 0; j < kRowsPerCopyWarp; ++j) {
    const int r = cw + kCopyWarps * j, seg = r / kChunk, ctx = r % kChunk;
    const long long rid = __shfl_sync(0xffffffffu, id, j);
    if (ctx >= n) continue;  // uniform over the warp
    const int w = pick(ly.seg_w, seg), bytes = pick(ly.seg_bytes, seg);
    const char* src = reinterpret_cast<const char*>(rows.base(seg)) + rid * bytes;
    char* dst = dst0 + (size_t)ctx * ly.stride + pick(ly.seg_off, seg);
    for (int o = lane * w; o < bytes; o += 32 * w) copy_async(dst + o, src + o, w);
  }
}

// Threads 0 .. nthr issue W's rows k0 .. k0+kt (zero rows past D) into
// `dst` [kt][ws], a warp per row.
__device__ __forceinline__ void issue_w(const float* __restrict__ W, const Layout& ly, float* dst,
                                        int k0, int kt, int nthr) {
  const int per_row = 4 * ly.H / ly.w_copy, rows = min(kt, ly.D - k0);
  for (int k = threadIdx.x / 32; k < rows; k += nthr / 32) {
    const char* src = reinterpret_cast<const char*>(W + (size_t)(k0 + k) * ly.H);
    char* d = reinterpret_cast<char*>(dst + (size_t)k * ly.ws);
    for (int o = threadIdx.x % 32; o < per_row; o += 32) {
      copy_async(d + o * ly.w_copy, src + o * ly.w_copy, ly.w_copy);
    }
  }
  for (int i = threadIdx.x; i < (kt - max(rows, 0)) * ly.ws; i += nthr) {
    dst[(size_t)max(rows, 0) * ly.ws + i] = 0.f;
  }
}

// A barrier of the encode warps alone (the copy warps run on).
__device__ __forceinline__ void encode_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Widen a bf16 / int8 row buffer into the f32 rows (int8 times the row scale).
template <class T>
__device__ __forceinline__ void widen_rows(const Layout& ly, const Smem& m, int buf, int n) {
  const char* src = m.rows + (size_t)buf * kChunk * ly.stride;
  const float* scl = m.scl + buf * 3 * kChunk;
  const bool scaled = sizeof(T) == 1;
  for (int i = threadIdx.x; i < n * ly.D; i += kThreads) {
    const int ctx = i / ly.D, k = i % ly.D;
    float v = widen(reinterpret_cast<const T*>(src + (size_t)ctx * ly.stride)[k]);
    if (scaled) {
      const int seg = k * ly.item < ly.seg_off[1] ? 0 : (k * ly.item < ly.seg_off[2] ? 1 : 2);
      v *= scl[seg * kChunk + ctx];
    }
    m.x[(size_t)ctx * ly.xs + k] = v;
  }
}

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds a finite value), lo the
// exact rest, |lo| <= 2^-11 |v|. The tensor core reads the top 19 bits of
// a TF32 operand, so lo enters the product truncated: |err| < 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's NP column tiles j0, j0+4, ... (8 columns each) of the 16 rows
// r0 .. r0+16: enc (+)= x[r0.., 0:kt] @ wt[0:kt, tiles] in 3xTF32. The
// tensor core truncates when it adds into an accumulator, so the two small
// products sum apart (in `lo`, where truncation costs ~2^-11 less) and the
// large one in `part` over kGroupK columns of x at a time, which then joins
// `acc` by a rounded f32 add. kExactX: every x is exact in TF32 (widened
// bf16 rows: 8 significant bits), so x_lo = 0 and the x_lo*W_hi product
// adds exactly zero; it is skipped, two products give what three give.
template <int NP, bool kExactX>
__device__ __forceinline__ void encode_cols(const float* __restrict__ x, int xs,
                                            const float* __restrict__ wt, int ws, int kt, int j0,
                                            float* enc, int r0, int H, bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xa = x + (size_t)(r0 + g) * xs + t;
  const float* xb = xa + (size_t)8 * xs;
  const float* wk = wt + (size_t)t * ws + j0 * 8 + g;
  float* e0 = enc + (size_t)(r0 + g) * H + j0 * 8 + 2 * t;
  float* e1 = e0 + (size_t)8 * H;
  const int n0 = j0 * 8 + 2 * t;
  float acc[NP][4], lo[NP][4] = {};
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int n = n0 + 32 * p;
    acc[p][0] = !first && n < H ? e0[32 * p] : 0.f;
    acc[p][1] = !first && n + 1 < H ? e0[32 * p + 1] : 0.f;
    acc[p][2] = !first && n < H ? e1[32 * p] : 0.f;
    acc[p][3] = !first && n + 1 < H ? e1[32 * p + 1] : 0.f;
  }
  for (int k0 = 0; k0 < kt; k0 += kGroupK) {
    float part[NP][4] = {};
#pragma unroll 2
    for (int k = k0; k < min(k0 + kGroupK, kt); k += 8) {
      uint32_t ah[4], al[4], bh[NP][2], bl[NP][2];
      if (kExactX) {
        ah[0] = __float_as_uint(xa[k]);
        ah[1] = __float_as_uint(xb[k]);
        ah[2] = __float_as_uint(xa[k + 4]);
        ah[3] = __float_as_uint(xb[k + 4]);
      } else {
        split_tf32(xa[k], ah[0], al[0]);
        split_tf32(xb[k], ah[1], al[1]);
        split_tf32(xa[k + 4], ah[2], al[2]);
        split_tf32(xb[k + 4], ah[3], al[3]);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        split_tf32(wk[(size_t)k * ws + 32 * p], bh[p][0], bl[p][0]);
        split_tf32(wk[(size_t)(k + 4) * ws + 32 * p], bh[p][1], bl[p][1]);
      }
      if (!kExactX) {
#pragma unroll
        for (int p = 0; p < NP; ++p) mma_tf32(lo[p], al, bh[p][0], bh[p][1]);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) mma_tf32(lo[p], ah, bl[p][0], bl[p][1]);
#pragma unroll
      for (int p = 0; p < NP; ++p) mma_tf32(part[p], ah, bh[p][0], bh[p][1]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][v] += part[p][v];
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int n = n0 + 32 * p;
    if (n < H) {
      e0[32 * p] = acc[p][0] + lo[p][0];
      e1[32 * p] = acc[p][2] + lo[p][2];
    }
    if (n + 1 < H) {
      e0[32 * p + 1] = acc[p][1] + lo[p][1];
      e1[32 * p + 1] = acc[p][3] + lo[p][3];
    }
  }
}

// enc[:, :H] (+)= x[:, k0:k0+kt] @ wt[0:kt, :] over the chunk's kChunk rows
// on the tensor cores. kt is a multiple of 8; `first` starts the sum at
// zero, else it continues from enc (W streamed in tiles). Warp w owns the
// m-tiles w%2, w%2+2, ... and the column tiles w/2, w/2+4, ... kExactX as
// for encode_cols.
template <bool kExactX>
__device__ __forceinline__ void encode_tile(const float* x, int xs, const float* wt, int ws, int k0,
                                            int kt, float* enc, int H, bool first) {
  const int warp = threadIdx.x >> 5, n_tiles = (H + 7) / 8;
  for (int mt = warp & 1; mt < kChunk / 16; mt += 2) {
    for (int j0 = warp >> 1; j0 < n_tiles; j0 += 4 * kNPass) {
      switch (min(kNPass, (n_tiles - j0 + 3) / 4)) {  // the tiles of this pass, uniform in the warp
        case 4:
          encode_cols<4, kExactX>(x + k0, xs, wt, ws, kt, j0, enc, mt * 16, H, first);
          break;
        case 3:
          encode_cols<3, kExactX>(x + k0, xs, wt, ws, kt, j0, enc, mt * 16, H, first);
          break;
        case 2:
          encode_cols<2, kExactX>(x + k0, xs, wt, ws, kt, j0, enc, mt * 16, H, first);
          break;
        default:
          encode_cols<1, kExactX>(x + k0, xs, wt, ws, kt, j0, enc, mt * 16, H, first);
      }
    }
  }
}

// In place: enc_c = tanh((enc_c - mean) * rsqrt(var + eps) * scale + bias),
// times the dropout keep mask's row drop[c] when drop is given (training:
// [n, H], pre-scaled by 1/keep, as the JAX kernel applies it after tanh),
// and, if mask is given, the masked score s_c = <enc_c, attn>
// (s*m + (1-m)*NINF) for the chunk's n contexts, mask values from shared memory.
// Warp w takes contexts w, w+8, ... together, parameters from shared memory.
__device__ __forceinline__ void ln_tanh_score(float* enc, int n, int H, const float* par,
                                              const float* __restrict__ mask, float* s,
                                              const float* __restrict__ drop) {
  constexpr int R = kChunk / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_h = 1.f / (float)H;
  float* row[R];
  float mu[R], r[R], acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    row[q] = enc + (size_t)(warp + kWarps * q) * H;
    acc[q] = 0.f;
  }
  for (int h = lane; h < H; h += 32) {
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] += row[q][h];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    mu[q] = c2v::warp_sum(acc[q]) * inv_h;
    acc[q] = 0.f;
  }
  for (int h = lane; h < H; h += 32) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float d = row[q][h] - mu[q];
      acc[q] = fmaf(d, d, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    r[q] = rsqrtf(c2v::warp_sum(acc[q]) * inv_h + kLnEps);
    acc[q] = 0.f;
  }
  for (int h = lane; h < H; h += 32) {
    const float ls = par[h], lb = par[H + h], at = par[2 * H + h];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float v = tanhf((row[q][h] - mu[q]) * r[q] * ls + lb);
      const int c = warp + kWarps * q;
      if (drop && c < n) v *= __ldg(drop + (size_t)c * H + h);
      row[q][h] = v;
      acc[q] = fmaf(v, at, acc[q]);
    }
  }
  if (mask == nullptr) return;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float v = c2v::warp_sum(acc[q]);
    const int c = warp + kWarps * q;
    if (lane == 0 && c < n) {
      const float mk = mask[c];
      s[c] = v * mk + (1.f - mk) * c2v::kNinf;
    }
  }
}

// The chunk loop of CTA blockIdx.x of batch row blockIdx.y: gather, encode,
// LayerNorm+tanh (times the keep mask `drop` [B, L, H] when given) and
// (with a mask) score chunks blockIdx.x, +gridDim.x, ...
// into m.enc / m.s, calling fold(base, n) with every thread on each
// (contexts base .. base+n; ends synchronised). attn may be nullptr when
// there is no mask. The copy warps issue chunk c+S's copies while the
// encode warps encode chunk c.
template <class Rows, class Fold>
__device__ __forceinline__ void stream_chunks(const Rows& rows, const Layout& ly, const Smem& m,
                                              const float* __restrict__ W,
                                              const float* __restrict__ lns,
                                              const float* __restrict__ lnb,
                                              const float* __restrict__ attn,
                                              const float* __restrict__ mask,
                                              const float* __restrict__ drop, Fold fold) {
  using T = typename Rows::T;
  constexpr bool kWiden = sizeof(T) != 4;
  // a widened bf16 row is exact in TF32: two products (encode_cols)
  constexpr bool kExactX = std::is_same<T, __nv_bfloat16>::value;
  const int b = blockIdx.y, S = gridDim.x, H = ly.H;
  const bool copier = threadIdx.x >= kThreads;
  // Zero the pad columns D..xs of the f32 rows and H..ws of W: no copy
  // writes them and the encode reads them.
  {
    float* x = kWiden ? m.x : reinterpret_cast<float*>(m.rows);
    const int pad_x = ly.xs - ly.D, pad_w = ly.ws - H;
    for (int i = threadIdx.x; i < (kWiden ? 1 : kBuf) * kChunk * pad_x; i += blockDim.x) {
      x[(size_t)(i / pad_x) * ly.xs + ly.D + i % pad_x] = 0.f;
    }
    const int w_rows = ly.resident ? ly.Dp : 2 * kTileK;
    for (int i = threadIdx.x; i < w_rows * pad_w; i += blockDim.x) {
      m.w[(size_t)(i / pad_w) * ly.ws + H + i % pad_w] = 0.f;
    }
  }
  if (ly.resident) issue_w(W, ly, m.w, 0, ly.Dp, blockDim.x);
  long long id_next = 0;
  if (copier) {
    issue_rows(rows, ly, m, mask, 0, blockIdx.x, load_id(rows, ly, b, blockIdx.x));
    if (blockIdx.x + S < ly.n_chunks) id_next = load_id(rows, ly, b, blockIdx.x + S);
  }
  commit();
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    m.par[h] = lns[h];
    m.par[H + h] = lnb[h];
    m.par[2 * H + h] = attn ? attn[h] : 0.f;
  }
  wait_copies<0>();
  __syncthreads();
  const int n_tiles = (ly.Dp + kTileK - 1) / kTileK;
  for (int i = 0, c = blockIdx.x; c < ly.n_chunks; ++i, c += S) {
    const int buf = i % kBuf, base = c * kChunk, n = min(kChunk, ly.L - base);
    if (copier) {
      if (c + S < ly.n_chunks) {
        issue_rows(rows, ly, m, mask, (i + 1) % kBuf, c + S, id_next);
        if (c + 2 * S < ly.n_chunks) id_next = load_id(rows, ly, b, c + 2 * S);
      }
      commit();
    } else {
      const float* x =
          kWiden ? m.x : reinterpret_cast<const float*>(m.rows + (size_t)buf * kChunk * ly.stride);
      if (kWiden) {
        widen_rows<T>(ly, m, buf, n);
        encode_sync();
      }
      if (ly.resident) {
        encode_tile<kExactX>(x, ly.xs, m.w, ly.ws, 0, ly.Dp, m.enc, H, true);
      } else {
        issue_w(W, ly, m.w, 0, kTileK, kThreads);
        commit();
        for (int t = 0; t < n_tiles; ++t) {
          const int k0 = t * kTileK;
          if (t + 1 < n_tiles) {
            issue_w(W, ly, m.w + (size_t)((t + 1) % 2) * kTileK * ly.ws, k0 + kTileK, kTileK,
                    kThreads);
            commit();
            wait_copies<1>();
          } else {
            wait_copies<0>();
          }
          encode_sync();
          encode_tile<kExactX>(x, ly.xs, m.w + (size_t)(t % 2) * kTileK * ly.ws, ly.ws, k0,
                               min(kTileK, ly.Dp - k0), m.enc, H, t == 0);
          encode_sync();
        }
      }
      encode_sync();
      ln_tanh_score(m.enc, n, H, m.par, mask ? m.mk + buf * kChunk : nullptr, m.s,
                    drop ? drop + ((size_t)b * ly.L + base) * H : nullptr);
    }
    __syncthreads();
    fold(base, n);
    if (copier) wait_copies<0>();
    __syncthreads();
  }
}

// K3 and K4 online (fused_encode_pool.py:389-414): gridDim.x = S CTAs per
// batch row. CTA s streams chunks s, s+S, s+2S, ... and writes each
// chunk's own partial (m_c, d_c, acc_c[H]) to part[b][c] and its raw masked
// scores to w; pool_combine_kernel merges the row's partials in chunk
// order and normalises w (:440-442), so S changes no bit of the result.
template <class Rows>
__global__ void __launch_bounds__(kBlock, 1)
    encode_pool_online_kernel(Rows rows, Layout ly, const float* __restrict__ mask,
                              const float* __restrict__ drop,
                              const float* __restrict__ W, const float* __restrict__ lns,
                              const float* __restrict__ lnb, const float* __restrict__ attn,
                              float* __restrict__ w, float* __restrict__ part) {
  extern __shared__ __align__(16) char smem[];
  const Smem m = carve(smem, ly);
  const int b = blockIdx.y, H = ly.H;
  const size_t row0 = (size_t)b * ly.L;
  float* part_b = part + (size_t)b * ly.n_chunks * (H + 2);
  stream_chunks(rows, ly, m, W, lns, lnb, attn, mask, drop, [&](int base, int n) {
    c2v::pool_chunk_partial(m.enc, m.s, n, H, m.st, part_b + (size_t)(base / kChunk) * (H + 2),
                            w + row0 + base, nullptr);
  });
}

// K4 two_pass, pass A (fused_encode_pool.py:416-425): gather, encode (times
// the keep mask `drop` [B, L, H] when given, so the scores are those of the
// rows pass B sums) and score every chunk; the masked scores go to w, each
// CTA's max to rowmax[b][s].
template <class Rows>
__global__ void __launch_bounds__(kBlock, 1)
    encode_score_kernel(Rows rows, Layout ly, const float* __restrict__ mask,
                        const float* __restrict__ drop,
                        const float* __restrict__ W, const float* __restrict__ lns,
                        const float* __restrict__ lnb, const float* __restrict__ attn,
                        float* __restrict__ w, float* __restrict__ rowmax) {
  extern __shared__ __align__(16) char smem[];
  const Smem m = carve(smem, ly);
  const int b = blockIdx.y, H = ly.H;
  const size_t row0 = (size_t)b * ly.L;
  float mx = -INFINITY;  // meaningful in warp 0
  stream_chunks(rows, ly, m, W, lns, lnb, attn, mask, drop, [&](int base, int n) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float sc = lane < n ? m.s[lane] : -INFINITY;
      if (lane < n) w[row0 + base + lane] = sc;
      mx = fmaxf(mx, c2v::warp_max(sc));
    }
    __syncthreads();
  });
  if (threadIdx.x == 0) rowmax[(size_t)b * gridDim.x + blockIdx.x] = mx;
}

// K4 two_pass, pass B (:426-438): the row max is fixed by pass A, so each
// chunk is re-gathered and re-encoded (times the same keep-mask rows as in
// pass A; stream_chunks indexes `drop` by the chunk's own base, so every
// CTA of a row reads its chunks' rows) and summed as exp(w - M) * enc with
// no rescaling, its denominator d_c = sum exp(w - M) beside it. The
// chunks' partials (acc_c, M, d_c) are merged by pool_combine_kernel as in
// online.
template <class Rows>
__global__ void __launch_bounds__(kBlock, 1)
    encode_pool_fixed_max_kernel(Rows rows, Layout ly, const float* __restrict__ drop,
                                 const float* __restrict__ W,
                                 const float* __restrict__ lns, const float* __restrict__ lnb,
                                 const float* __restrict__ rowmax, float* __restrict__ w,
                                 float* __restrict__ part) {
  extern __shared__ __align__(16) char smem[];
  const Smem m = carve(smem, ly);
  const int b = blockIdx.y, H = ly.H;
  const size_t row0 = (size_t)b * ly.L;
  float* part_b = part + (size_t)b * ly.n_chunks * (H + 2);
  if (threadIdx.x == 0) {  // read after stream_chunks' first barrier
    float mx = -INFINITY;
    for (int i = 0; i < (int)gridDim.x; ++i) mx = fmaxf(mx, rowmax[(size_t)b * gridDim.x + i]);
    m.st.stat[0] = mx;
  }
  stream_chunks(rows, ly, m, W, lns, lnb, nullptr, nullptr, drop, [&](int base, int n) {
    c2v::pool_chunk_partial(m.enc, nullptr, n, H, m.st,
                            part_b + (size_t)(base / kChunk) * (H + 2), w + row0 + base,
                            m.st.stat);
  });
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// mode: 0 = online (one kernel), 1 = two_pass (pass A, pass B); then the
// combine over the chunk partials of each row. `part` is [B, chunks, H + 2]
// (chunks = ceil(L / kChunk)), `rowmax` [B, S] (two_pass only); `drop` the
// [B, L, H] keep mask or null (both modes; two_pass reads it in both
// passes).
template <class Rows>
int launch_stream(const Rows& rows, int mode, const float* mask, const float* drop,
                  const float* W, const float* lns, const float* lnb, const float* attn,
                  float* cv, float* w,
                  float* part, float* rowmax, int B, int L, int Et, int Ep, int H, int S,
                  void* stream) {
  if (B < 1 || B > 65535 || L < 1 || Et < 1 || Ep < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Layout ly = make_layout(rows, W, L, Et, Ep, H);
  if (ly.smem > (int)c2v::kMaxSmem || S < 1 || S > ly.n_chunks || part == nullptr ||
      (mode != 0 && mode != 1) || (mode == 1 && rowmax == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (const int pending = c2v::pending_error()) return pending;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(S, B);
  cudaError_t err;
  if (mode == 0) {
    if ((err = allow_smem(encode_pool_online_kernel<Rows>, ly.smem))) return (int)err;
    encode_pool_online_kernel<Rows><<<grid, kBlock, ly.smem, s>>>(rows, ly, mask, drop, W, lns,
                                                                     lnb, attn, w, part);
    if ((err = cudaGetLastError())) return (int)err;
  } else {
    if ((err = allow_smem(encode_score_kernel<Rows>, ly.smem))) return (int)err;
    if ((err = allow_smem(encode_pool_fixed_max_kernel<Rows>, ly.smem))) return (int)err;
    encode_score_kernel<Rows><<<grid, kBlock, ly.smem, s>>>(rows, ly, mask, drop, W, lns, lnb,
                                                               attn, w, rowmax);
    if ((err = cudaGetLastError())) return (int)err;
    encode_pool_fixed_max_kernel<Rows><<<grid, kBlock, ly.smem, s>>>(rows, ly, drop, W, lns,
                                                                        lnb, rowmax, w, part);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return (int)c2v::launch_combine(part, ly.n_chunks, B, L, H, cv, w, s);
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

// K2: rows gathered before the kernel, row_dtype 0 = f32, 1 = bf16 (widened
// in shared memory, two TF32 products); K4's online kernel on S CTAs per
// batch row (1 <= S <= chunks of kChunk), `part` the [B, chunks, H + 2]
// workspace, `drop` the [B, L, H] keep mask or null.
// Returns the launch's cudaError_t.
int c2v_encode_pool_gathered(int row_dtype, const void* gs, const void* gp, const void* ge,
                             const float* mask, const float* drop, const float* W,
                             const float* lns, const float* lnb, const float* attn, float* cv,
                             float* w, float* part, int B, int L, int Et, int Ep, int H, int S,
                             void* stream) {
  if (row_dtype == 1) {
    using R = GatheredRows<__nv_bfloat16>;
    return launch_stream(R{(const __nv_bfloat16*)gs, (const __nv_bfloat16*)gp,
                           (const __nv_bfloat16*)ge},
                         0, mask, drop, W, lns, lnb, attn, cv, w, part, nullptr, B, L, Et, Ep, H,
                         S, stream);
  }
  if (row_dtype != 0) return (int)cudaErrorInvalidValue;
  using R = GatheredRows<float>;
  return launch_stream(R{(const float*)gs, (const float*)gp, (const float*)ge}, 0, mask, drop, W,
                       lns, lnb, attn, cv, w, part, nullptr, B, L, Et, Ep, H, S, stream);
}

// K3: rows gathered in the kernel. table_dtype: 0 = f32, 1 = bf16,
// 2 = int8 (+ per-row f32 scales ts/ps); S, `part` and `drop` as for K2.
// Returns the launch's cudaError_t.
int c2v_encode_pool_fused(int table_dtype, const void* tv, const float* ts, const void* pv,
                          const float* ps, long long vt, long long vp, const int* starts,
                          const int* paths, const int* ends, const float* mask,
                          const float* drop, const float* W, const float* lns, const float* lnb,
                          const float* attn, float* cv, float* w, float* part, int B, int L,
                          int Et, int Ep, int H, int S, void* stream) {
  return with_table_rows(table_dtype, tv, ts, pv, ps, vt, vp, starts, paths, ends,
                         [&](const auto& rows) {
                           return launch_stream(rows, 0, mask, drop, W, lns, lnb, attn, cv, w,
                                                part, nullptr, B, L, Et, Ep, H, S, stream);
                         });
}

// K4: the streamed-softmax chain with the gather inside. mode: 0 = online,
// 1 = two_pass; S CTAs per batch row (1 <= S <= chunks of kChunk); `part`
// [B, chunks, H + 2] and, for two_pass, `rowmax` [B, S] are workspaces; `drop`
// as for K2, in either mode (two_pass applies it in both passes).
// table_dtype as for K3. Returns the launches' cudaError_t.
int c2v_encode_pool_stream(int mode, int table_dtype, const void* tv, const float* ts,
                           const void* pv, const float* ps, long long vt, long long vp,
                           const int* starts, const int* paths, const int* ends,
                           const float* mask, const float* drop, const float* W,
                           const float* lns, const float* lnb,
                           const float* attn, float* cv, float* w, float* part, float* rowmax,
                           int B, int L, int Et, int Ep, int H, int S, void* stream) {
  return with_table_rows(table_dtype, tv, ts, pv, ps, vt, vp, starts, paths, ends,
                         [&](const auto& rows) {
                           return launch_stream(rows, mode, mask, drop, W, lns, lnb, attn, cv, w,
                                                part, rowmax, B, L, Et, Ep, H, S, stream);
                         });
}

}  // extern "C"
