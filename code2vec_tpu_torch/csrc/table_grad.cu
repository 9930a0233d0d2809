// K6: the dense embedding tables' gradient.
//
// Replaces no TPU kernel: the JAX package leaves the tables' backward to
// XLA's scatter-add (code2vec_tpu/ops/embed.py, grad_mode "dense"). The port
// ran F.embedding's CUDA backward, which cuts each id's sorted run into
// partial segments of a few rows and then sums one id's partials in a serial
// loop, one thread a column. Every PAD slot of a bag carries id 0, so a third
// of a step's slots form one run, and one thread walked ~15,000 partials of it
// while the rest of the card waited.
//
//   grad[v, :] = sum of rows[i, :] over the slots i with ids[i] == v   (f32)
//
// and zero for a row no slot names. In: ids int32 or int64 [N], rows f32
// [N, E]. Out: grad f32 [V, E]. One call of c2v_table_grad, one workspace.
//
// Bound on an H100: bytes. Each row is read once (N * E * 4) and the table's
// gradient written once (V * E * 4): 527 MB for top11's two tables a step,
// 0.157 ms at 3.35 TB/s. Design: a stable sort, then levels of chunks, so that
// no thread sums more than one chunk of a run.
//
// - The ids are sorted stably with their slots (cub's radix sort over the bits
//   of V - 1 only: 3 passes at top11's vocabularies, not 4), inside this call,
//   so that the wrapper's host work is one call (the host sets the pace of a
//   top11 step once K6 runs).
// - Level 0 cuts the sorted slots into chunks of kChunk. A warp sums its chunk
//   in sorted order, a float4 of columns a lane (a float when E % 4 != 0 or a
//   pointer is not 16-byte aligned), kBatch rows' loads in flight. More warps
//   hide the loads' latency better than more loads a warp: at top11's terminal
//   shapes, 4 loads at 4 CTAs an SM took 0.11 ms, 8 at 2 CTAs 0.15 ms, 16 at one
//   0.26 ms (H100). A run of equal ids that lies inside the chunk is written to
//   its table row. The piece of a run that crosses the chunk's first or last
//   edge goes to item 2c (the chunk's first run) or 2c + 1 (its last run, when
//   another) of the next level, with the run's id; an unused item has id -1.
// - Each later level is the same kernel over the items of the level below (two
//   a chunk), unused ones skipped. Its runs are the crossing runs' pieces, so a
//   run of any length is summed in O(log_16 N) levels of at most kChunk steps
//   each; the last level fits in one chunk and writes every run it holds.
// - A run's items lie at most two apart at every level (a chunk that a run
//   fills hands on one item and leaves its second unused), so ids[lo - 1] and
//   ids[lo - 2] say whether the chunk's first run began before it, ids[hi] and
//   ids[hi + 1] whether its last run goes on.
// - Each id's sum is written once, by the level at which its run first lies
//   inside one chunk. The order of every sum follows from the sorted ids alone
//   and no float is added atomically, so two calls give the same bits.
// - Rows no slot names: one cudaMemsetAsync of grad ahead of the levels.
// - split_rows (when given): level 0 adds the count of rows in runs longer
//   than one chunk, the runs the later levels finish (an integer atomic).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kChunk = 32;  // items a warp sums in order: one id a lane
constexpr int kWarps = 8;   // chunks a CTA
constexpr int kCtasPerSm = 4;  // 64 registers a thread, 32 warps an SM
constexpr int kBatch = 4;   // a lane's row loads in flight
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
struct Cols;
template <>
struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const T& v) { *p = v; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};

// Write the sum `acc` of run `id` where it goes: the next level's item 2c
// (on0) or 2c + 1 (on1), else its table row.
template <int VEC>
__device__ __forceinline__ void write_run(const typename Cols<VEC>::T& acc, int id, int on0,
                                          int on1, long long c, int col, bool active, int E,
                                          int V, float* grad, float* next_vals) {
  float* dst = id == on0   ? next_vals + (2 * c) * E
               : id == on1 ? next_vals + (2 * c + 1) * E
               : id < V    ? grad + (long long)id * E
                           : nullptr;
  if (dst != nullptr && active) Cols<VEC>::store(dst + col, acc);
}

// The rows [start, end) of the chunk at lo when their run (of `id`) is
// longer than one chunk, else 0 (level 0: no unused items).
__device__ __forceinline__ int longer_run(const int* ids, long long m, long long lo, int id,
                                          int start, int end, int first, bool before, int last,
                                          bool after) {
  const bool from = id == first && before, to = id == last && after;
  bool longer = from && to;
  if (from != to) {
    const long long at = from ? lo + end - 1 - kChunk : lo + start + kChunk;
    longer = at >= 0 && at < m && ids[at] == id;
  }
  return longer ? end - start : 0;
}

// One level: a warp a chunk of items [lo, lo + n). ids: [m] (sorted, -1 =
// unused); src: the row of each item in vals (level 0: perm; later: null, the
// item itself); next_ids / next_vals: the next level's [2 * chunks] items, null
// on the last level; split_rows: level 0 only, or null.
template <int VEC>
__global__ void __launch_bounds__(kWarps * 32, kCtasPerSm)
    table_grad_level(const int* __restrict__ ids, const int* __restrict__ src,
                     const float* __restrict__ vals, long long m, int E, int V,
                     float* __restrict__ grad, int* __restrict__ next_ids,
                     float* __restrict__ next_vals, unsigned long long* __restrict__ split_rows) {
  using C = Cols<VEC>;
  using T = typename C::T;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long lo = c * kChunk;
  if (lo >= m) return;
  const int n = (int)(m - lo < kChunk ? m - lo : kChunk);
  const long long hi = lo + n;
  const int my_id = lane < n ? ids[lo + lane] : -1;
  const int my_src = lane < n ? (src ? src[lo + lane] : (int)(lo + lane)) : 0;
  const unsigned used = __ballot_sync(kFull, my_id >= 0);
  if (used == 0) {
    if (next_ids != nullptr && lane < 2) next_ids[2 * c + lane] = -1;
    return;
  }
  const int first = __shfl_sync(kFull, my_id, __ffs(used) - 1);
  const int last = __shfl_sync(kFull, my_id, 31 - __clz(used));
  const bool before = (lo >= 1 && ids[lo - 1] == first) || (lo >= 2 && ids[lo - 2] == first);
  const bool after = (hi < m && ids[hi] == last) || (hi + 1 < m && ids[hi + 1] == last);
  // the runs handed on: the first run to item 2c, the last (when another) to 2c + 1
  const int on0 = (before || (after && last == first)) ? first : -1;
  const int on1 = (after && last != first) ? last : -1;
  if (next_ids != nullptr && lane == 0) {
    next_ids[2 * c] = on0;
    next_ids[2 * c + 1] = on1;
  }
  unsigned long long split = 0;
  for (int col0 = 0; col0 < E; col0 += 32 * VEC) {
    const int col = col0 + lane * VEC;
    const bool active = col < E;
    T acc = C::zero();
    int cur = -1, start = 0;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      T buf[kBatch];
      int id[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u;
        id[u] = __shfl_sync(kFull, my_id, j & 31);
        const int s = __shfl_sync(kFull, my_src, j & 31);
        buf[u] = (j < n && id[u] >= 0 && active) ? C::load(vals + (long long)s * E + col)
                                                 : C::zero();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u;
        if (j >= n) break;
        if (id[u] < 0) continue;
        if (id[u] != cur) {
          if (cur >= 0) {
            write_run<VEC>(acc, cur, on0, on1, c, col, active, E, V, grad, next_vals);
            if (split_rows != nullptr && col0 == 0)
              split += longer_run(ids, m, lo, cur, start, j, first, before, last, after);
          }
          cur = id[u];
          start = j;
          acc = buf[u];
        } else {
          C::add(acc, buf[u]);
        }
      }
    }
    write_run<VEC>(acc, cur, on0, on1, c, col, active, E, V, grad, next_vals);
    if (split_rows != nullptr && col0 == 0)
      split += longer_run(ids, m, lo, cur, start, n, first, before, last, after);
  }
  if (split != 0 && lane == 0) atomicAdd(split_rows, split);
}

// keys[i] = ids[i] (int32 or int64 ids), pos[i] = i: the sort's input.
__global__ void init_keys(const void* __restrict__ ids, int ids64, long long n,
                          unsigned* __restrict__ keys, int* __restrict__ pos) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    keys[i] = ids64 ? (unsigned)((const long long*)ids)[i] : (unsigned)((const int*)ids)[i];
    pos[i] = (int)i;
  }
}

// The bits of an id below V: the radix sort's passes.
int id_bits(int V) {
  int bits = 1;
  while (bits < 31 && (1LL << bits) < (long long)V) ++bits;
  return bits;
}

// The items of every level after the first for n sorted slots.
long long level_items(long long n) {
  long long items = 0;
  for (long long m = n; m > kChunk;) {
    m = 2 * ((m + kChunk - 1) / kChunk);
    items += m;
  }
  return items;
}

size_t align256(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

// The workspace, in order: keys in and out, positions in and out, the radix
// sort's scratch, the later levels' ids and rows.
struct Workspace {
  unsigned *keys, *sorted;
  int *pos, *perm;
  void* scratch;
  size_t scratch_bytes;
  int* ids;
  float* vals;
  size_t bytes;
};

cudaError_t carve(char* base, long long n, int E, int V, Workspace& w) {
  w.scratch_bytes = 0;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, w.scratch_bytes, (const unsigned*)nullptr, (unsigned*)nullptr, (const int*)nullptr,
      (int*)nullptr, (int)n, 0, id_bits(V));
  const size_t keys = align256(sizeof(int) * (size_t)n);
  const long long items = level_items(n);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += align256(bytes);
    return p;
  };
  w.keys = (unsigned*)take(keys);
  w.sorted = (unsigned*)take(keys);
  w.pos = (int*)take(keys);
  w.perm = (int*)take(keys);
  w.scratch = take(w.scratch_bytes);
  w.ids = (int*)take(sizeof(int) * (size_t)items);
  w.vals = (float*)take(sizeof(float) * (size_t)items * (size_t)E);
  w.bytes = at;
  return err;
}

template <int VEC>
cudaError_t launch_levels(const int* sorted_ids, const int* perm, const float* rows, long long n,
                          int E, int V, float* grad, int* ws_ids, float* ws_vals,
                          unsigned long long* split_rows, cudaStream_t s) {
  const int* ids = sorted_ids;
  const int* src = perm;
  const float* vals = rows;
  for (long long m = n; m > 0;) {
    const long long chunks = (m + kChunk - 1) / kChunk;
    const bool last = m <= kChunk;
    table_grad_level<VEC><<<(unsigned)((chunks + kWarps - 1) / kWarps), kWarps * 32, 0, s>>>(
        ids, src, vals, m, E, V, grad, last ? nullptr : ws_ids, last ? nullptr : ws_vals,
        ids == sorted_ids ? split_rows : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    ids = ws_ids;
    src = nullptr;
    vals = ws_vals;
    m = 2 * chunks;
    ws_ids += m;
    ws_vals += m * E;
  }
  return cudaSuccess;
}

cudaError_t table_grad(const void* ids, int ids64, const float* rows, long long n, int E, int V,
                       float* grad, void* workspace, long long workspace_bytes,
                       unsigned long long* split_rows, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)V * (size_t)E, s);
  if (err != cudaSuccess || n == 0) return err;
  Workspace w;
  if ((err = carve((char*)workspace, n, E, V, w)) != cudaSuccess) return err;
  if ((long long)w.bytes > workspace_bytes) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  init_keys<<<blocks, 256, 0, s>>>(ids, ids64, n, w.keys, w.pos);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cub::DeviceRadixSort::SortPairs(w.scratch, w.scratch_bytes, w.keys, w.sorted, w.pos,
                                        w.perm, (int)n, 0, id_bits(V), s);
  if (err != cudaSuccess) return err;
  const int* sorted = (const int*)w.sorted;
  const bool vec = E % 4 == 0 && (uintptr_t)rows % 16 == 0 && (uintptr_t)grad % 16 == 0;
  return vec ? launch_levels<4>(sorted, w.perm, rows, n, E, V, grad, w.ids, w.vals, split_rows, s)
             : launch_levels<1>(sorted, w.perm, rows, n, E, V, grad, w.ids, w.vals, split_rows, s);
}

}  // namespace

extern "C" {

const char* c2v_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The bytes of workspace c2v_table_grad takes for n slots of width E into V
// rows (the sort's keys and positions, its scratch, the later levels' items),
// or -1 when the sort cannot size its scratch.
long long c2v_table_grad_workspace(long long n, int E, int V) {
  if (n < 0 || n >= (1LL << 31) || E < 1 || V < 0 || (n > 0 && V < 1)) return -1;
  if (n == 0) return 0;
  Workspace w;
  return carve(nullptr, n, E, V, w) == cudaSuccess ? (long long)w.bytes : -1;
}

// Launch K6 on `stream` of `device`: zero grad [V, E], sort the ids (int32, or
// int64 when ids64) with their slots, then sum the rows of each id level by
// level. Returns the launches' cudaError_t, or the negated code of an error
// already pending before them.
int c2v_table_grad(const void* ids, int ids64, const float* rows, long long n, int E, int V,
                   float* grad, void* workspace, long long workspace_bytes,
                   unsigned long long* split_rows, int device, void* stream) {
  if (n < 0 || n >= (1LL << 31) || E < 1 || V < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return -(int)pending;
  int current = device;
  if (cudaGetDevice(&current) != cudaSuccess) return (int)cudaGetLastError();
  if (current != device && cudaSetDevice(device) != cudaSuccess) return (int)cudaGetLastError();
  const cudaError_t err = table_grad(ids, ids64, rows, n, E, V, grad, workspace, workspace_bytes,
                                     split_rows, (cudaStream_t)stream);
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
