// Sorted segment sum of full_adam's dense accumulation, for sm_90a.
//
//   out[v] = sum over the entries e with rows[e] == v of term(e),
//   term(e) = weights[e] * grad[instance(e)]   (rounded as described below)
//
// Replaces no Pallas kernel: the JAX package leaves this sum to XLA's
// sorted segment sum (cunvsm_tpu/optim/updates.py:_sorted_segment_accumulate),
// and the reference scatters with atomicAdd (update_repr_kernel,
// storage.cu:37-49).  The port's index_add_ did the same with float atomics,
// one launch per window slot; under the Zipf head of the word table a few
// hundred addresses took thousands of atomic adds each.
//
// The caller (cunvsm_torch/ops/segment_kernels.py) sorts the entries of all
// of a table's descriptors by row, stably, and finds the row offsets with a
// binary search; this file holds the two passes that sum.  Every output row
// is written exactly once, empty rows as zeros, with no atomics, and every
// add runs in a fixed order, so two runs give the same bits.  The sorted
// array is cut into aligned chunks [p * chunk, (p + 1) * chunk):
//
// - A row that lies in one chunk is summed term by term in sorted order
//   from 0 and written.
// - A row that crosses a chunk boundary is cut there into pieces, each
//   summed the same way.  A chunk holds at most two such pieces: slot 2p the
//   piece of a row that began in an earlier chunk, slot 2p + 1 that of a row
//   that begins in this one and goes on.  The second pass sums each such
//   row's pieces in chunk order from 0.
//
// Rounding, as the plain version (segment_kernels.py:segment_sum_plain) and
// the index_add_ path compute it: under bfloat16 streams the gradient row and
// the weight are rounded to bfloat16 (round to nearest even), their product
// is rounded to bfloat16 and widened; under float32 streams the product is
// one float32 multiply.  Every multiply and add is an _rn intrinsic, which
// the compiler never contracts into an FMA.
//
// What bounds it: the gathered gradient rows and their latency.  Each entry
// reads a row of d floats (512,000 rows of 1,200 B for the canonical word
// table, much of it from L2: 10 window slots share an instance's row), and
// the pass writes every row of the table once (78.6 MB for the word table,
// 268 MB for the entity table).
//
// Design:
// - One warp per chunk: every warp of the first pass sums the same number
//   of entries, whatever the rows' lengths, so the Zipf head neither
//   serializes a warp nor leaves short rows to warps that wait on one load
//   each.  Items are the chunks, then blocks of 32 rows, whose empty rows
//   a warp writes as zeros; a warp takes kItems of them, a grid's worth of
//   warps apart, its lanes resolving their bounds at once.
// - Each lane holds VEC consecutive floats of SLOTS column groups (VEC = 4:
//   16-byte loads, when the rows are 16-byte aligned); rows wider than
//   32 * VEC * SLOTS columns take more column tiles (blockIdx.y).
// - Lane j reads entry j's row, position, descriptor, gradient row and
//   weight for a batch of 32 entries, the next batch's ahead, and the warp
//   shares them by shuffles.  A round issues the (predicated) row loads of
//   kUnroll entries before it adds any, so kUnroll rows are in flight per
//   warp; a change of row between two terms writes the finished sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // warps per block
constexpr int kItems = 8;     // items per warp
constexpr int kUnroll = 8;    // terms loaded before they are added
constexpr int kCombine = 16;  // pieces loaded before they are added

struct Desc {
  const float* grad;     // [instances, dim]
  const float* weights;  // [instances * window], or null
  long long start;       // its first entry in the concatenation of all entries
  int window;
};

struct Args {
  const int* rows;        // [n] entry rows, ascending
  const long long* perm;  // [n] the entry at each sorted position
  const int* offsets;     // [num_rows + 1] first sorted position of each row
  Desc desc[3];           // unused slots start at LLONG_MAX
  int bf16_stream;
  int weighted;           // some descriptor has weights
  long long num_rows;
  long long dim;
  long long chunk;
  long long num_chunks;
  float* out;             // [num_rows, dim]
  float* partials;        // [2 * num_chunks, dim]
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Each value rounded to bfloat16 and widened, two at a time where it can.
template <int VEC>
__device__ __forceinline__ void round_bf16(float (&x)[VEC]) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const float2 r = __bfloat1622float2(__float22bfloat162_rn(make_float2(x[j], x[j + 1])));
      x[j] = r.x;
      x[j + 1] = r.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = round_bf16(x[j]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = __ldg(p + j);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = x[j];
  }
}

template <int VEC, int SLOTS>
__device__ __forceinline__ void zero(float (&acc)[SLOTS][VEC]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[s][j] = 0.0f;
}

// This lane's columns of a row where `take`; x is left as it was elsewhere
// (a lane past the row's end stores nothing, an entry not taken adds
// nothing), so that the loads are predicated and need no branch.
template <int VEC, int SLOTS>
__device__ __forceinline__ void load_row(const float* row, long long col0, long long dim, int lane,
                                         bool take, float (&x)[SLOTS][VEC]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const long long col = col0 + static_cast<long long>(s * 32 + lane) * VEC;
    if (take && col < dim) load_vec<VEC>(row + col, x[s]);
  }
}

template <int VEC, int SLOTS>
__device__ __forceinline__ void store_row(float* row, long long col0, long long dim, int lane,
                                          const float (&acc)[SLOTS][VEC]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const long long col = col0 + static_cast<long long>(s * 32 + lane) * VEC;
    if (col < dim) store_vec<VEC>(row + col, acc[s]);
  }
}

// One item: kind 0 nothing, 1 the chunk [s, e) of the sorted array, 2 the
// rows [v, v + 32), of which the empty ones are written as zeros, 3 the
// pieces of row `v`, entries [s, e).
struct Item {
  long long s, e, v;
  int kind;
};

__device__ __forceinline__ Item shfl_item(const Item& mine, int lane) {
  Item it;
  it.s = __shfl_sync(0xffffffffu, mine.s, lane);
  it.e = __shfl_sync(0xffffffffu, mine.e, lane);
  it.v = __shfl_sync(0xffffffffu, mine.v, lane);
  it.kind = __shfl_sync(0xffffffffu, mine.kind, lane);
  return it;
}

// First pass: the chunks, then the blocks of 32 rows.
__device__ Item resolve_sum_item(const Args& a, long long item, long long valid) {
  Item it{0, 0, 0, 0};
  if (item < a.num_chunks) {
    it.s = item * a.chunk;
    it.e = min(it.s + a.chunk, valid);
    it.kind = it.s < valid ? 1 : 0;
    return it;
  }
  it.v = 32 * (item - a.num_chunks);
  it.kind = it.v < a.num_rows ? 2 : 0;
  return it;
}

// Second pass: the row that begins in chunk p and goes on into the next.
__device__ Item resolve_combine_item(const Args& a, long long p, long long valid) {
  Item it{0, 0, 0, 0};
  const long long cs = p * a.chunk;
  if (p >= a.num_chunks || cs >= valid) return it;
  const long long ce = min(cs + a.chunk, valid);
  const int v = a.rows[ce - 1];
  const long long rs = a.offsets[v], re = a.offsets[v + 1];
  if (rs < cs || re <= ce) return it;
  it.s = rs;
  it.e = re;
  it.v = v;
  it.kind = 3;
  return it;
}

// The gradient row of the entry at concatenated position src and, where the
// table's descriptors carry weights, its weight (1 for a descriptor
// without), at stream width.
template <bool BF16, bool WEIGHTED>
__device__ __forceinline__ void resolve_entry(const Args& a, long long src, const float*& row,
                                              float& w) {
  const int k = (src >= a.desc[1].start) + (src >= a.desc[2].start);
  const float* grad = k == 0 ? a.desc[0].grad : (k == 1 ? a.desc[1].grad : a.desc[2].grad);
  const long long start = k == 0 ? a.desc[0].start : (k == 1 ? a.desc[1].start : a.desc[2].start);
  const int window = k == 0 ? a.desc[0].window : (k == 1 ? a.desc[1].window : a.desc[2].window);
  const int local = static_cast<int>(src - start);
  row = grad + static_cast<long long>(local / window) * a.dim;
  w = 1.0f;
  if constexpr (WEIGHTED) {
    const float* weights =
        k == 0 ? a.desc[0].weights : (k == 1 ? a.desc[1].weights : a.desc[2].weights);
    if (weights != nullptr) w = __ldg(weights + local);
    if constexpr (BF16) w = round_bf16(w);
  }
}

// Where the finished sum of row v in chunk p goes: slot 2p of partials for
// the chunk's first row if it began in an earlier chunk, slot 2p + 1 for its
// last row if it goes on into the next, else row v of out.
struct ChunkEnds {
  long long p;
  int first, last;
  bool first_began, last_goes_on;

  __device__ float* dest(const Args& a, int v) const {
    if (v == first && first_began) return a.partials + 2 * p * a.dim;
    if (v == last && last_goes_on) return a.partials + (2 * p + 1) * a.dim;
    return a.out + static_cast<long long>(v) * a.dim;
  }
};

// The chunk [cs, ce) of the sorted array: each row's terms in order from 0,
// each finished sum written where `ends` says.  `src` and `row` are the
// position and the row of entry cs + lane, which the caller reads ahead.
// The product with the weight runs only where a descriptor has weights
// (with 1 it would change no bit).
template <int VEC, int SLOTS, bool BF16, bool WEIGHTED>
__device__ __forceinline__ void sum_chunk(const Args& a, long long cs, long long ce,
                                          const ChunkEnds& ends, long long src, int row,
                                          long long col0, int lane,
                                          float (&x)[kUnroll][SLOTS][VEC]) {
  int cur = ends.first;
  float acc[SLOTS][VEC];
  zero<VEC, SLOTS>(acc);
  for (long long batch = cs; batch < ce; batch += 32) {
    const long long ahead = min(batch + 32 + lane, ce - 1);
    const long long next_src = batch + 32 < ce ? a.perm[ahead] : 0;
    const int next_row = batch + 32 < ce ? a.rows[ahead] : 0;
    const float* mine_row;
    float mine_w;
    resolve_entry<BF16, WEIGHTED>(a, src, mine_row, mine_w);
    const long long mine_ptr = reinterpret_cast<long long>(mine_row);
    const int n = static_cast<int>(min(ce - batch, 32LL));
    for (int r = 0; r < n; r += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* grad_row =
            reinterpret_cast<const float*>(__shfl_sync(0xffffffffu, mine_ptr, r + u));
        load_row<VEC, SLOTS>(grad_row, col0, a.dim, lane, r + u < n, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w = __shfl_sync(0xffffffffu, mine_w, r + u);
        const int v = __shfl_sync(0xffffffffu, row, r + u);
        if (r + u >= n) break;
        if (v != cur) {
          store_row<VEC, SLOTS>(ends.dest(a, cur), col0, a.dim, lane, acc);
          zero<VEC, SLOTS>(acc);
          cur = v;
        }
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          if constexpr (BF16) round_bf16<VEC>(x[u][k]);
          if constexpr (WEIGHTED) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) x[u][k][j] = __fmul_rn(x[u][k][j], w);
            if constexpr (BF16) round_bf16<VEC>(x[u][k]);
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[k][j] = __fadd_rn(acc[k][j], x[u][k][j]);
        }
      }
    }
    src = next_src;
    row = next_row;
  }
  store_row<VEC, SLOTS>(ends.dest(a, cur), col0, a.dim, lane, acc);
}

template <int VEC, int SLOTS>
__device__ __forceinline__ void sum_chunk(const Args& a, long long cs, long long ce,
                                          long long valid, int lane, long long col0,
                                          float (&x)[kUnroll][SLOTS][VEC]) {
  ChunkEnds ends;
  ends.p = cs / a.chunk;
  ends.first = a.rows[cs];
  ends.last = a.rows[ce - 1];
  ends.first_began = cs > 0 && a.rows[cs - 1] == ends.first;
  ends.last_goes_on = ce < valid && a.rows[ce] == ends.last;
  const long long at = min(cs + lane, ce - 1);
  const long long src = a.perm[at];
  const int row = a.rows[at];
  if (a.bf16_stream) {
    if (a.weighted) sum_chunk<VEC, SLOTS, true, true>(a, cs, ce, ends, src, row, col0, lane, x);
    else sum_chunk<VEC, SLOTS, true, false>(a, cs, ce, ends, src, row, col0, lane, x);
  } else {
    if (a.weighted) sum_chunk<VEC, SLOTS, false, true>(a, cs, ce, ends, src, row, col0, lane, x);
    else sum_chunk<VEC, SLOTS, false, false>(a, cs, ce, ends, src, row, col0, lane, x);
  }
}

// Pass 1: every chunk's rows and pieces, every empty row's zeros.
template <int VEC, int SLOTS>
__global__ void __launch_bounds__(kWarps * 32) segment_sum_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long col0 = static_cast<long long>(blockIdx.y) * 32 * VEC * SLOTS;
  const long long valid = a.offsets[a.num_rows];
  Item mine{0, 0, 0, 0};
  if (lane < kItems) mine = resolve_sum_item(a, warp + lane * warps, valid);
  // The round buffer is zeroed once: a lane past the row's end keeps zeros
  // and an entry a round does not take keeps the last round's values, so
  // that nothing undefined is ever added.
  float x[kUnroll][SLOTS][VEC];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) zero<VEC, SLOTS>(x[u]);
  for (int t = 0; t < kItems; ++t) {
    const Item it = shfl_item(mine, t);
    if (it.kind == 1) {
      sum_chunk<VEC, SLOTS>(a, it.s, it.e, valid, lane, col0, x);
    } else if (it.kind == 2) {
      const long long v = it.v + lane;
      unsigned empty = __ballot_sync(0xffffffffu,
                                     v < a.num_rows && a.offsets[v] == a.offsets[v + 1]);
      float zeros[SLOTS][VEC];
      zero<VEC, SLOTS>(zeros);
      while (empty) {
        const int j = __ffs(empty) - 1;
        empty &= empty - 1;
        store_row<VEC, SLOTS>(a.out + (it.v + j) * a.dim, col0, a.dim, lane, zeros);
      }
    }
  }
}

// Pass 2: each row that crosses a chunk boundary, its pieces summed in chunk
// order from 0: slot 2q + 1 of its first chunk q, slot 2q of every later
// one.  A warp takes 32 * VEC columns of a row (blockIdx.y), so that
// kCombine pieces are in flight at once: the commonest word of the
// canonical table has about 240.
template <int VEC>
__global__ void __launch_bounds__(kWarps * 32) segment_combine_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long col0 = static_cast<long long>(blockIdx.y) * 32 * VEC;
  const long long valid = a.offsets[a.num_rows];
  Item mine{0, 0, 0, 0};
  if (lane < kItems) mine = resolve_combine_item(a, warp + lane * warps, valid);
  float x[kCombine][1][VEC];
#pragma unroll
  for (int u = 0; u < kCombine; ++u) zero<VEC, 1>(x[u]);
  for (int t = 0; t < kItems; ++t) {
    const Item it = shfl_item(mine, t);
    if (it.kind == 0) continue;
    const long long q0 = it.s / a.chunk, q1 = (it.e - 1) / a.chunk;
    float acc[1][VEC];
    zero<VEC, 1>(acc);
    for (long long base = q0; base <= q1; base += kCombine) {
#pragma unroll
      for (int u = 0; u < kCombine; ++u) {
        const long long q = base + u;
        const float* piece = a.partials + (q == q0 ? 2 * q + 1 : 2 * q) * a.dim;
        load_row<VEC, 1>(piece, col0, a.dim, lane, q <= q1, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kCombine; ++u) {
        if (base + u > q1) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[0][j] = __fadd_rn(acc[0][j], x[u][0][j]);
      }
    }
    store_row<VEC, 1>(a.out + it.v * a.dim, col0, a.dim, lane, acc);
  }
}

template <int VEC, int SLOTS>
int launch(const Args& a, cudaStream_t stream) {
  const long long cols = 32LL * VEC * SLOTS;
  const unsigned tiles = static_cast<unsigned>((a.dim + cols - 1) / cols);
  const long long per_block = static_cast<long long>(kWarps) * kItems;
  const long long items = a.num_chunks + (a.num_rows + 31) / 32;
  if (items > 0) {
    // At least one warp a chunk, so that no warp sums two.
    const long long warps = max((items + kItems - 1) / kItems, a.num_chunks);
    const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps), tiles);
    segment_sum_kernel<VEC, SLOTS><<<grid, kWarps * 32, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.num_chunks > 0) {
    const unsigned narrow = static_cast<unsigned>((a.dim + 32 * VEC - 1) / (32 * VEC));
    const dim3 grid(static_cast<unsigned>((a.num_chunks + per_block - 1) / per_block), narrow);
    segment_combine_kernel<VEC><<<grid, kWarps * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Both passes on `stream`.  Descriptor k has `starts[k]` as its first entry
// in the concatenation (starts[0] = 0), `windows[k]` entries an instance and
// float32 `weights[k]` or null; `grads[k]` is [instances, dim] float32, rows
// contiguous.  `out` is [num_rows, dim], `partials` [2 * num_chunks, dim]
// with num_chunks = ceil(n / chunk).  Returns the launches' cudaError_t.
extern "C" int cunvsm_segment_sum_f32(const int* rows, const long long* perm, const int* offsets,
                                      long long n, long long num_rows, long long dim,
                                      int num_desc, const float* const* grads,
                                      const float* const* weights, const long long* starts,
                                      const long long* windows, int bf16_stream,
                                      long long chunk, float* out, float* partials,
                                      cudaStream_t stream) {
  if (num_desc < 1 || num_desc > 3 || dim <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  Args a;
  a.rows = rows;
  a.perm = perm;
  a.offsets = offsets;
  a.weighted = 0;
  bool aligned = dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(partials) % 16 == 0;
  for (int k = 0; k < 3; ++k) {
    const int j = k < num_desc ? k : 0;
    a.desc[k].grad = grads[j];
    a.desc[k].weights = weights[j];
    a.desc[k].start = k < num_desc ? starts[k] : 0x7fffffffffffffffLL;
    a.desc[k].window = static_cast<int>(windows[j]);
    a.weighted = a.weighted || weights[j] != nullptr;
    aligned = aligned && reinterpret_cast<uintptr_t>(grads[j]) % 16 == 0;
  }
  a.bf16_stream = bf16_stream;
  a.num_rows = num_rows;
  a.dim = dim;
  a.chunk = chunk;
  a.num_chunks = (n + chunk - 1) / chunk;
  a.out = out;
  a.partials = partials;
  if (!aligned) return launch<1, 4>(a, stream);
  const long long groups = (dim / 4 + 31) / 32;
  if (groups <= 1) return launch<4, 1>(a, stream);
  if (groups == 2) return launch<4, 2>(a, stream);
  if (groups == 3) return launch<4, 3>(a, stream);
  return launch<4, 4>(a, stream);
}
