// Window mean of a table's rows, for sm_90a.
//
//   out[i] = (1 / W) * sum_{w < W} fw[i, w] * table[idx[i, w]]
//
// Replaces no Pallas kernel: the JAX package leaves this gather-mean to XLA
// (cunvsm_tpu/models/objectives.py:gather_phrase_reprs).  Its counterpart in
// the CUDA reference is average_repr_kernel (params.cu:77-95), which, like
// this kernel, writes only the [B, d] mean.  PyTorch's version
// (ops/window_mean.py:window_mean_plain) writes the [B * W, d] gathered rows
// to device memory and reads them back to sum them.
//
// Rounding, as the plain version computes it on the card:
// - a bfloat16 table: each weighted term is bf16(x * bf16(fw)), the sum is
//   in float32; with bfloat16 window sums the sum is rounded to bfloat16,
//   multiplied by the float32 reciprocal of W (PyTorch's division of a
//   tensor by a Python number on a card is that multiply) and rounded to
//   bfloat16 again, else the float32 sum is multiplied; the mean is widened
//   to float32;
// - a float32 table: float32 throughout.
// The terms are added in the order w = 0, 1, ..., W - 1, starting from the
// first term.  Every multiply and add is an _rn intrinsic, which the
// compiler never contracts into an FMA.
//
// What bounds it: the bytes.  For the main path (B 51,200, W 10, d 300):
// the 512,000 int64 ids (4.1 MB), each table row read once (39.3 MB of
// bfloat16 or 78.6 MB of float32) and the [B, d] float32 mean written once
// (61.4 MB): 105 MB or 144 MB, 0.031 ms or 0.043 ms at the H100's 3.35 TB/s.
// A window's rows are read again wherever they recur (512,000 row reads a
// call: 307 MB of bfloat16, 614 MB of float32), and those reads come from
// L2 (or L1): the Zipf head of the vocabulary and the whole bfloat16 table
// fit in its 50 MB.  So the kernel is bound by its gathers from L2, their
// bandwidth and latency.
//
// Design:
// - One warp per output row.  Lane j loads the row's j-th id (and weight)
//   in one coalesced read; the warp shares them by shuffles (a window longer
//   than 32 reads the rest directly, every lane the same address).
// - Each lane holds VEC consecutive values of the row in each of 3 slots
//   32 vectors apart: VEC = 4 (8-byte loads of bfloat16, 16-byte loads of
//   float32) where the rows and the output are aligned for it, else 1 (and
//   4 slots).  So one warp covers a row of 300 at VEC = 4; a wider row
//   takes several column tiles
//   (blockIdx.y), each reading the ids again (from L1 or L2).
// - A lane issues the loads of a few window rows, for all its slots, before
//   it adds any, and keeps them packed (a bfloat16 vector in 2 registers):
//   kLoadWords = 30 registers' worth, 5 rows of bfloat16 (15 loads in
//   flight) or 2 rows of float32.  Measured at the main path's shapes on an
//   H100, fewer rows in flight and more warps resident beat more loads in
//   flight: 10 rows of all slots (105 registers) took 0.096 / 0.100 ms,
//   10 rows of one slot at a time 0.134 / 0.136, this kernel about
//   0.06-0.07 with blocks of 4 warps (of 8: 0.069 / 0.070; of 16: 0.095 /
//   0.073).
// - The terms are added in window order as soon as their rows are in, then
//   the next rows are loaded; the mean is written once, with streaming
//   stores (__stcs), so that the 61 MB output does not push the table out
//   of L2.
// - No host sync, no allocation: the wrapper allocates the output, and the
//   launch can be captured in a CUDA graph and replayed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // output rows per block
constexpr int kLoadWords = 30;  // registers a lane holds its loaded rows in

// What one load of VEC values of T brings, as it sits in registers.
template <typename T, int VEC>
struct Packed;
template <>
struct Packed<float, 1> {
  using type = float;
};
template <>
struct Packed<float, 4> {
  using type = float4;
};
template <>
struct Packed<__nv_bfloat16, 1> {
  using type = unsigned short;
};
template <>
struct Packed<__nv_bfloat16, 4> {
  using type = uint2;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A bfloat16 value from its 16 bits, widened (exactly) to float32.
__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// The loaded values, widened.
__device__ __forceinline__ void unpack(float v, float (&x)[1]) { x[0] = v; }
__device__ __forceinline__ void unpack(float4 v, float (&x)[4]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack(unsigned short v, float (&x)[1]) { x[0] = bf16_bits(v); }
__device__ __forceinline__ void unpack(uint2 v, float (&x)[4]) {
  x[0] = bf16_bits(v.x & 0xffffu);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = bf16_bits(v.y & 0xffffu);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    __stcs(p, x[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  }
}

// Vectors of a row that one warp takes (blockIdx.y tiles a wider row): 3 x
// 32 lanes holds a row of 300 in one tile at VEC = 4.
template <int VEC>
__host__ __device__ constexpr int slots_of() {
  return VEC == 1 ? 4 : 3;
}

// Window rows a lane loads before it adds any: as many as its kLoadWords
// registers hold with the loads of every slot, at least 1.
template <typename T, int VEC>
__host__ __device__ constexpr int unroll_of() {
  constexpr int words = static_cast<int>(sizeof(typename Packed<T, VEC>::type) + 3) / 4;
  constexpr int u = kLoadWords / (slots_of<VEC>() * words);
  return u < 1 ? 1 : u;
}

template <typename T, int VEC, bool WEIGHTED, bool BF16_SUM>
__global__ void __launch_bounds__(kWarps * 32)
    window_mean_kernel(const T* __restrict__ table, const long long* __restrict__ idx,
                       const T* __restrict__ fw, float* __restrict__ out, long long batch,
                       int window, long long dim, float inv) {
  using P = typename Packed<T, VEC>::type;
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kSlots = slots_of<VEC>();
  constexpr int kUnroll = unroll_of<T, VEC>();
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= batch) return;  // the whole warp: i is the same in every lane
  const long long* ids = idx + i * window;
  const T* wts = WEIGHTED ? fw + i * window : nullptr;
  const long long mine_id = lane < window ? __ldg(ids + lane) : 0;
  float mine_w = 1.0f;
  if constexpr (WEIGHTED) {
    if (lane < window) mine_w = widen(wts[lane]);
  }
  // Lane l takes the vectors v0 + 32 * s of the row, s < kSlots.
  const long long nvec = dim / VEC;
  const long long v0 = static_cast<long long>(blockIdx.y) * 32 * kSlots + lane;
  float acc[kSlots][VEC] = {};
  for (int w0 = 0; w0 < window; w0 += kUnroll) {
    P x[kUnroll][kSlots];
    float wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u;
      // w is the same in every lane, so are the branches on it.
      long long id = 0;
      wt[u] = 1.0f;
      if (w < 32) {
        id = __shfl_sync(0xffffffffu, mine_id, w & 31);
        if constexpr (WEIGHTED) wt[u] = __shfl_sync(0xffffffffu, mine_w, w & 31);
      } else if (w < window) {
        id = __ldg(ids + w);
        if constexpr (WEIGHTED) wt[u] = widen(wts[w]);
      }
      const P* row = reinterpret_cast<const P*>(table + id * dim);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (w < window && v0 + 32 * s < nvec) x[u][s] = __ldg(row + v0 + 32 * s);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u;
      if (w >= window) break;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float t[VEC];
        unpack(x[u][s], t);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float term = t[j];
          if constexpr (WEIGHTED) {
            term = __fmul_rn(term, wt[u]);
            if constexpr (kBF16) term = round_bf16(term);
          }
          acc[s][j] = w == 0 ? term : __fadd_rn(acc[s][j], term);
        }
      }
    }
  }
  float* out_row = out + i * dim;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (v0 + 32 * s >= nvec) continue;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (BF16_SUM) {
        acc[s][j] = round_bf16(__fmul_rn(round_bf16(acc[s][j]), inv));
      } else {
        acc[s][j] = __fmul_rn(acc[s][j], inv);
      }
    }
    store_vec<VEC>(out_row + (v0 + 32 * s) * VEC, acc[s]);
  }
}

template <typename T, int VEC, bool BF16_SUM>
int launch(const void* table, const long long* idx, const void* fw, float* out,
           long long batch, int window, long long dim, float inv, cudaStream_t stream) {
  const long long per_tile = 32LL * slots_of<VEC>();
  const long long tiles = (dim / VEC + per_tile - 1) / per_tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((batch + kWarps - 1) / kWarps),
                  static_cast<unsigned>(tiles));
  const T* t = static_cast<const T*>(table);
  const T* f = static_cast<const T*>(fw);
  if (f)
    window_mean_kernel<T, VEC, true, BF16_SUM><<<grid, kWarps * 32, 0, stream>>>(
        t, idx, f, out, batch, window, dim, inv);
  else
    window_mean_kernel<T, VEC, false, BF16_SUM><<<grid, kWarps * 32, 0, stream>>>(
        t, idx, f, out, batch, window, dim, inv);
  return cudaGetLastError();
}

// The widest load that every row start takes: the rows, the output rows and
// each lane's offset in them are multiples of the vector.
template <typename T, bool BF16_SUM>
int dispatch_vec(const void* table, const long long* idx, const void* fw, float* out,
                 long long batch, int window, long long dim, float inv, cudaStream_t stream) {
  const bool vec4 = dim % 4 == 0 && reinterpret_cast<uintptr_t>(table) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) return launch<T, 4, BF16_SUM>(table, idx, fw, out, batch, window, dim, inv, stream);
  return launch<T, 1, BF16_SUM>(table, idx, fw, out, batch, window, dim, inv, stream);
}

}  // namespace

// out [batch, dim] float32 = the window mean of table [*, dim] (rows
// contiguous; float32 when bf16_table is 0, else bfloat16) over the int64
// idx [batch, window], weighted by fw [batch, window] of the table's dtype
// where fw is not null.  bf16_sum rounds a bfloat16 table's sum and mean to
// bfloat16.  inv is the float32 reciprocal of window.  Returns the launch's
// cudaError_t.
extern "C" int cunvsm_window_mean(const void* table, int bf16_table, const long long* idx,
                                  const void* fw, float* out, long long batch, int window,
                                  long long dim, int bf16_sum, float inv,
                                  cudaStream_t stream) {
  if (window < 1 || dim < 0 || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0 || dim == 0) return cudaSuccess;
  if ((batch + kWarps - 1) / kWarps > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (!bf16_table)
    return dispatch_vec<float, false>(table, idx, fw, out, batch, window, dim, inv, stream);
  if (bf16_sum)
    return dispatch_vec<__nv_bfloat16, true>(table, idx, fw, out, batch, window, dim, inv,
                                             stream);
  return dispatch_vec<__nv_bfloat16, false>(table, idx, fw, out, batch, window, dim, inv,
                                            stream);
}
