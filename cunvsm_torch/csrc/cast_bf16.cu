// float32 -> bfloat16 copy of a table, round to nearest even, for sm_90a.
//
// Replaces the Pallas kernel of cunvsm_tpu/ops/cast.py (_cast_pallas /
// _cast_kernel).  Under stream_dtype=bfloat16 every training step casts the
// float32 master word table to the bfloat16 copy that feeds the window
// gathers.  The result is bitwise that of x.to(torch.bfloat16): PyTorch's
// device conversion is cvt.rn.bf16.f32, and __float22bfloat162_rn is the
// same rounding on two values at once.
//
// What bounds it: device-memory bytes, 4 read and 2 written per element;
// 117.96 MB for the canonical [65536, 300] word table, 35.2 us at the H100's
// 3.35 TB/s.  The pass is larger than the 50 MB L2 and nothing is reused.
//
// Design:
// - Bytes in flight: by Little's law about 2.7 MB has to be in flight to
//   reach 3.35 TB/s, about 20 KB per SM.  Each thread issues the two 16-byte
//   loads of each of its kUnroll = 4 chunks of 8 elements before it converts
//   any: 128 B per thread, 32 KB per block of 256 threads, and an SM holds
//   several blocks at once.
// - Grid: one short block per 256 x 4 chunks (8192 elements; 2400 blocks
//   for the canonical table), with no loop.  The block scheduler refills an
//   SM as soon as a block ends, so the last wave is one block long and no SM
//   waits on a thread that drew one chunk more than the others.
// - Loads: ld.global.nc.L1::no_allocate, read-only and with no L1 line for
//   data that is used once.  Convert and store: four __float22bfloat162_rn
//   per chunk, then one 16-byte streaming store (__stcs).
// - Measured against it on an H100 SXM at 700 W (PERF.md): a persistent
//   grid (SMs x resident blocks) that walks the table in a grid-stride loop
//   trailed .to(torch.bfloat16) by 3-6%, and a ring of 1-D TMA bulk copies
//   (cp.async.bulk into 3-8 stages per block) by 1-3%; this kernel led it by
//   1-2%.
// - Edges: a scalar head up to the first element at which both x and y are
//   16-byte aligned, and a scalar tail for what is left after the last full
//   chunk.  Where x and y reach 16-byte alignment at different elements (a
//   slice of a table that starts off a 16-byte boundary, with y freshly
//   allocated), every element takes the scalar path.  Any n >= 1 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162_raw h = __float22bfloat162_rn(make_float2(a, b));
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

__device__ __forceinline__ uint4 convert8(float4 lo, float4 hi) {
  return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                    pack2(hi.z, hi.w));
}

// Elements [head, head + 8 * chunks) go as 16-byte vectors, kUnroll chunks
// per thread; the head [0, head) and the tail [head + 8 * chunks, n) one by
// one, spread over the grid.
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                long long head, long long chunks, long long n) {
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  float4 lo[kUnroll], hi[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long c = base + u * kThreads;
    if (c < chunks) {
      lo[u] = load_once(xv + 2 * c);
      hi[u] = load_once(xv + 2 * c + 1);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long c = base + u * kThreads;
    if (c < chunks) __stcs(yv + c, convert8(lo[u], hi[u]));
  }
  const long long body_end = head + 8 * chunks;
  const long long scalars = head + (n - body_end);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < scalars;
       j += stride) {
    const long long e = j < head ? j : body_end + (j - head);
    y[e] = __float2bfloat16_rn(x[e]);
  }
}

}  // namespace

extern "C" int cunvsm_cast_f32_bf16(const float* x, __nv_bfloat16* y, long long n,
                                    cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  long long head = static_cast<long long>((16 - xa % 16) % 16) / 4;
  if (head > n) head = n;
  long long chunks = (n - head) / 8;
  if ((ya + 2 * head) % 16 != 0) {
    head = 0;
    chunks = 0;
  }
  const long long scalars = n - 8 * chunks;
  const long long work = chunks > scalars ? chunks : scalars;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long blocks = (work + per_block - 1) / per_block;
  cast_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, y, head, chunks, n);
  return cudaGetLastError();
}
