// Rank of a symbol on the raw BWT blocks (K15): out[i] = occ[pos[i] >> 7,
// syms[i]] + the count of syms[i] among the first pos[i] & 127 codes of
// block pos[i] >> 7.
//
// Replaces dsm_tpu/ops/rank.py occ_batch (:270): the XLA take of the
// (Q, 128) int8 block rows, a compare under a lane mask and a sum.  Here a
// warp takes 32 queries at a time: their positions and symbols come in with
// one coalesced load each, and for each query in turn every lane loads 4
// bytes of its block (the warp one 128-byte line), and four ballots, one
// per byte of the word, mark the codes that equal the symbol below the
// position; their popcounts are the in-block count.  A query whose offset
// in its block is 0 reads no block (it may be the row past the last,
// pos = n with n a multiple of 128).  The occ entries and the outputs are a
// lane a query.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    occ_batch_kernel(const uint32_t* __restrict__ blocks,
                     const int32_t* __restrict__ occ, int sigma,
                     const int32_t* __restrict__ syms,
                     const int32_t* __restrict__ pos,
                     int32_t* __restrict__ out, long long q) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long base = warp * 32; base < q; base += warps * 32) {
    const long long i = base + lane;
    const int my_pos = i < q ? pos[i] : 0;
    const int my_sym = i < q ? syms[i] : 0;
    const int nq = q - base < 32 ? (int)(q - base) : 32;
    uint32_t mine = 0;
    for (int j = 0; j < nq; ++j) {
      const int p = __shfl_sync(0xFFFFFFFFu, my_pos, j);
      const uint32_t sym = (uint32_t)__shfl_sync(0xFFFFFFFFu, my_sym, j) & 0xFFu;
      const int r = p & 127;
      uint32_t count = 0;
      if (r) {                           // warp-uniform
        const uint32_t w = __ldg(blocks + (long long)(p >> 7) * 32 + lane);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          count += __popc(__ballot_sync(
              0xFFFFFFFFu, ((w >> (8 * b)) & 0xFFu) == sym && lane * 4 + b < r));
      }
      if (lane == j) mine = count;
    }
    if (i < q)
      out[i] = __ldg(occ + (long long)(my_pos >> 7) * sigma + my_sym) +
               (int32_t)mine;
  }
}

}  // namespace

// blocks (nb, 128) int8 contiguous, 4-byte aligned; occ (nb + 1, sigma)
// int32 contiguous; syms, pos (q,) int32 contiguous, 0 <= pos <= n; out
// (q,) int32.
extern "C" int dsm_occ_batch(const void* blocks, const void* occ, int sigma,
                             const void* syms, const void* pos, void* out,
                             long long q, void* stream) {
  if (q <= 0) return 0;
  long long grid = (q + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  occ_batch_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)occ, sigma,
      (const int32_t*)syms, (const int32_t*)pos, (int32_t*)out, q);
  return (int)cudaGetLastError();
}
