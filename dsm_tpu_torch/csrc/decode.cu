// Ancestor-walk path decode: node rows of the current history segment walk
// down to the segment base, one symbol code per level.
//
// Replaces dsm_tpu/mining/engine_device.py _jitted_decode (a fori_loop over
// 128-padded columns of DECODE_K-row chunks, each step a masked gather and a
// scatter into an int8 matrix).  Row i reads hist[lvl_off[lev - 1] + r] for
// lev = jrel[i] .. 1, takes the entry's low two bits as syms[i, lev - 1] and
// follows the parent pointer (entry >> 2); columns past jrel[i] are zero and
// base[i] is the row it ends on.
//
// What bounds it on an H100: the dependent gathers, one 4-byte load a row a
// level.  Where parents are random each costs a 32-byte sector; where rows
// are sorted (a frontier decodes rows 0..n-1, a drain its rows in node order
// within a depth) and children are numbered in (parent, symbol) order, the
// parents of neighbouring rows are equal or adjacent and a warp's gathers
// share sectors, more so as the walks climb.  The design:
//
//   * A block owns a tile of kTile consecutive rows; their symbol rows are
//     the one byte range [i0*maxj, (i0 + kTile)*maxj).  The tile's symbols
//     are staged in shared memory (row-major, maxj bytes a row), zeroed once
//     with 16-byte stores in place of a per-thread zero loop, and the block
//     writes the range with aligned 16-byte stores (i0*maxj is a multiple of
//     16).  Where maxj is wider than the staging holds (kMaxWindow levels),
//     the levels go by windows from the top down: the walk reaches each
//     window's levels all before the next, so a window is complete when the
//     walk leaves it; its columns are stored row segment by row segment.
//   * A thread walks kRows rows at once (rows t, t + kThreads, ...): their
//     loads are independent, so kRows gathers are in flight a thread.
//   * The window's lvl_off entries sit in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;                  // walks a thread interleaves
constexpr int kTile = kThreads * kRows;   // rows a block
constexpr int kMaxWindow = 120;           // levels staged at once
constexpr int kMaxSmem = kTile * kMaxWindow + 4 * kMaxWindow;

__global__ void __launch_bounds__(kThreads)
decode_kernel(const int32_t* __restrict__ hist,
              const int32_t* __restrict__ lvl_off,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ jrel, long long m, int maxj,
              int window, int32_t* __restrict__ base,
              uint8_t* __restrict__ syms) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * kTile;
  const int nrows = (int)min((long long)kTile, m - i0);
  // the window's symbols, kTile rows of `window` bytes, then its offsets
  uint8_t* s_sym = smem;
  int32_t* s_off = (int32_t*)(smem + ((kTile * window + 15) & ~15));

  int r[kRows], j[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = t + k * kThreads;
    r[k] = row < nrows ? rows[i0 + row] : 0;
    j[k] = row < nrows ? jrel[i0 + row] : 0;
  }

  for (int b = maxj; b > 0;) {
    const int a = b > window ? b - window : 0;
    const int w = b - a;  // this window's levels (a, b]: columns [a, b)
    __syncthreads();      // the previous window is stored
    uint4* z = (uint4*)s_sym;
    const int zw = (kTile * w + 15) >> 4;
    for (int q = t; q < zw; q += kThreads) z[q] = make_uint4(0, 0, 0, 0);
    for (int q = t; q < w; q += kThreads) s_off[q] = lvl_off[a + q];
    __syncthreads();
    for (int lev = b; lev > a; --lev) {
      const long long off = s_off[lev - 1 - a];
      int e[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        e[k] = lev <= j[k] ? __ldg(hist + off + r[k]) : 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (lev <= j[k]) {
          s_sym[(t + k * kThreads) * w + (lev - 1 - a)] = (uint8_t)(e[k] & 3);
          r[k] = e[k] >> 2;
        }
      }
    }
    __syncthreads();
    if (w == maxj) {
      // the tile's whole byte range: aligned 16-byte words, then the tail
      uint8_t* dst = syms + i0 * maxj;
      const int nbytes = nrows * maxj;
      const uint4* src = (const uint4*)s_sym;
      uint4* d16 = (uint4*)dst;
      for (int q = t; q < (nbytes >> 4); q += kThreads) d16[q] = src[q];
      for (int q = (nbytes & ~15) + t; q < nbytes; q += kThreads)
        dst[q] = s_sym[q];
    } else {
      // columns [a, b) of each row: w bytes at stride maxj
      for (int q = t; q < nrows * w; q += kThreads) {
        const int row = q / w, col = q - row * w;
        syms[(i0 + row) * maxj + a + col] = s_sym[q];
      }
    }
    b = a;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = t + k * kThreads;
    if (row < nrows) base[i0 + row] = r[k];
  }
}

}  // namespace

extern "C" int dsm_decode(const void* hist, const void* lvl_off,
                          const void* rows, const void* jrel, long long m,
                          int maxj, void* base, void* syms, void* stream) {
  // above 48 KB of shared memory only by this attribute (set on the
  // current device, so at every launch)
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const int window = maxj < kMaxWindow ? maxj : kMaxWindow;
  const int smem = ((kTile * window + 15) & ~15) + 4 * window;
  long long blocks = (m + kTile - 1) / kTile;
  decode_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)hist, (const int32_t*)lvl_off, (const int32_t*)rows,
      (const int32_t*)jrel, m, maxj, window, (int32_t*)base, (uint8_t*)syms);
  return (int)cudaGetLastError();
}
