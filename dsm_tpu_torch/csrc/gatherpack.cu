// The gather of a sharded drain: the count-bounded int32 rows of several
// blocks (a shard's staged output rows, or its live pair rows) packed into
// one list in block order, each block's LOCAL sample ids rewritten to
// global ones, and the blocks' int8 leftChar codes placed beside them.
//
// Replaces dsm_tpu/parallel/engine_episode.py _jitted_gather_counts,
// _jitted_gather_rows and _jitted_lc_sharded's gather (:205-267) and the
// host loop that cut each shard's padded slice to its count and added the
// shard's first sample id (:350-364, :443-447): there every shard's buffer
// was padded to one power-of-two length so that `all_gather` could stack
// them; here the blocks are wherever they lie on the device (the shards of
// one process, or the slices of an all-gathered tensor) and a table names
// each block's rows, its codes, its first output row and its first sample
// id.  One thread an output row finds its block by bisection of the first
// rows (empty blocks share their successor's and are never chosen).
//
// What bounds it on an H100: bytes, 4*C + 1 read and written a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTableCols = 4;  // rows pointer, codes pointer, first row, base

__global__ void gather_pack_kernel(const long long* __restrict__ table,
                                   int nblk, long long n_tot, int C,
                                   int sid_col, int32_t* __restrict__ out,
                                   int8_t* __restrict__ lc_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tot) return;
  int lo = 0, hi = nblk - 1;   // the last block whose first row is <= i
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (table[mid * kTableCols + 2] <= i) lo = mid; else hi = mid - 1;
  }
  const long long* t = table + lo * kTableCols;
  long long r = i - t[2];
  const int32_t* src = (const int32_t*)t[0] + r * C;
  int32_t* to = out + i * C;
  for (int c = 0; c < C; ++c) to[c] = src[c];
  to[sid_col] += (int32_t)t[3];
  if (lc_out) lc_out[i] = ((const int8_t*)t[1])[r];
}

}  // namespace

// table: (nblk, 4) int64 on the device; out: (n_tot, C) int32; lc_out:
// (n_tot,) int8 or null (then the table's codes pointers are not read).
// nblk >= 1, n_tot >= 1.
extern "C" int dsm_gather_pack(const void* table, int nblk, long long n_tot,
                               int C, int sid_col, void* out, void* lc_out,
                               void* stream) {
  const int threads = 256;
  long long blocks = (n_tot + threads - 1) / threads;
  gather_pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)table, nblk, n_tot, C, sid_col, (int32_t*)out,
      (int8_t*)lc_out);
  return (int)cudaGetLastError();
}
