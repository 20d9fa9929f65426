// Order-preserving masked row compaction: the rows of values (N, C) int32
// whose mask byte is set move, in order, to the front of out (width, C);
// count receives the number of set mask bytes.
//
// Replaces dsm_tpu/ops/pallas_compact.py compact_rows (kernel _kernel), with
// the semantics of ops/compact.py compact_kidx_sort followed by a row take.
// On the TPU the grid ran in order on one core and carried the running
// output offset in SMEM from one step to the next, and each 128-row tile was
// permuted on the MXU over 16-bit halves (f32 exactness).  Blocks on Hopper
// run in no order on 132 SMs, so the carried offset becomes a scan:
//
//   1. count:   each 1024-row block counts its set rows with one warp
//               ballot + __popc per warp;
//   2. scan:    one block turns the per-block counts into exclusive block
//               offsets and the total;
//   3. scatter: each block recomputes its warp ballots, ranks each set row
//               inside its warp (__popc of the lower lanes) and writes the
//               row to block offset + warp offset + rank, if below width.
//
// Any N is accepted (no 2048-row multiple) and the 16-bit split is gone.
// What bounds it on an H100: bytes.  The mask is read twice, the kept rows
// are read and written once (4*C bytes each).  The strided row copy (one
// thread per row, C words each) is the simple form, not the coalesced one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 1024;  // rows (and threads) per block
constexpr int kWarps = kRows / 32;

__global__ void count_kernel(const uint8_t* __restrict__ mask, long long n,
                             int32_t* __restrict__ block_count) {
  __shared__ int warp_count[kWarps];
  long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  bool keep = i < n && mask[i] != 0;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_count[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) block_count[blockIdx.x] = v;
  }
}

// One block of 1024 threads: thread t owns a contiguous chunk of the block
// counts, so any number of blocks is scanned in one launch.
__global__ void scan_kernel(const int32_t* __restrict__ block_count,
                            long long nblocks,
                            long long* __restrict__ block_off,
                            long long* __restrict__ total) {
  __shared__ long long part[1024];
  int t = threadIdx.x;
  long long chunk = (nblocks + 1023) / 1024;
  long long b0 = t * chunk;
  long long b1 = b0 + chunk < nblocks ? b0 + chunk : nblocks;
  long long s = 0;
  for (long long b = b0; b < b1; ++b) s += block_count[b];
  part[t] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the 1024 chunk sums
  for (int o = 1; o < 1024; o <<= 1) {
    long long v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - s;  // exclusive
  for (long long b = b0; b < b1; ++b) {
    block_off[b] = run;
    run += block_count[b];
  }
  if (t == 1023) *total = part[1023];
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask,
                               const int32_t* __restrict__ values, long long n,
                               int c, const long long* __restrict__ block_off,
                               int32_t* __restrict__ out, long long width) {
  __shared__ int warp_off[kWarps];
  long long i = (long long)blockIdx.x * kRows + threadIdx.x;
  bool keep = i < n && mask[i] != 0;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_off[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += u;
    }
    warp_off[lane] = incl - v;
  }
  __syncthreads();
  if (!keep) return;
  unsigned lower = ballot & ((1u << lane) - 1u);
  long long dst = block_off[blockIdx.x] + warp_off[warp] + __popc(lower);
  if (dst >= width) return;
  const int32_t* src = values + i * c;
  int32_t* to = out + dst * c;
  for (int k = 0; k < c; ++k) to[k] = src[k];
}

}  // namespace

// scratch: (nblocks,) int32 block counts followed by (nblocks,) int64 block
// offsets; count: one int64.  nblocks = ceil(n / 1024).
extern "C" int dsm_compact_rows(const void* mask, const void* values,
                                long long n, int c, void* out, long long width,
                                void* block_count, void* block_off,
                                void* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (n + kRows - 1) / kRows;
  count_kernel<<<(unsigned)nblocks, kRows, 0, s>>>(
      (const uint8_t*)mask, n, (int32_t*)block_count);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, 1024, 0, s>>>((const int32_t*)block_count, nblocks,
                                 (long long*)block_off, (long long*)count);
  err = (int)cudaGetLastError();
  if (err) return err;
  scatter_kernel<<<(unsigned)nblocks, kRows, 0, s>>>(
      (const uint8_t*)mask, (const int32_t*)values, n, c,
      (const long long*)block_off, (int32_t*)out, width);
  return (int)cudaGetLastError();
}
