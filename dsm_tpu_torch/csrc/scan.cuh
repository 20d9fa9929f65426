// Exclusive scan of per-block sums, for the kernels that number their
// outputs in two passes (shardstats.cu): a first kernel
// leaves one int64 sum a block, this one turns the sums into each block's
// offset, and a second pass scans inside the block again
// (block_exclusive_scan) and adds the block's offset.

#pragma once

#include <cuda_runtime.h>

namespace {

// One block of 1024 threads: thread t owns a contiguous chunk of the block
// sums, so any number of blocks is scanned in one launch.
__global__ void scan_kernel(const long long* __restrict__ block_sum,
                            long long nblocks,
                            long long* __restrict__ block_off) {
  __shared__ long long part[1024];
  int t = threadIdx.x;
  long long chunk = (nblocks + 1023) / 1024;
  long long b0 = t * chunk;
  long long b1 = b0 + chunk < nblocks ? b0 + chunk : nblocks;
  long long s = 0;
  for (long long b = b0; b < b1; ++b) s += block_sum[b];
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
    run += block_sum[b];
  }
}

// Exclusive scan of one int64 value a thread over a block of kScanThreads
// threads (every thread of the block must call it).
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;

__device__ __forceinline__ long long block_exclusive_scan(long long v) {
  __shared__ long long warp_off[kScanWarps];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      long long t = warp_off[w];
      warp_off[w] = run;
      run += t;
    }
  }
  __syncthreads();
  return warp_off[warp] + incl - v;
}

// Sum of one int64 value a thread over the block, left in block_sum[block].
__device__ __forceinline__ void block_sum_to(long long v,
                                             long long* block_sum) {
  __shared__ long long warp_sum[kScanWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kScanWarps; ++w) t += warp_sum[w];
    block_sum[blockIdx.x] = t;
  }
}

}  // namespace
