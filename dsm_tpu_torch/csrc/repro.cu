// The three kernels of tools/pallas_repro.py, on Hopper.  On the TPU they
// isolated Mosaic toolchain faults (an SMEM carry over the grid, one DMA
// from a VMEM scratch, a store at a data-dependent offset); here each is
// the same computation written for CUDA.  At the repro's N = 1024 they
// move a few KB: launch latency bounds all three.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kBlk = 256;          // elements (and threads) per block, P2, P4
constexpr int kAsyncTile = 8192;   // int32 per P3 block: 32 KB of shared
constexpr int kAsyncThreads = 256;

// P2 (main.run1, kernel k1): out = x + grid step.  The TPU walked the grid
// in order and carried the step in an SMEM counter; CUDA blocks run in no
// order, so the step is the block's index.
__global__ void carry_kernel(const int32_t* __restrict__ x,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * kBlk + threadIdx.x;
  out[i] = x[i] + (int32_t)blockIdx.x;
}

// P3 (main.run2, kernel k2): out = 2x, staged in shared memory and stored
// by one asynchronous bulk copy — Hopper's counterpart of make_async_copy
// from a VMEM scratch to HBM.  A block takes a tile of up to 32 KB: one
// bulk load into shared memory completing on an mbarrier, the doubling in
// place (16 bytes a thread), a fence that makes those writes visible to
// the async proxy, and one bulk store.  N = 1024 is one block and two
// bulk copies; at large N the bytes bound it, and several 32 KB tiles per
// SM keep loads and stores in flight.  n is a multiple of 256, so the
// ragged last tile is a whole number of KB and takes the bulk copies too.
__global__ void __launch_bounds__(kAsyncThreads)
    async_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 long long n) {
  __shared__ __align__(128) int32_t stage[kAsyncTile];
  __shared__ uint64_t bar;
  const long long base = (long long)blockIdx.x * kAsyncTile;
  const int cnt = n - base < kAsyncTile ? (int)(n - base) : kAsyncTile;
  const unsigned bytes = (unsigned)cnt * sizeof(int32_t);
  if (threadIdx.x == 0) {
    dsm::bar_init(&bar);
    dsm::bar_expect(&bar, bytes);
    dsm::bulk_load(stage, x + base, bytes, &bar);
  }
  __syncthreads();
  dsm::bar_wait(&bar, 0);
  int4* v = reinterpret_cast<int4*>(stage);
  for (int i = threadIdx.x; i < cnt / 4; i += kAsyncThreads) {
    int4 a = v[i];
    a.x *= 2;
    a.y *= 2;
    a.z *= 2;
    a.w *= 2;
    v[i] = a;
  }
  dsm::fence_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) dsm::bulk_store(out + base, stage, bytes);
}

// P4 (main.run3, kernel k3): an identity copy stored at an offset computed
// from the data at run time.  The TPU kernel took off = v[0] * 0; nvcc
// folds a product with the literal 0, so the factor is a launch argument
// (always 0) and the offset stays a run-time value.
__global__ void dynstore_kernel(const int32_t* __restrict__ v,
                                int32_t* __restrict__ out, long long n,
                                int factor) {
  long long i = (long long)blockIdx.x * kBlk + threadIdx.x;
  if (i >= n) return;
  long long off = (long long)v[0] * factor;
  out[off + i] = v[i];
}

}  // namespace

// x, out: n int32, n a multiple of 256; x and out 16-byte aligned for P3.
extern "C" int dsm_repro_carry(const void* x, void* out, long long n,
                               void* stream) {
  carry_kernel<<<(unsigned)(n / kBlk), kBlk, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int dsm_repro_async(const void* x, void* out, long long n,
                               void* stream) {
  async_kernel<<<(unsigned)((n + kAsyncTile - 1) / kAsyncTile), kAsyncThreads,
                 0, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out,
                                            n);
  return (int)cudaGetLastError();
}

extern "C" int dsm_repro_dynstore(const void* v, void* out, long long n,
                                  int factor, void* stream) {
  dynstore_kernel<<<(unsigned)((n + kBlk - 1) / kBlk), kBlk, 0,
                    (cudaStream_t)stream>>>((const int32_t*)v, (int32_t*)out,
                                            n, factor);
  return (int)cudaGetLastError();
}
