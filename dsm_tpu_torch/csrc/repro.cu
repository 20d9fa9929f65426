// The three kernels of tools/pallas_repro.py, on Hopper.  On the TPU they
// isolated Mosaic toolchain faults (an SMEM carry over the grid, one DMA
// from a VMEM scratch, a store at a data-dependent offset); here each is
// the same computation written for CUDA.  At the repro's N = 1024 they
// move a few KB: launch latency bounds all three; at large N their bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kBlk = 256;          // elements (and threads) per block, P2
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
//
// A copy is bound by its bytes (N int32 in and out: 0.040 ms at 2^24 at
// 3.35 TB/s).  One thread a 4-byte word issued 2^24 4-byte loads and
// stores; here a thread moves one 16-byte word: two, four or eight words a
// thread, all loads before the stores, measured slower on the H100 at 2^24
// (PERF.md), one ties torch.clone.  The 16-byte body starts where
// out + off is 16-byte aligned: a scalar head of up to 3 words before it
// and a tail of up to 3 after it, by the first block.  Where v + head is
// not 16-byte aligned too (a view such as x[1:]), each stored word joins
// two aligned 16-byte loads (the second is the neighbouring thread's
// first, an L1 hit), so loads and stores stay 16 bytes whatever the
// alignment.
constexpr int kCopyThreads = 256;

__device__ __forceinline__ int4 join(int4 a, int4 b, int shift) {
  switch (shift) {
    case 1: return make_int4(a.y, a.z, a.w, b.x);
    case 2: return make_int4(a.z, a.w, b.x, b.y);
    default: return make_int4(a.w, b.x, b.y, b.z);
  }
}

__global__ void __launch_bounds__(kCopyThreads)
    dynstore_kernel(const int32_t* __restrict__ v, int32_t* __restrict__ out,
                    long long n, int factor) {
  const long long off = (long long)__ldg(v) * factor;
  int32_t* dst = out + off;
  long long head = (long long)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  head = head < n ? head : n;
  const long long m = (n - head) >> 2;           // the body's 16-byte words
  const int32_t* src = v + head;
  const int shift = (int)(((uintptr_t)src & 15) >> 2);
  const int4* s4 = reinterpret_cast<const int4*>(src - shift);
  const long long j = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (j < m) {
    // s4[j + 1] <= s4[m] holds src[4m - shift], a word of v: the aligned
    // 16 bytes around it lie in v's allocation
    reinterpret_cast<int4*>(dst + head)[j] =
        shift ? join(__ldg(s4 + j), __ldg(s4 + j + 1), shift) : __ldg(s4 + j);
  }
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const long long i = threadIdx.x;
    if (i < head) dst[i] = v[i];
    const long long k = head + 4 * m + i;        // the tail
    if (k < n) dst[k] = v[k];
  }
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

// v, out: n int32 at any 4-byte alignment.
extern "C" int dsm_repro_dynstore(const void* v, void* out, long long n,
                                  int factor, void* stream) {
  const long long words = (n + 3) / 4;
  const long long blocks = (words + kCopyThreads - 1) / kCopyThreads;
  dynstore_kernel<<<(unsigned)(blocks ? blocks : 1), kCopyThreads, 0,
                    (cudaStream_t)stream>>>((const int32_t*)v, (int32_t*)out,
                                            n, factor);
  return (int)cudaGetLastError();
}
