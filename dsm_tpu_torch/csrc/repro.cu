// The three kernels of tools/pallas_repro.py, on Hopper.  On the TPU they
// isolated Mosaic toolchain faults (an SMEM carry over the grid, one DMA
// from a VMEM scratch, a store at a data-dependent offset); here each is
// the same computation written for CUDA, over int32 blocks of kBlk.  They
// move a few KB: launch latency bounds all three.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 256;  // elements (and threads) per block

// P2 (main.run1, kernel k1): out = x + grid step.  The TPU walked the grid
// in order and carried the step in an SMEM counter; CUDA blocks run in no
// order, so the step is the block's index.
__global__ void carry_kernel(const int32_t* __restrict__ x,
                             int32_t* __restrict__ out) {
  int i = blockIdx.x * kBlk + threadIdx.x;
  out[i] = x[i] + (int32_t)blockIdx.x;
}

// P3 (main.run2, kernel k2): out = 2x, staged in shared memory and stored
// by one asynchronous bulk copy per block — Hopper's counterpart of
// make_async_copy from a VMEM scratch to HBM.  The generic-proxy writes to
// the stage are made visible to the async proxy before the copy reads it.
__global__ void async_kernel(const int32_t* __restrict__ x,
                             int32_t* __restrict__ out) {
  __shared__ __align__(128) int32_t stage[kBlk];
  int i = blockIdx.x * kBlk + threadIdx.x;
  stage[threadIdx.x] = 2 * x[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned src = (unsigned)__cvta_generic_to_shared(stage);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(out + (long long)blockIdx.x * kBlk), "r"(src),
           "r"(kBlk * (int)sizeof(int32_t))
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
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

// x, out: n int32, n a multiple of 256; out 16-byte aligned for P3.
extern "C" int dsm_repro_carry(const void* x, void* out, long long n,
                               void* stream) {
  carry_kernel<<<(unsigned)(n / kBlk), kBlk, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int dsm_repro_async(const void* x, void* out, long long n,
                               void* stream) {
  async_kernel<<<(unsigned)(n / kBlk), kBlk, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int dsm_repro_dynstore(const void* v, void* out, long long n,
                                  int factor, void* stream) {
  dynstore_kernel<<<(unsigned)((n + kBlk - 1) / kBlk), kBlk, 0,
                    (cudaStream_t)stream>>>((const int32_t*)v, (int32_t*)out,
                                            n, factor);
  return (int)cudaGetLastError();
}
