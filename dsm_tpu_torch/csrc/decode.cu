// Ancestor-walk path decode: node rows of the current history segment walk
// down to the segment base, one symbol code per level.
//
// Replaces dsm_tpu/mining/engine_device.py _jitted_decode (a fori_loop over
// 128-padded columns of DECODE_K-row chunks, each step a masked gather and a
// scatter into an int8 matrix).  Here one thread owns one row: it reads
// hist[lvl_off[lev - 1] + r] for lev = jrel .. 1, writes the entry's low two
// bits to syms[i, lev - 1] and follows the parent pointer (entry >> 2).
// Columns past the row's jrel are zero; base[i] is the row it ends on.
//
// What bounds it on an H100: the dependent gathers.  Each level is one 4-byte
// load from a random place in the history (a 32-byte sector moved for 4 useful
// bytes), and each load waits for the previous one, so the kernel relies on
// many rows in flight to hide the latency.  The symbol bytes of neighbouring
// rows are neighbouring, so the stores merge in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void decode_kernel(const int32_t* __restrict__ hist,
                              const int32_t* __restrict__ lvl_off,
                              const int32_t* __restrict__ rows,
                              const int32_t* __restrict__ jrel, long long m,
                              int maxj, int32_t* __restrict__ base,
                              uint8_t* __restrict__ syms) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int r = rows[i];
  int j = jrel[i];
  uint8_t* out = syms + i * (long long)maxj;
  for (int lev = maxj; lev > j; --lev) out[lev - 1] = 0;
  for (int lev = j; lev >= 1; --lev) {
    int e = hist[(long long)lvl_off[lev - 1] + r];
    out[lev - 1] = (uint8_t)(e & 3);
    r = e >> 2;
  }
  base[i] = r;
}

}  // namespace

extern "C" int dsm_decode(const void* hist, const void* lvl_off,
                          const void* rows, const void* jrel, long long m,
                          int maxj, void* base, void* syms, void* stream) {
  const int threads = 256;
  long long blocks = (m + threads - 1) / threads;
  decode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hist, (const int32_t*)lvl_off, (const int32_t*)rows,
      (const int32_t*)jrel, m, maxj, (int32_t*)base, (uint8_t*)syms);
  return (int)cudaGetLastError();
}
