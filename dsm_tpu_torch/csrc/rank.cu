// Fused rank over the baked-C4 occ tables: the per-pair, per-level hot
// primitive of the mining episode.
//
// Replaces dsm_tpu/ops/rank.py occ_cumT / occ_cum8T (the XLA column gather
// over the transposed (32, R) table).  Here the table stays row-major
// (R, 32) uint32: one 128-byte row per 128-symbol block holds the 8 cum
// words (C4 baked in, wrapping mod 2^32) and five thermometer bit planes of
// 4 words each (ops/rank.py fused_rows).
//
// One thread per query.  A query reads 7 uint4 (words 0..27 of its row),
// popcounts the first `rem` bits of each plane and adds the cum words 1..5.
// All arithmetic is uint32 and the results are reinterpreted as int32, as
// lax.bitcast_convert_type does in the JAX version.
//
// What bounds it on an H100: one dependent 112-byte row gather per query,
// two queries per pair per level.  At scale 100 the forward table is
// ~8 MB, small enough for the 50 MB L2 cache; the popcounts are a few
// dozen integer instructions.  Output (8, Q) int32 is written with
// coalesced stores (row k at k*Q + q).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void occ_cum8_kernel(const uint4* __restrict__ rows,
                                const int32_t* __restrict__ pos,
                                long long pos_stride,
                                const int32_t* __restrict__ soff,
                                long long soff_stride,
                                int32_t* __restrict__ out, long long q_total) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= q_total) return;
  uint32_t p = (uint32_t)pos[q * pos_stride];
  long long blk = (long long)(p >> 7) + (long long)soff[q * soff_stride];
  uint32_t rem = p & 127u;
  const uint4* r = rows + blk * 8;  // 32 words = 8 uint4 per row

  uint32_t w[28];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    uint4 v = __ldg(r + k);
    w[4 * k + 0] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  uint32_t wi = rem >> 5;
  uint32_t part = (1u << (rem & 31u)) - 1u;
  uint32_t m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    m[k] = ((uint32_t)k < wi) ? 0xFFFFFFFFu : (((uint32_t)k == wi) ? part : 0u);

  uint32_t c[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    uint32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) cnt += __popc(w[8 + 4 * j + k] & m[k]);
    c[j] = w[1 + j] + cnt;
  }
  out[0 * q_total + q] = (int32_t)(c[1] - c[0]);
  out[1 * q_total + q] = (int32_t)(c[2] - c[1]);
  out[2 * q_total + q] = (int32_t)(c[3] - c[2]);
  out[3 * q_total + q] = (int32_t)(p - c[4]);
  out[4 * q_total + q] = (int32_t)c[0];
  out[5 * q_total + q] = (int32_t)c[1];
  out[6 * q_total + q] = (int32_t)c[2];
  out[7 * q_total + q] = (int32_t)c[4];
}

}  // namespace

extern "C" int dsm_occ_cum8(const void* rows, const void* pos,
                            long long pos_stride, const void* soff,
                            long long soff_stride, void* out,
                            long long q_total, void* stream) {
  const int threads = 256;
  long long blocks = (q_total + threads - 1) / threads;
  occ_cum8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)rows, (const int32_t*)pos, pos_stride,
      (const int32_t*)soff, soff_stride, (int32_t*)out, q_total);
  return (int)cudaGetLastError();
}
