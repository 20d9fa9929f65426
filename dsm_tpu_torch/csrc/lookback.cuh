// Decoupled look-back: how the one-pass kernels (sa.cu's onesweep passes,
// compact.cu, children.cu, shardstats.cu's node_gates) chain their tiles'
// running totals without a second launch.  Tiles are handed out in order by an atomic counter, so
// every tile before a running one is itself running or done.  A tile
// publishes its own total (an AGGREGATE) in its status word as soon as it
// knows it, walks back over its predecessors' words adding aggregates
// until it meets a PREFIX (a total up to and including that tile), and
// then publishes its own prefix.
//
// A status word is one 64-bit store: the value in bits 0-31, the flag in
// bits 32-33, and whatever the kernel tags it with from bit 34 up (sa.cu:
// the pass).  Value and flag travel together, so a reader that sees the
// flag has the value; no other data hangs on the word, so no fence is
// needed before it.  The words must be zero (no flag) before the launch.

#pragma once

#include <cstdint>

namespace dsm {

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long get(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void put(unsigned long long* p,
                                    unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// The sum of the values of tiles [0, tile): all 32 threads of one warp
// call it and all get the result.  Each step reads the 32 nearest
// unread predecessors at once, waits until each has published, and adds
// the aggregates down to the nearest prefix.  With tile = the number of
// tiles it gives the grand total once the last tile has its prefix.
__device__ __forceinline__ unsigned long long lookback_exclusive(
    const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  unsigned long long excl = 0;
  for (long long base = tile - 1; base >= 0; base -= 32) {
    const long long p = base - lane;
    unsigned long long w = kPrefix;  // before tile 0: a prefix of nothing
    if (p >= 0) {
      do {
        w = get(status + p);
      } while (!(w & (kAggregate | kPrefix)));
    }
    const unsigned prefixes =
        __ballot_sync(0xFFFFFFFFu, (w & kPrefix) != 0);
    const int first = __ffs(prefixes) - 1;  // the nearest one; -1: none
    unsigned long long v = (first < 0 || lane <= first) ? (uint32_t)w : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    excl += v;
    if (first >= 0) break;
  }
  return excl;
}

}  // namespace dsm
