// The children step of a trie level: the kept (pair, symbol) lanes become the
// next level's pair rows in (node, symbol, pair) order, with the child ids,
// the next node starts and the history entries.
//
// Replaces the children block of dsm_tpu/mining/engine_device.py
// _level_single: a 5-operand lax.sort of the 4B lanes keyed on
// hv = (nid*4 + c)*P2 + poff (with a drop sentinel), a boundary cumsum for
// the child ids, and a second sort that writes the history entries and the
// nb boundaries.  A node's pairs are already contiguous and in pair order,
// so every output slot follows from scans and no sort is needed:
//
//   1. count:   one thread per node counts its kept lanes per symbol (a node
//               has at most MAX_SAMPLES = 512 pairs) and the block sums the
//               packed value (kept lanes << 32 | symbols with one);
//   2. scan:    one block turns the block sums into exclusive block offsets
//               (scan.cuh);
//   3. scatter: each block scans its nodes' packed values again (warp
//               shuffles), so node u knows its first output row and its
//               first child id; it gives each of its symbols with kept lanes
//               a child id, writes that child's nb_next entry and history
//               entry u*4 + c, and walks its pairs writing each kept lane's
//               row at its symbol's next slot.  The last node writes
//               nb_next[child_total] = pair_count.
//
// dsm_children_ids is the same step for one shard of a sample-sharded level
// (dsm_tpu/mining/engine_device.py _level_sharded, the children block at
// :474-507): a child exists when ANY shard keeps a lane of it, so which
// symbols of a node have a child (the exists bits of `flags`) and the node's
// first child id (`kid0`) come from the level's global numbering
// (shardstats.cu), every existing child gets an nb_next entry here (an empty
// segment when this shard keeps no lane of it), and the history, one a rank,
// is not written.
//
// What bounds it on an H100: bytes.  Per pair it reads the keep mask twice
// (4 + 4 bytes), 12 bytes of the pair row and, per kept lane, 16 bytes of the
// rank outputs; it writes 24 bytes a kept lane.  Neighbouring threads walk
// neighbouring pair ranges; the row writes of one thread are contiguous per
// symbol.  Writes past pair_count or child_total are dropped (the host's
// counts size the outputs).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = kScanThreads;  // nodes (and threads) per block

__device__ __forceinline__ long long packed(int4 c) {
  long long lanes = (long long)c.x + c.y + c.z + c.w;
  long long kids = (c.x > 0) + (c.y > 0) + (c.z > 0) + (c.w > 0);
  return (lanes << 32) | kids;
}

__global__ void count_kernel(const int32_t* __restrict__ nb,
                             const uint8_t* __restrict__ keep, long long U,
                             long long P, int4* __restrict__ cnt,
                             long long* __restrict__ block_sum) {
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long v = 0;
  if (u < U) {
    int s = nb[u], e = nb[u + 1];
    int4 c = make_int4(0, 0, 0, 0);
    for (int p = s; p < e; ++p) {
      c.x += keep[p];
      c.y += keep[P + p];
      c.z += keep[2 * P + p];
      c.w += keep[3 * P + p];
    }
    cnt[u] = c;
    v = packed(c);
  }
  block_sum_to(v, block_sum);
}

// kOutsideIds: the child ids come from `flags` (exists bits 4-7) and `kid0`
// and no history entry is written; otherwise the symbols with a kept lane
// are numbered here and `hist` gets their entries.
template <bool kOutsideIds>
__global__ void scatter_kernel(
    const int32_t* __restrict__ nb, const int32_t* __restrict__ pairs,
    const int32_t* __restrict__ olo, const int32_t* __restrict__ ohi,
    const uint8_t* __restrict__ keep, long long U, long long P,
    const int4* __restrict__ cnt, const long long* __restrict__ block_off,
    const int32_t* __restrict__ flags, const int32_t* __restrict__ kid0,
    long long pair_count, long long child_total, int32_t* __restrict__ newp,
    int32_t* __restrict__ nb_next, int32_t* __restrict__ hist) {
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  int4 c = u < U ? cnt[u] : make_int4(0, 0, 0, 0);
  long long first = block_exclusive_scan(packed(c));
  if (u >= U) return;
  first += block_off[blockIdx.x];
  long long row = first >> 32;             // the node's first output row
  long long kid = kOutsideIds ? (long long)kid0[u] : first & 0xFFFFFFFFll;
  const int exists = kOutsideIds ? (flags[u] >> 4) & 15 : 0;
  const int count[4] = {c.x, c.y, c.z, c.w};
  long long slot[4];
  int child[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    slot[s] = row;
    row += count[s];
    child[s] = (int)kid;
    if (kOutsideIds ? (exists >> s) & 1 : count[s] > 0) {
      if (kid < child_total) {
        nb_next[kid] = (int32_t)slot[s];
        if (!kOutsideIds) hist[kid] = (int32_t)(u * 4 + s);
      }
      ++kid;
    }
  }
  if (u == U - 1 && kid <= child_total) nb_next[kid] = (int32_t)row;
  int pb = nb[u], pe = nb[u + 1];
  for (int p = pb; p < pe; ++p) {
    const int32_t* src = pairs + (long long)p * 6;
    uint32_t rlo = (uint32_t)src[2];
    int32_t sid = src[3], soff = src[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!keep[s * P + p]) continue;
      long long d = slot[s]++;
      if (d >= pair_count) continue;
      int32_t* to = newp + d * 6;
      to[0] = olo[s * P + p];
      to[1] = ohi[s * P + p];
      to[2] = (int32_t)(rlo + ((uint32_t)ohi[(4 + s) * P + p] -
                               (uint32_t)olo[(4 + s) * P + p]));
      to[3] = sid;
      to[4] = soff;
      to[5] = child[s];
    }
  }
}

template <bool kOutsideIds>
int run(const void* nb, const void* pairs, const void* olo, const void* ohi,
        const void* keep, long long U, long long P, const void* flags,
        const void* kid0, long long pair_count, long long child_total,
        void* cnt, void* scratch, void* newp, void* nb_next, void* hist,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (U + kThreads - 1) / kThreads;
  long long* block_sum = (long long*)scratch;
  long long* block_off = block_sum + nblocks;
  count_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const int32_t*)nb, (const uint8_t*)keep, U, P, (int4*)cnt, block_sum);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, 1024, 0, s>>>(block_sum, nblocks, block_off);
  err = (int)cudaGetLastError();
  if (err) return err;
  scatter_kernel<kOutsideIds><<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const int32_t*)nb, (const int32_t*)pairs, (const int32_t*)olo,
      (const int32_t*)ohi, (const uint8_t*)keep, U, P, (const int4*)cnt,
      block_off, (const int32_t*)flags, (const int32_t*)kid0, pair_count,
      child_total, (int32_t*)newp, (int32_t*)nb_next, (int32_t*)hist);
  return (int)cudaGetLastError();
}

}  // namespace

// cnt: (U, 4) int32; scratch: 2 * nblocks int64 (block sums, then block
// offsets), nblocks = ceil(U / 256).  U >= 1.
extern "C" int dsm_children(const void* nb, const void* pairs, const void* olo,
                            const void* ohi, const void* keep, long long U,
                            long long P, long long pair_count,
                            long long child_total, void* cnt, void* scratch,
                            void* newp, void* nb_next, void* hist,
                            void* stream) {
  return run<false>(nb, pairs, olo, ohi, keep, U, P, nullptr, nullptr,
                    pair_count, child_total, cnt, scratch, newp, nb_next, hist,
                    stream);
}

// flags, kid0: (U,) int32 from dsm_node_gates; nb_next has child_total + 1
// entries whatever this shard keeps.
extern "C" int dsm_children_ids(const void* nb, const void* pairs,
                                const void* olo, const void* ohi,
                                const void* keep, long long U, long long P,
                                const void* flags, const void* kid0,
                                long long pair_count, long long child_total,
                                void* cnt, void* scratch, void* newp,
                                void* nb_next, void* stream) {
  return run<true>(nb, pairs, olo, ohi, keep, U, P, flags, kid0, pair_count,
                   child_total, cnt, scratch, newp, nb_next, nullptr, stream);
}
