// The per-node statistics and gates of one trie level whose samples are
// sharded: each shard reduces its own pairs to node-indexed partial rows,
// the rows are summed over the shards, and the gates and the global child
// numbering follow from the sums.
//
// Replaces the stats, merge and numbering blocks of
// dsm_tpu/mining/engine_device.py _level_sharded (:421-489): boundary
// gathers of (8, B+1) int32 prefix sums at the shard's nb array, three
// int32 windows of the fixed-point entropy sums (the TPU has no int64), a
// psum over the samples axis, and a cumsum over a c-major exists lattice.
// Here the partial row of a node is three int64:
//
//   [0] the sum of its active pairs' frequencies,
//   [1] the sum of trunc((f+1)*log2(f+1) * 2^kNlnFp) over them: fixed point,
//       so that the sum over shards and ranks is the same integer in any
//       order (a term is under 2^53 and 512 of them fit),
//   [2] five 12-bit fields: the active readers, then the pairs with an
//       active child under A, C, G, T.  A node owns at most MAX_SAMPLES =
//       512 pairs over all shards, so a field of the summed rows never
//       carries into the next.
//
// partials (K9a): one thread a node walks the shard's pairs [nb[u], nb[u+1]),
// an empty range on a shard that holds none of the node's samples, and writes
// the row (zeros then).
//
// node_gates (K9b): one thread a node adds the n rows it is given (the
// shards of this process, already summed over the processes by the
// library's all-reduce where there are several), applies the gates of
// segstats.cu with the GLOBAL counts, and leaves its flags (present, stat,
// gated, the existing child symbols, and the active readers from bit 8 up)
// and entropy; the blocks' (present << 32 | children) sums are scanned
// (scan.cuh) and a second kernel gives every node its first child id and
// writes the history entries u*4 + c of its children, in (node, symbol)
// order.  Entries past the history's room are dropped: the level then ends
// as history-full and is redone.  counts[0] is the number of children,
// counts[1] the number of present nodes.
//
// What bounds both on an H100: bytes.  K9a reads 5 bytes a pair and 4 a node
// and writes 24 a node; K9b reads 24 bytes a node a shard and writes 16 a
// node and 4 a child.  Every value derived here is a function of integer
// sums alone, so all shards and processes gate and number alike.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = kScanThreads;
constexpr int kNlnFp = 17;      // fractional bits of the (f+1)log2(f+1) sums
constexpr int kFieldBits = 12;  // width of a count field of row entry [2]
constexpr long long kFieldMask = (1ll << kFieldBits) - 1;
constexpr int kPartCols = 3;

struct Gates {
  int depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask;
  double emin_lo, emax_hi;  // emin - margin, emax + margin
};

__global__ void partials_kernel(const int32_t* __restrict__ nb,
                                const int32_t* __restrict__ freq,
                                const uint8_t* __restrict__ cbits,
                                long long U, long long* __restrict__ part) {
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= U) return;
  const double kLog2 = 0.69314718055994530942;
  int s = nb[u], e = nb[u + 1];
  long long sumf = 0, nln = 0, fields = 0;
  for (int p = s; p < e; ++p) {
    int f = freq[p];
    if (f > 0) {
      sumf += f;
      double f1 = (double)f + 1.0;
      nln += (long long)(((f1 * log(f1)) / kLog2) * (double)(1 << kNlnFp));
      fields += 1;
    }
    unsigned b = cbits[p];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      fields += (long long)((b >> c) & 1u) << (kFieldBits * (c + 1));
  }
  long long* row = part + u * kPartCols;
  row[0] = sumf;
  row[1] = nln;
  row[2] = fields;
}

__global__ void gates_kernel(const long long* __restrict__ parts, int n_parts,
                             long long U, Gates g, int32_t* __restrict__ flags,
                             double* __restrict__ ent,
                             long long* __restrict__ block_sum) {
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long v = 0;
  if (u < U) {
    const double kLog2 = 0.69314718055994530942;
    long long sumf = 0, nln = 0, fields = 0;
    for (int k = 0; k < n_parts; ++k) {
      const long long* row = parts + ((long long)k * U + u) * kPartCols;
      sumf += row[0];
      nln += row[1];
      fields += row[2];
    }
    int nact = (int)(fields & kFieldMask);
    int exists = 0, numchildren = 0, sum_ex = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int cnt = (int)((fields >> (kFieldBits * (c + 1))) & kFieldMask);
      if (cnt > 0 && ((g.sym_mask >> c) & 1)) {
        exists |= 1 << c;
        ++numchildren;
        sum_ex += cnt;
      }
    }
    bool single_full = numchildren == 1 && sum_ex == nact;
    double sum_n = (double)((long long)g.s_total + sumf);
    double sumnln = (double)nln / (double)(1 << kNlnFp);
    double h = log(sum_n) / kLog2 - sumnln / sum_n;
    bool present = nact > 0 && g.depth >= 1;
    bool egate = !g.use_egate || (h >= g.emin_lo && h <= g.emax_hi);
    bool gated = present && g.depth >= g.mindepth && nact >= g.pmin &&
                 (g.pmax == 0 || nact <= g.pmax) && egate && !single_full;
    bool stat = present && !(nact == 1 && g.pmin > 1);
    flags[u] = (int)present | ((int)stat << 1) | ((int)gated << 2) |
               (exists << 4) | (nact << 8);
    ent[u] = h;
    v = ((long long)present << 32) | numchildren;
  }
  block_sum_to(v, block_sum);
}

__global__ void number_kernel(const int32_t* __restrict__ flags, long long U,
                              const long long* __restrict__ block_off,
                              int32_t* __restrict__ kid0,
                              int32_t* __restrict__ hist, long long room,
                              long long* __restrict__ counts) {
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  int f = u < U ? flags[u] : 0;
  int exists = (f >> 4) & 15;
  long long v = ((long long)(f & 1) << 32) | __popc(exists);
  long long first = block_exclusive_scan(v);
  if (u >= U) return;
  first += block_off[blockIdx.x];
  long long kid = first & 0xFFFFFFFFll;
  kid0[u] = (int32_t)kid;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if ((exists >> c) & 1) {
      if (kid < room) hist[kid] = (int32_t)(u * 4 + c);
      ++kid;
    }
  }
  if (u == U - 1) {
    counts[0] = kid;
    counts[1] = (first + v) >> 32;
  }
}

}  // namespace

// part: (U, 3) int64.  U >= 1.
extern "C" int dsm_shard_partials(const void* nb, const void* freq,
                                  const void* cbits, long long U, void* part,
                                  void* stream) {
  long long blocks = (U + kThreads - 1) / kThreads;
  partials_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nb, (const int32_t*)freq, (const uint8_t*)cbits, U,
      (long long*)part);
  return (int)cudaGetLastError();
}

// parts: (n_parts, U, 3) int64; scratch: 2 * ceil(U / 256) int64; hist has
// `room` entries; counts: 2 int64.  U >= 1.
extern "C" int dsm_node_gates(const void* parts, int n_parts, long long U,
                              int depth, int s_total, int mindepth, int pmin,
                              int pmax, int use_egate, int sym_mask,
                              double emin_lo, double emax_hi, void* flags,
                              void* ent, void* kid0, void* scratch, void* hist,
                              long long room, void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Gates g{depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask,
          emin_lo, emax_hi};
  long long nblocks = (U + kThreads - 1) / kThreads;
  long long* block_sum = (long long*)scratch;
  long long* block_off = block_sum + nblocks;
  gates_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const long long*)parts, n_parts, U, g, (int32_t*)flags, (double*)ent,
      block_sum);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, 1024, 0, s>>>(block_sum, nblocks, block_off);
  err = (int)cudaGetLastError();
  if (err) return err;
  number_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
      (const int32_t*)flags, U, block_off, (int32_t*)kid0, (int32_t*)hist,
      room, (long long*)counts);
  return (int)cudaGetLastError();
}
