// The per-node statistics and gates of one trie level whose samples are
// sharded: each process reduces its own pairs (the pairs of all its shards,
// in one list) to node-indexed partial rows, the rows are summed over the
// processes, and the gates, the global child numbering, the process's pair
// gates and the level's values follow from the sums.
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
//       so that the sum over processes is the same integer in any order (a
//       term is under 2^53 and 512 of them fit),
//   [2] five 12-bit fields: the active readers, then the pairs with an
//       active child under A, C, G, T.  A node owns at most MAX_SAMPLES =
//       512 pairs over all processes, so a field of the summed rows never
//       carries into the next.
//
// partials (K9a), one launch a process a level, over the process's one pair
// list (whatever its shards), writing one (U, 3) row a node.  Each pair's
// fixed-point term is made
// by the thread that loads the pair (for f < kLut from a table of int64
// terms made once a device with the same expression, so bit-equal to the
// computed term); the row is integers, so the order of the sums does not
// matter; a node without a pair in the process gets zeros.  Two shapes of
// one design, chosen by the level's width:
//   * a wide level (more than kWarpLevel pairs a node on average), on the
//     design of segstats.cu: a block takes tiles of consecutive nodes (512,
//     halved where nodes are wide) on a grid the card holds at once, the
//     next tile's node starts copied into shared memory (cp.async) while
//     it sums the current one; it cuts a tile's pair range into chunks of
//     at most kChunk pairs at node boundaries and stages freq and cbits
//     with coalesced loads into shared memory; a node of at most kWide
//     pairs is summed by a thread from there, a wider one by a warp; the
//     tile's rows are staged and stored coalesced, 24 bytes a node;
//   * a narrow level (the sharded levels of a few samples a process: 0..3
//     pairs a node), where that design's four barriers a tile cost more
//     than its coalescing gains: a warp takes 32 consecutive nodes at a
//     time, stages their pair range in chunks of kWarpPairs, a lane sums
//     its node from there (the warp a node of more than kWarpWide pairs)
//     and writes its row, 32 rows a warp contiguous; no block barrier.
// In its epilogue the process's kept lanes (popcount(cbits & sym_mask) over
// its pairs, the children step's row count) meet in a 64-bit atomic, and
// the last block (a ticket) writes them into their slot of the level's
// values and zeroes its running state.
//
// node_gates (K9b), one launch a process a level: tiles of kTile = 512
// nodes, two a thread, handed out in issue order by an atomic counter to a
// grid the card holds at once.  At a tile's start its node starts are
// copied into shared memory (cp.async) while a thread reads its two nodes'
// rows (already summed over the processes by the library's all-reduce
// where there are several), applies the gates of segstats.cu with the
// GLOBAL counts and writes the nodes' flags (present, stat, gated, the
// existing child symbols, the active readers from bit 8 up) and entropy.
// A block scan a round numbers the tile's children in node order, and the
// tile publishes its count for the decoupled look-back (lookback.cuh's
// status words).  Then the tile's pairs are the contiguous range
// [nb[n0], nb[n0 + kTile]): the thread of each pair finds its node in the
// staged nb and stores the staged gate, so pair_out is written coalesced
// and whole (no memset first), and the gated pairs are counted.  Only then
// does warp 0 look back, so
// that its predecessors have had the pair pass to publish their prefixes
// and the walk is short, and kid0 and the history entries u*4 + c (staged
// in shared memory, stored coalesced; entries past the history's room are
// dropped, and the level then ends as history-full and is redone) are
// written.  A
// block adds its tiles' share of the level's values with integer atomics
// once (the entropy range as order-preserving keys, exact whatever the
// order of the blocks): the children, the present nodes, the entropy range
// over the nodes with F_STAT and the gated pairs.  The last block (a
// ticket) writes them with the staged rows after the emit, ocount + the
// gated pairs, into the level's values, and zeroes the running state and
// the look-back words for the next launch on the stream.
//
// What bounds both on an H100: bytes.  K9a reads 5 bytes a pair and 4 a node
// and writes 24 a node; K9b reads 24 bytes and 4 of nb a node, and writes
// 20 a node (flags, entropy, kid0), 4 a child and a byte a pair.  Every
// value derived here is a function of integer sums alone, so all processes
// gate and number alike.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNlnFp = 17;      // fractional bits of the (f+1)log2(f+1) sums
constexpr int kFieldBits = 12;  // width of a count field of row entry [2]
constexpr long long kFieldMask = (1ll << kFieldBits) - 1;
constexpr int kPartCols = 3;
constexpr int kMaxTile = 512;   // K9a: the most nodes a tile
constexpr int kMinTile = 32;    // the fewest
constexpr int kChunk = 2048;    // pairs a block stages at once
constexpr int kWide = 64;       // a node of more pairs is summed by a warp
constexpr int kLut = 4096;      // terms tabulated for f < kLut
constexpr int kNodes = 2;       // K9b: nodes a thread a tile
constexpr int kTile = kThreads * kNodes;  // K9b: nodes a tile
constexpr int kWarpPairs = 128; // K9a by warps: pairs a warp stages at once
constexpr int kWarpWide = 32;   // a node of more pairs is summed by the warp
constexpr int kWarpLevel = 4;   // K9a by warps where P <= kWarpLevel * U
constexpr int kMaxDevices = 64;
constexpr double kLog2 = 0.69314718055994530942;

// the running state a (device, stream), uint64 words that are 0 between
// launches: K9a's ticket and kept lanes, then K9b's (ops/shardstats.py
// _STATE_WORDS counts them)
enum : int {
  kPartTicket, kPartKept,
  kGateTicket, kGateNextTile, kGateChildren, kGatePresent, kGateEntMax,
  kGateEntMinNeg, kGateGated
};

// the level's values (f64): see ops/shardstats.py V_*
enum : int {
  kVChildren, kVPresent, kVEntMin, kVEntMax, kVStaged, kVKept, kVGated
};

struct Gates {
  int depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask;
  double emin_lo, emax_hi;  // emin - margin, emax + margin
};

__device__ __forceinline__ long long nln_term(int f) {
  const double f1 = (double)f + 1.0;
  return (long long)(((f1 * log(f1)) / kLog2) * (double)(1 << kNlnFp));
}

// the fixed-point term of 0 <= f < kLut, 0 at f = 0
__device__ long long g_term[kLut];

__global__ void term_table_kernel() {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < kLut) g_term[f] = f > 0 ? nln_term(f) : 0;
}

__device__ __forceinline__ long long pair_term(int f) {
  if ((unsigned)f < (unsigned)kLut) return g_term[f];
  return f > 0 ? nln_term(f) : 0;
}

__device__ __forceinline__ double pos_inf() {
  return __longlong_as_double(0x7FF0000000000000ll);
}

// A double's order as an unsigned key: a < b iff key(a) < key(b), and 0 is
// below every key, so 0 stands for "none yet".
__device__ __forceinline__ unsigned long long order_key(double d) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(d);
  return (b >> 63) ? ~b : b | 0x8000000000000000ull;
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double((long long)((k >> 63) ? k & ~0x8000000000000000ull
                                                     : ~k));
}

// count int32 from src into shared dst by asynchronous copies (cp.async),
// one commit group that the caller waits for.
__device__ __forceinline__ void stage_ints(int* dst, const int32_t* src,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// A node's partial row.
struct Row {
  long long sumf, nln, fields;
};

// A staged pair into a row: f is 0 for an inactive pair, and so is its term.
__device__ __forceinline__ void add_pair(Row& r, int f, long long term,
                                         unsigned b) {
  r.sumf += f;
  r.nln += term;
  r.fields += (long long)(f > 0) | (long long)(b & 1u) << kFieldBits |
              (long long)(b & 2u) << (2 * kFieldBits - 1) |
              (long long)(b & 4u) << (3 * kFieldBits - 2) |
              (long long)(b & 8u) << (4 * kFieldBits - 3);
}

__global__ void __launch_bounds__(kThreads)
partials_kernel(const int32_t* __restrict__ nb,
                const int32_t* __restrict__ freq,
                const uint8_t* __restrict__ cbits, long long n_nodes,
                int tile, unsigned sym_mask, long long* __restrict__ part,
                unsigned long long* __restrict__ state,
                double* __restrict__ kept_out) {
  __shared__ int s_nb[2][kMaxTile + 1];  // this tile's and the next's
  __shared__ long long s_term[kChunk];
  __shared__ long long s_row[kMaxTile * kPartCols];
  __shared__ int s_f[kChunk];
  __shared__ uint8_t s_b[kChunk];
  __shared__ int s_wide[kChunk / (kWide + 1) + 1];
  __shared__ int s_nwide;
  __shared__ unsigned long long s_red[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long kept = 0;
  const long long n_tiles = (n_nodes + tile - 1) / tile;
  if (blockIdx.x < n_tiles) {
    const long long n0 = blockIdx.x * (long long)tile;
    stage_ints(s_nb[0], nb + n0, (int)min((long long)tile, n_nodes - n0) + 1);
  }
  int buf = 0;
  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x, buf ^= 1) {
    const long long n0 = ti * tile;
    const int cnt = (int)min((long long)tile, n_nodes - n0);
    __pipeline_wait_prior(0);
    __syncthreads();
    // the next tile's node starts on their way while this one is summed
    // (its buffer was last read before the previous tile's last barrier)
    const long long tn = ti + gridDim.x;
    if (tn < n_tiles)
      stage_ints(s_nb[buf ^ 1], nb + tn * tile,
                 (int)min((long long)tile, n_nodes - tn * tile) + 1);
    const int* s_nb_t = s_nb[buf];
    for (int m = 0; m < cnt;) {
      // the chunk: nodes [m, m1), the most whose pairs fit in kChunk
      const int c0 = s_nb_t[m];
      int lo = m + 1, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_nb_t[mid] - c0 <= kChunk) lo = mid; else hi = mid - 1;
      }
      const int m1 = lo, c1 = s_nb_t[m1];
      if (c1 - c0 > kChunk) __trap();  // a node of more than kChunk pairs
      for (int p = c0 + t; p < c1; p += kThreads) {
        const int f = freq[p];
        const unsigned b = cbits[p];
        s_f[p - c0] = f > 0 ? f : 0;
        s_term[p - c0] = pair_term(f);
        s_b[p - c0] = (uint8_t)b;
        kept += __popc(b & sym_mask);
      }
      if (t == 0) s_nwide = 0;
      __syncthreads();
      // a narrow node by its thread; a wide one onto the warps' list
      for (int k = m + t; k < m1; k += kThreads) {
        const int s = s_nb_t[k], e = s_nb_t[k + 1];
        if (e - s > kWide) {
          s_wide[atomicAdd(&s_nwide, 1)] = k;
          continue;
        }
        Row r{0, 0, 0};
        for (int p = s; p < e; ++p)
          add_pair(r, s_f[p - c0], s_term[p - c0], s_b[p - c0]);
        s_row[k * kPartCols] = r.sumf;
        s_row[k * kPartCols + 1] = r.nln;
        s_row[k * kPartCols + 2] = r.fields;
      }
      __syncthreads();
      for (int j = warp; j < s_nwide; j += kWarps) {
        const int k = s_wide[j], s = s_nb_t[k], e = s_nb_t[k + 1];
        Row x{0, 0, 0};
        for (int p = s + lane; p < e; p += 32)
          add_pair(x, s_f[p - c0], s_term[p - c0], s_b[p - c0]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          x.sumf += __shfl_xor_sync(0xFFFFFFFFu, x.sumf, o);
          x.nln += __shfl_xor_sync(0xFFFFFFFFu, x.nln, o);
          x.fields += __shfl_xor_sync(0xFFFFFFFFu, x.fields, o);
        }
        if (lane == 0) {
          s_row[k * kPartCols] = x.sumf;
          s_row[k * kPartCols + 1] = x.nln;
          s_row[k * kPartCols + 2] = x.fields;
        }
      }
      __syncthreads();  // the chunk is summed before the next is staged
      m = m1;
    }
    // the tile's rows, coalesced; the next tile writes s_row only after
    // its first barrier
    long long* dst = part + n0 * kPartCols;
    for (int i = t; i < cnt * kPartCols; i += kThreads)
      dst[i] = s_row[i];
  }

  // the block's kept lanes into the level's: a 64-bit atomic, then the
  // last block to finish (a ticket) writes them and zeroes its words
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_xor_sync(0xFFFFFFFFu, kept, o);
  if (lane == 0) s_red[warp] = kept;
  __syncthreads();
  if (t != 0) return;
  unsigned long long r = 0;
  for (int w = 0; w < kWarps; ++w) r += s_red[w];
  if (r) atomicAdd(state + kPartKept, r);
  __threadfence();
  if (atomicAdd(state + kPartTicket, 1ull) != gridDim.x - 1) return;
  __threadfence();
  volatile unsigned long long* vs = state;
  *kept_out = (double)vs[kPartKept];
  vs[kPartKept] = 0;
  vs[kPartTicket] = 0;  // every block of this launch is done
}

// K9a by warps: a warp takes 32 consecutive nodes at a time; it stages
// their pair range in chunks of kWarpPairs (coalesced, each pair's term made
// by the lane that loads it), a lane sums its node from shared memory and
// the warp sums a node of more than kWarpWide pairs; a lane writes its row.
__global__ void __launch_bounds__(kThreads)
partials_warp_kernel(const int32_t* __restrict__ nb,
                     const int32_t* __restrict__ freq,
                     const uint8_t* __restrict__ cbits, long long n_nodes,
                     unsigned sym_mask, long long* __restrict__ part,
                     unsigned long long* __restrict__ state,
                     double* __restrict__ kept_out) {
  __shared__ long long s_term[kWarps][kWarpPairs];
  __shared__ int s_f[kWarps][kWarpPairs];
  __shared__ uint8_t s_b[kWarps][kWarpPairs];
  __shared__ unsigned long long s_red[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long* const tf = s_term[warp];
  int* const ff = s_f[warp];
  uint8_t* const bf = s_b[warp];
  unsigned long long kept = 0;
  const long long n_wt = (n_nodes + 31) / 32;
  for (long long wt = (long long)blockIdx.x * kWarps + warp; wt < n_wt;
       wt += (long long)gridDim.x * kWarps) {
    const long long n0 = wt * 32;
    const int cnt = (int)min(32ll, n_nodes - n0);
    int s = 0, e = 0;
    if (lane < cnt) {
      s = nb[n0 + lane];
      e = nb[n0 + lane + 1];
    }
    const int c0 = __shfl_sync(0xFFFFFFFFu, s, 0);
    const int c1 = __shfl_sync(0xFFFFFFFFu, e, cnt - 1);
    const bool wide = e - s > kWarpWide;
    Row r{0, 0, 0};
    for (int q0 = c0; q0 < c1; q0 += kWarpPairs) {
      const int q1 = min(q0 + kWarpPairs, c1);
      for (int p = q0 + lane; p < q1; p += 32) {
        const int f = freq[p];
        const unsigned b = cbits[p];
        ff[p - q0] = f > 0 ? f : 0;
        tf[p - q0] = pair_term(f);
        bf[p - q0] = (uint8_t)b;
        kept += __popc(b & sym_mask);
      }
      __syncwarp();
      if (!wide)
        for (int p = max(s, q0); p < min(e, q1); ++p)
          add_pair(r, ff[p - q0], tf[p - q0], bf[p - q0]);
      for (unsigned m = __ballot_sync(0xFFFFFFFFu, wide && s < q1 && e > q0);
           m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int sj = max(__shfl_sync(0xFFFFFFFFu, s, j), q0);
        const int ej = min(__shfl_sync(0xFFFFFFFFu, e, j), q1);
        Row x{0, 0, 0};
        for (int p = sj + lane; p < ej; p += 32)
          add_pair(x, ff[p - q0], tf[p - q0], bf[p - q0]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          x.sumf += __shfl_xor_sync(0xFFFFFFFFu, x.sumf, o);
          x.nln += __shfl_xor_sync(0xFFFFFFFFu, x.nln, o);
          x.fields += __shfl_xor_sync(0xFFFFFFFFu, x.fields, o);
        }
        if (lane == j) {
          r.sumf += x.sumf;
          r.nln += x.nln;
          r.fields += x.fields;
        }
      }
      __syncwarp();  // the chunk is summed before the next is staged
    }
    if (lane < cnt) {
      long long* row = part + (n0 + lane) * kPartCols;
      row[0] = r.sumf;
      row[1] = r.nln;
      row[2] = r.fields;
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    kept += __shfl_xor_sync(0xFFFFFFFFu, kept, o);
  if (lane == 0) s_red[warp] = kept;
  __syncthreads();
  if (t != 0) return;
  unsigned long long r = 0;
  for (int w = 0; w < kWarps; ++w) r += s_red[w];
  if (r) atomicAdd(state + kPartKept, r);
  __threadfence();
  if (atomicAdd(state + kPartTicket, 1ull) != gridDim.x - 1) return;
  __threadfence();
  volatile unsigned long long* vs = state;
  *kept_out = (double)vs[kPartKept];
  vs[kPartKept] = 0;
  vs[kPartTicket] = 0;
}

__global__ void __launch_bounds__(kThreads)
gates_kernel(const long long* __restrict__ part, long long U,
             long long ntiles, Gates g, int32_t* __restrict__ flags,
             double* __restrict__ ent, int32_t* __restrict__ kid0,
             int32_t* __restrict__ hist, long long room,
             const int32_t* __restrict__ nb, uint8_t* __restrict__ pair_out,
             long long ocount, unsigned long long* __restrict__ state,
             unsigned long long* __restrict__ status,
             double* __restrict__ vals) {
  __shared__ int s_nb[kTile + 1];
  __shared__ int32_t s_hist[4 * kTile];
  __shared__ uint8_t s_gate[kTile];
  __shared__ int s_wsum[kWarps];
  __shared__ unsigned long long s_red[kWarps][2];
  __shared__ double s_redd[kWarps][2];
  __shared__ long long s_tile, s_base;
  __shared__ int s_last;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the block's share of the level's values, over its tiles
  unsigned long long pres = 0, children = 0, gp = 0;
  double emin = pos_inf(), emax = -pos_inf();
  for (;;) {
    if (t == 0) s_tile = (long long)atomicAdd(state + kGateNextTile, 1ull);
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= ntiles) break;
    const long long n0 = tile * kTile;
    const int cnt = (int)min((long long)kTile, U - n0);
    // the tile's nb on its way while the rows are read
    stage_ints(s_nb, nb + n0, cnt + 1);

    // ---- a thread's kNodes nodes (t, t + kThreads, ...): their rows -----
    long long sumf[kNodes], nln[kNodes], fields[kNodes];
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      const int i = min(j * kThreads + t, cnt - 1);
      const long long* row = part + (n0 + i) * kPartCols;
      sumf[j] = row[0];
      nln[j] = row[1];
      fields[j] = row[2];
    }

    // ---- their gates, flags and entropy; the children numbered in node
    // order by a block scan a round; the tile's count published ----------
    int excl[kNodes], exists[kNodes], total = 0;
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      const int i = j * kThreads + t;
      const long long u = n0 + i;
      int numchildren = 0;
      bool gated = false;
      exists[j] = 0;
      if (i < cnt) {
        const int nact = (int)(fields[j] & kFieldMask);
        int sum_ex = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cnt_c =
              (int)((fields[j] >> (kFieldBits * (c + 1))) & kFieldMask);
          if (cnt_c > 0 && ((g.sym_mask >> c) & 1)) {
            exists[j] |= 1 << c;
            ++numchildren;
            sum_ex += cnt_c;
          }
        }
        const bool single_full = numchildren == 1 && sum_ex == nact;
        const double sum_n = (double)((long long)g.s_total + sumf[j]);
        const double sumnln = (double)nln[j] / (double)(1 << kNlnFp);
        const double h = log(sum_n) / kLog2 - sumnln / sum_n;
        const bool present = nact > 0 && g.depth >= 1;
        const bool egate =
            !g.use_egate || (h >= g.emin_lo && h <= g.emax_hi);
        gated = present && g.depth >= g.mindepth && nact >= g.pmin &&
                (g.pmax == 0 || nact <= g.pmax) && egate && !single_full;
        const bool stat = present && !(nact == 1 && g.pmin > 1);
        flags[u] = (int)present | ((int)stat << 1) | ((int)gated << 2) |
                   (exists[j] << 4) | (nact << 8);
        ent[u] = h;
        pres += present;
        if (stat) {
          emin = fmin(emin, h);
          emax = fmax(emax, h);
        }
      }
      s_gate[i] = (uint8_t)gated;
      int incl = numchildren;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      int below = 0, round = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int v = s_wsum[w];
        below += w < warp ? v : 0;
        round += v;
      }
      excl[j] = total + below + incl - numchildren;
      total += round;
      int at = excl[j];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((exists[j] >> c) & 1) s_hist[at++] = (int32_t)(u * 4 + c);
      __syncthreads();  // s_wsum is read
    }
    if (t == 0) {
      children += total;
      dsm::put(status + tile,
               (tile == 0 ? dsm::kPrefix : dsm::kAggregate) | (unsigned)total);
    }

    // ---- the tile's gated pairs and its pair gates, coalesced -----------
    __pipeline_wait_prior(0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      const int i = j * kThreads + t;
      if (i < cnt && s_gate[i]) gp += (unsigned)(s_nb[i + 1] - s_nb[i]);
    }
    const int c1 = s_nb[cnt];
    for (int p = s_nb[0] + t; p < c1; p += kThreads) {
      int lo = 0, hi = cnt - 1;  // the last node whose first pair <= p
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_nb[mid] <= p) lo = mid; else hi = mid - 1;
      }
      pair_out[p] = s_gate[lo];
    }

    // ---- the tile's first child id: the look-back (by then its
    // predecessors have mostly published theirs); kid0, history -----------
    if (tile > 0 && warp == 0) {
      const unsigned long long e = dsm::lookback_exclusive(status, tile);
      if (lane == 0) {
        dsm::put(status + tile, dsm::kPrefix | (unsigned)(e + total));
        s_base = (long long)e;
      }
    } else if (tile == 0 && t == 0) {
      s_base = 0;
    }
    __syncthreads();
    const long long base = s_base;
#pragma unroll
    for (int j = 0; j < kNodes; ++j) {
      const int i = j * kThreads + t;
      if (i < cnt) kid0[n0 + i] = (int32_t)(base + excl[j]);
    }
    for (int i = t; i < total; i += kThreads)
      if (base + i < room) hist[base + i] = s_hist[i];
  }

  // ---- the level's values: the block's share in integer atomics ---------
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    pres += __shfl_xor_sync(0xFFFFFFFFu, pres, o);
    gp += __shfl_xor_sync(0xFFFFFFFFu, gp, o);
    emin = fmin(emin, __shfl_xor_sync(0xFFFFFFFFu, emin, o));
    emax = fmax(emax, __shfl_xor_sync(0xFFFFFFFFu, emax, o));
  }
  if (lane == 0) {
    s_red[warp][0] = pres;
    s_red[warp][1] = gp;
    s_redd[warp][0] = emin;
    s_redd[warp][1] = emax;
  }
  __syncthreads();
  if (t == 0) {
    unsigned long long r = 0, q = 0;
    for (int w = 0; w < kWarps; ++w) {
      r += s_red[w][0];
      q += s_red[w][1];
      emin = fmin(emin, s_redd[w][0]);
      emax = fmax(emax, s_redd[w][1]);
    }
    if (children) atomicAdd(state + kGateChildren, children);
    if (r) atomicAdd(state + kGatePresent, r);
    if (q) atomicAdd(state + kGateGated, q);
    if (emax >= emin) {  // the block has a node with F_STAT
      atomicMax(state + kGateEntMax, order_key(emax));
      atomicMax(state + kGateEntMinNeg, ~order_key(emin));
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(state + kGateTicket, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // ---- the last block: the values out, the running state back to 0 ------
  __threadfence();
  for (long long i = t; i < ntiles; i += kThreads) status[i] = 0;
  if (t != 0) return;
  volatile unsigned long long* vs = state;
  vals[kVChildren] = (double)vs[kGateChildren];
  vals[kVPresent] = (double)vs[kGatePresent];
  const unsigned long long hi = vs[kGateEntMax], lo = vs[kGateEntMinNeg];
  vals[kVEntMin] = lo ? key_value(~lo) : pos_inf();
  vals[kVEntMax] = hi ? key_value(hi) : -pos_inf();
  const long long gated = (long long)vs[kGateGated];
  vals[kVGated] = (double)gated;
  vals[kVStaged] = (double)(ocount + gated);
  for (int i = kGateTicket; i <= kGateGated; ++i) vs[i] = 0;
}

// Once a device: the blocks of `kernel` the card holds at once.
template <typename K>
int resident_blocks(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  *out = sms * per_sm;
  return (int)err;
}

// Once a device: the blocks of both kernels the card holds at once, and
// the term table (made on the launch's stream, waited for once).
struct Resident {
  int partials, partials_warp, gates;
};

int resident(cudaStream_t stream, Resident* out) {
  static Resident once[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (once[dev].partials == 0) {
    Resident r{0, 0, 0};
    int e = resident_blocks(partials_kernel, &r.partials);
    if (!e) e = resident_blocks(partials_warp_kernel, &r.partials_warp);
    if (!e) e = resident_blocks(gates_kernel, &r.gates);
    if (e) return e;
    term_table_kernel<<<(kLut + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>();
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    once[dev] = r;
  }
  *out = once[dev];
  return 0;
}

}  // namespace

// nb: (U+1,) int32; freq: (P,) int32, 0 for an inactive pair; cbits: (P,)
// uint8; part: (U, 3) int64, the rows written; state: the running state of
// ops/shardstats.py (0 at the launch and again when the kernel ends, used
// by one stream at a time); kept: 1 f64, the kept lanes' slot of the
// level's values.  U >= 1; a
// node holds at most kChunk pairs (MAX_SAMPLES = 512), else the launch
// stops with a fault.
extern "C" int dsm_shard_partials(const void* nb, const void* freq,
                                  const void* cbits, long long U, long long P,
                                  int sym_mask, void* part,
                                  void* state, void* kept, void* stream) {
  if (U < 1 || P < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Resident r;
  const int err = resident(s, &r);
  if (err) return err;
  if (P <= kWarpLevel * U) {  // a narrow level: by warps
    long long blocks = (U + 32 * kWarps - 1) / (32 * kWarps);
    if (blocks > r.partials_warp) blocks = r.partials_warp;
    partials_warp_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)nb, (const int32_t*)freq, (const uint8_t*)cbits, U,
        (unsigned)sym_mask, (long long*)part, (unsigned long long*)state,
        (double*)kept);
    return (int)cudaGetLastError();
  }
  // the tile: kMaxTile nodes, halved while a tile would hold more than 7/8
  // of kChunk pairs on average
  long long tile = kMaxTile;
  while (tile > kMinTile && 8 * tile * P > 7ll * kChunk * U) tile /= 2;
  long long blocks = (U + tile - 1) / tile;
  if (blocks > r.partials) blocks = r.partials;
  partials_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)nb, (const int32_t*)freq, (const uint8_t*)cbits, U,
      (int)tile, (unsigned)sym_mask, (long long*)part,
      (unsigned long long*)state, (double*)kept);
  return (int)cudaGetLastError();
}

// The look-back words node_gates needs for U nodes: one a tile.
extern "C" long long dsm_node_gates_workspace(long long U) {
  return (U + kTile - 1) / kTile;
}

// part: (U, 3) int64, the process's rows (summed over the processes where
// there are several); flags, kid0: (U,) int32; ent: (U,) f64; hist has
// `room` entries; nb: (U+1,) int32, the process's node starts; pair_out:
// (nb[U],) bool; ocount: the rows staged before this level; state and
// status: the running state and `words` >= dsm_node_gates_workspace(U)
// look-back words of ops/shardstats.py (0 at the launch and again when the
// kernel ends, used by one stream at a time); vals: the level's values
// (7 f64; the kept lanes' slot is not written).  U >= 1.
extern "C" int dsm_node_gates(const void* part, long long U, int depth,
                              int s_total, int mindepth, int pmin, int pmax,
                              int use_egate, int sym_mask, double emin_lo,
                              double emax_hi, void* flags, void* ent,
                              void* kid0, void* hist, long long room,
                              const void* nb, void* pair_out,
                              long long ocount, void* state, void* status,
                              long long words, void* vals, void* stream) {
  const long long tiles = dsm_node_gates_workspace(U);
  if (U < 1 || words < tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Resident r;
  const int err = resident(s, &r);
  if (err) return err;
  Gates g{depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask,
          emin_lo, emax_hi};
  const long long blocks = tiles < r.gates ? tiles : r.gates;
  gates_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const long long*)part, U, tiles, g, (int32_t*)flags, (double*)ent,
      (int32_t*)kid0, (int32_t*)hist, room, (const int32_t*)nb,
      (uint8_t*)pair_out, ocount, (unsigned long long*)state,
      (unsigned long long*)status, (double*)vals);
  return (int)cudaGetLastError();
}
