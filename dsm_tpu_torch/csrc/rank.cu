// Fused rank over the baked-C4 occ tables (K1), the level's expand step
// built on it (the per-pair, per-level hot primitive of the mining episode)
// and the drain's leftChar codes (K5); below them, a kernel of its own on
// the same row gather, the per-level engines' dense expand (K12).
//
// Replaces dsm_tpu/ops/rank.py occ_cumT / occ_cum8T (the XLA column gather
// over the transposed (32, R) table); with the `expand` entry, the expand
// step of dsm_tpu/mining/engine_device.py _level_single (714-724) and
// _level_sharded (409-419): both interval ends of every pair and the gate
// inputs (freq, the active and kept child lanes, the child bits) in one
// launch, over one table (the single-device level) or over the tables of
// a process's shards (the sharded level, `expand_tables`: each pair's table
// found from its sample id); with the `leftchar` entry, _jitted_lc_pairs
// (engine_device.py:1077, leftchar_codes_pairsT, dsm_tpu/mining/engine.py
// :239-260) and the shard_lc body of dsm_tpu/parallel/engine_episode.py
// _jitted_lc_sharded (:242-267): the soff lookup by sample id, both ends'
// ranks in the reverse table, the four right-extension counts and the code
// select in one launch, over the staged output rows of one device or of
// every shard of a process.  Here the table stays row-major (R, 32)
// uint32: one 128-byte row per 128-symbol block holds the 8 cum words (C4
// baked in, wrapping mod 2^32) and five thermometer bit planes of 4 words
// each (ops/rank.py fused_rows); words 28..31 are padding.
//
// What bounds it on an H100: one dependent row gather per interval end.
// At scale 100 the forward table (~8 MB) sits in the 50 MB L2, so the
// gather costs L1/L2 transactions rather than DRAM bytes: one thread per
// query issuing seven scattered 16-byte loads made each warp instruction
// touch 32 different 128-byte lines (7 x 32 L1 tag lookups for 32 queries).
// The needed DRAM bytes are the inputs once (24 B a pair row, a table row
// once) and the outputs once (64 B of ranks, 9 B of gate inputs a pair).
//
// The design:
//   * a group of 8 lanes serves one query (or pair): lane k loads 16-byte
//     word-group k of the row, so one warp instruction covers four whole
//     rows (4 lookups instead of 32).  Lanes 2..6 hold the planes j = 1..5
//     and popcount theirs under the position's mask; lanes 0..1 hold the
//     cum words, which three shuffles hand to the plane lanes; lane 7's
//     words are padding and are not loaded.  One more shuffle gives each
//     plane lane its neighbour's count, and lanes 2, 3, 4 and 6 each write
//     two of the eight outputs.
//   * both ends in one pass: when lo and hi fall in the same table row (most
//     pairs from depth ~10 on) the group reuses the loaded row and its cum
//     words under hi's mask; otherwise both rows' loads are issued together.
//   * a block takes a tile of kTile pairs: the 24-byte pair rows come in with
//     coalesced 16-byte loads into shared memory (no strided column reads),
//     the (8, tile) outputs of both ends are staged in shared memory, and
//     each output row is stored coalesced, with freq, keepc and cbits in the
//     same epilogue.
// With the lookups cut, the work of an end bounds it rather than bytes:
// every lane of the group computes the masks and four popcounts (POPC runs
// at a quarter of the integer rate), so an end that reuses its pair's row
// costs nearly what an end that loads one does.  A quad of lanes a query
// (two 16-byte loads a lane, all four lanes popcounting) measured faster
// for one end but slower for the expand step (more registers, fewer blocks
// an SM), so the group stays 8 lanes.
// All arithmetic is uint32, reinterpreted as int32, as lax.bitcast_convert
// does in the JAX version; the baked-C4 wrap-around stays bit-exact.
//
// The expand_tables entry stages a tile's pair rows as expand does, with the
// launch's shard bases (the first process-local sample id of each table,
// ascending) in shared memory; each pair's thread bisects them for the last
// base at or below its PC_SID and keeps the table's number in that column of
// the staged row (expand reads no sample id), and the group path gathers
// both ends' rows from that table.  The one-table `expand` entry is another
// instantiation of the same body and does none of this.
//
// The leftChar entry stages a tile's 20-byte output rows with 16-byte loads
// (the tile starts 5120 bytes apart, so one aligned list keeps every tile
// aligned), finds each row's shard by bisecting the launch's parameter
// table (the last shard whose first sample id is <= the row's), reads its
// soff there, and puts (rlo, rlo + freq, soff, shard) in pair-row layout;
// the group path then gathers both ends' rows from that shard's table, and
// the epilogue turns the two ends' four counts into the code: nothing but
// the rows, the soff entries, the table rows and one byte a row move.
//
// Entries (one kernel body, a mode each; ops/rank.py and mining/engine.py
// count all of them as launches of `rank`): dsm_occ_cum8 (one end,
// (8, Q)), dsm_expand (the (P, 6) pair rows -> olo, ohi, freq, keepc,
// cbits), dsm_expand_tables (the same over up to kMaxShards tables),
// dsm_leftchar (the (n, 5) output rows and a shard table -> (n,) int8
// codes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // 32 groups of 8 lanes
constexpr int kGroups = kThreads / 8;
constexpr int kTile = 256;              // queries (pairs) a block
// the staging and the epilogue give each thread one query of the tile
static_assert(kTile == kThreads, "one thread a query at both ends");
constexpr int kPairCols = 6;            // ops/children.py PAIR_COLS
constexpr int kLo = 0, kHi = 1, kSoff = 4;   // PC_LO, PC_HI, PC_SOFF
// kLeftChar and kExpandTables: the row's shard, in the column the pair rows
// keep PC_SID in
constexpr int kShard = 3;
// kLeftChar: the staged output rows (mining/engine.py OC_*, OUT_COLS)
constexpr int kOutCols = 5;
constexpr int kOcFreq = 0, kOcRlo = 1, kOcSid = 2;
constexpr int kMaxShards = 128;  // ops/shardstats.py MAX_SHARDS
constexpr int kLcN = 1, kLcZero = 0;  // mining/engine_np.py LC_N, LC_ZERO
// a staged output row: + 8 words puts the four writing lanes of a group
// (rows 0..3, or 4..7, at one column) and the warp's four groups
// (neighbouring columns) in 16 distinct banks
constexpr int kOutStride = kTile + 8;

enum Mode { kSingle = 0, kExpand = 1, kLeftChar = 2, kExpandTables = 3 };

struct Args {
  const uint4* rows;
  const int32_t* pairs;                  // kExpand*: (n, 6) rows
  const int32_t* lo;                     // kSingle (pos)
  const int32_t* soff;                   // kSingle
  long long lo_stride, soff_stride;
  int32_t* olo;                          // (8, n), kSingle and kExpand*
  int32_t* ohi;                          // (8, n), kExpand*
  int32_t* freq;                         // (n,), kExpand*
  uint8_t* keepc;                        // (4, n) bool, kExpand*
  uint8_t* cbits;                        // (n,), kExpand*
  const int32_t* orows;                  // kLeftChar: (n, 5) rows
  int8_t* codes;                         // kLeftChar: (n,)
  long long n;
  int fmin, sym_mask;
};

// kLeftChar's shards, in the launch's parameters: shard k's reverse table,
// its soff (by local sample id) and its first global sample id, the bases
// in ascending order.
struct LcShard {
  const uint4* rows;
  const int32_t* soff;
  long long base;
};

template <int kMode>
struct Shards {
  int n;
};

template <>
struct Shards<kLeftChar> {
  int n;
  LcShard s[kMaxShards];
};

// kExpandTables' tables, in the launch's parameters: table k's forward rows
// and its first process-local sample id, the bases ascending.
template <>
struct Shards<kExpandTables> {
  int n;
  int base[kMaxShards];
  const uint4* rows[kMaxShards];
};

// The row of `blk`'s word-group `lane` (lane 7's is padding).
__device__ __forceinline__ uint4 load_row(const uint4* rows, long long blk,
                                          int lane) {
  return lane < 7 ? __ldg(rows + blk * 8 + lane) : make_uint4(0, 0, 0, 0);
}

// Cum word (lane - 1) of the row whose word-groups 0 and 1 lanes 0 and 1
// hold, in plane lanes 2..6 (cum1..3 from lane 0, cum4..5 from lane 1).
__device__ __forceinline__ uint32_t cum_word(uint4 v, int lane,
                                             unsigned mask) {
  const int from = lane <= 4 ? 0 : 1;
  const uint32_t t1 = __shfl_sync(mask, v.y, from, 8);    // cum1 | cum5
  const uint32_t t2 = __shfl_sync(mask, v.z, 0, 8);       // cum2
  const uint32_t t3 =
      __shfl_sync(mask, lane == 0 ? v.w : v.x, from, 8);  // cum3 | cum4
  return lane == 3 ? t2 : ((lane == 4 || lane == 5) ? t3 : t1);
}

// The low max(b, 0) bits set, all 32 from b = 32 on: PTX shl takes a
// shift of 32 or more as 32 (C++ leaves it undefined), so a mask costs a
// max, a shift and a not instead of compares and selects.
__device__ __forceinline__ uint32_t low_bits(int b) {
  uint32_t r;
  const uint32_t shift = b > 0 ? b : 0;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(0xFFFFFFFFu), "r"(shift));
  return ~r;
}

// One interval end: in plane lane 2 + j, c[j] = cum(j+1) + the popcount of
// plane j+1 under pos's mask; lanes 2, 3, 4 and 6 then write outputs
// (r, r + 4) of column `col` in the staged rows `out`:
//   [c1-c0, c2-c1, c3-c2, pos-c4, c0, c1, c2, c4].
__device__ __forceinline__ void rank_end(uint4 v, uint32_t cum, uint32_t pos,
                                         int lane, unsigned mask,
                                         int32_t* out, int col) {
  const int rem = (int)(pos & 127u);
  const uint32_t m0 = low_bits(rem);
  const uint32_t m1 = low_bits(rem - 32);
  const uint32_t m2 = low_bits(rem - 64);
  const uint32_t m3 = low_bits(rem - 96);
  const uint32_t c = cum + __popc(v.x & m0) + __popc(v.y & m1) +
                     __popc(v.z & m2) + __popc(v.w & m3);
  const uint32_t next = __shfl_down_sync(mask, c, 1, 8);
  if (lane >= 2 && lane != 5 && lane != 7) {
    const int r = lane == 6 ? 3 : lane - 2;
    out[r * kOutStride + col] = (int32_t)(lane == 6 ? pos - c : next - c);
    out[(r + 4) * kOutStride + col] = (int32_t)c;
  }
}

// The table that a query of the tile reads its rows from.
template <int kMode>
__device__ __forceinline__ const uint4* rows_of(const Args& a,
                                                const Shards<kMode>& tab,
                                                const int32_t* p) {
  if constexpr (kMode == kLeftChar) return tab.s[p[kShard]].rows;
  if constexpr (kMode == kExpandTables) return tab.rows[p[kShard]];
  return a.rows;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const Args a, const __grid_constant__ Shards<kMode> tab) {
  constexpr bool kTwo = kMode != kSingle;
  constexpr bool kPairs = kMode == kExpand || kMode == kExpandTables;
  __shared__ __align__(16) int32_t pw[kTile * kPairCols];
  __shared__ int s_base[kMode == kExpandTables ? kMaxShards : 1];
  __shared__ int32_t s_lo[8 * kOutStride];
  __shared__ __align__(16) int32_t s_hi[kTwo ? 8 * kOutStride : 1];

  const long long base = (long long)blockIdx.x * kTile;
  const int cnt = a.n - base < kTile ? (int)(a.n - base) : kTile;
  const int t = threadIdx.x;

  // ---- the tile's queries into shared memory, in pair-row layout -------
  if constexpr (kPairs) {
    const int32_t* src = a.pairs + base * kPairCols;   // 16-byte aligned
    const int words = cnt * kPairCols;
    const int vec = words >> 2;
    for (int i = t; i < vec; i += kThreads)
      reinterpret_cast<int4*>(pw)[i] =
          __ldg(reinterpret_cast<const int4*>(src) + i);
    for (int i = 4 * vec + t; i < words; i += kThreads) pw[i] = src[i];
    if constexpr (kMode == kExpandTables) {
      for (int k = t; k < tab.n; k += kThreads) s_base[k] = tab.base[k];
      __syncthreads();
      if (t < cnt) {                   // the last table whose base <= sid
        const int sid = pw[t * kPairCols + kShard];
        int lo = 0, hi = tab.n - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_base[mid] <= sid) lo = mid; else hi = mid - 1;
        }
        pw[t * kPairCols + kShard] = lo;
      }
    }
  } else if constexpr (kMode == kLeftChar) {
    // the tile's rows into s_hi (rewritten only after the barrier below)
    int32_t* raw = s_hi;
    const int32_t* src = a.orows + base * kOutCols;
    const int words = cnt * kOutCols;
    int done = 0;                        // words loaded 16 bytes at once
    if ((reinterpret_cast<uintptr_t>(a.orows) & 15) == 0) {
      const int vec = words >> 2;
      for (int i = t; i < vec; i += kThreads)
        reinterpret_cast<int4*>(raw)[i] =
            __ldg(reinterpret_cast<const int4*>(src) + i);
      done = 4 * vec;
    }
    for (int i = done + t; i < words; i += kThreads) raw[i] = src[i];
    __syncthreads();
    if (t < cnt) {
      const int32_t* r = raw + t * kOutCols;
      const uint32_t rlo = (uint32_t)r[kOcRlo];
      const long long sid = r[kOcSid];
      int lo = 0, hi = tab.n - 1;        // the last shard whose base <= sid
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tab.s[mid].base <= sid) lo = mid; else hi = mid - 1;
      }
      int32_t* p = pw + t * kPairCols;
      p[kLo] = (int32_t)rlo;
      p[kHi] = (int32_t)(rlo + (uint32_t)r[kOcFreq]);
      p[kSoff] = __ldg(tab.s[lo].soff + (sid - tab.s[lo].base));
      p[kShard] = lo;
    }
  } else if (t < cnt) {
    const long long q = base + t;
    pw[t * kPairCols + kLo] = a.lo[q * a.lo_stride];
    pw[t * kPairCols + kSoff] = a.soff[q * a.soff_stride];
  }
  __syncthreads();

  // ---- a group of 8 lanes a query: rows gathered whole -----------------
  const int lane = t & 7;
  const int g = t >> 3;
  const unsigned mask = 0xFFu << (t & 24);
#pragma unroll 1
  for (int i0 = g; i0 < cnt; i0 += 2 * kGroups) {
    // two queries of the group in flight: all their row loads first
    const int i1 = i0 + kGroups;
    const bool has1 = i1 < cnt;
    const int32_t* p0 = pw + i0 * kPairCols;
    const int32_t* p1 = pw + (has1 ? i1 : i0) * kPairCols;
    const uint4* rows0 = rows_of<kMode>(a, tab, p0);
    const uint4* rows1 = rows_of<kMode>(a, tab, p1);
    const uint32_t lo0 = (uint32_t)p0[kLo], lo1 = (uint32_t)p1[kLo];
    const long long b_lo0 = (long long)(lo0 >> 7) + p0[kSoff];
    const long long b_lo1 = (long long)(lo1 >> 7) + p1[kSoff];
    const uint4 v_lo0 = load_row(rows0, b_lo0, lane);
    const uint4 v_lo1 = has1 ? load_row(rows1, b_lo1, lane) : v_lo0;
    if constexpr (!kTwo) {
      rank_end(v_lo0, cum_word(v_lo0, lane, mask), lo0, lane, mask, s_lo, i0);
      if (has1)
        rank_end(v_lo1, cum_word(v_lo1, lane, mask), lo1, lane, mask, s_lo,
                 i1);
      continue;
    }
    const uint32_t hi0 = (uint32_t)p0[kHi], hi1 = (uint32_t)p1[kHi];
    const long long b_hi0 = (long long)(hi0 >> 7) + p0[kSoff];
    const long long b_hi1 = (long long)(hi1 >> 7) + p1[kSoff];
    // group-uniform: every lane of a group reads the same pair
    const bool same0 = b_hi0 == b_lo0, same1 = b_hi1 == b_lo1;
    const uint4 v_hi0 = same0 ? v_lo0 : load_row(rows0, b_hi0, lane);
    const uint4 v_hi1 = (same1 || !has1) ? v_lo1
                                         : load_row(rows1, b_hi1, lane);
    uint32_t cum = cum_word(v_lo0, lane, mask);
    rank_end(v_lo0, cum, lo0, lane, mask, s_lo, i0);
    if (!same0) cum = cum_word(v_hi0, lane, mask);
    rank_end(v_hi0, cum, hi0, lane, mask, s_hi, i0);
    if (has1) {
      cum = cum_word(v_lo1, lane, mask);
      rank_end(v_lo1, cum, lo1, lane, mask, s_lo, i1);
      if (!same1) cum = cum_word(v_hi1, lane, mask);
      rank_end(v_hi1, cum, hi1, lane, mask, s_hi, i1);
    }
  }
  __syncthreads();

  // ---- epilogue: a thread a query, every output row coalesced ----------
  if (t >= cnt) return;
  const long long q = base + t;
  const long long n = a.n;
  if constexpr (kMode == kLeftChar) {
    // the four right-extension counts at (rlo, rlo + freq): the first base
    // that every occurrence extends with, else N if any extends, else 0
    const int32_t freq =
        (int32_t)((uint32_t)pw[t * kPairCols + kHi] -
                  (uint32_t)pw[t * kPairCols + kLo]);
    int code = kLcZero;
    bool any = false;
#pragma unroll
    for (int c = 3; c >= 0; --c) {
      const int32_t cf = (int32_t)((uint32_t)s_hi[c * kOutStride + t] -
                                   (uint32_t)s_lo[c * kOutStride + t]);
      if (freq > 0 && cf == freq) code = c + 2;
      any |= cf > 0;
    }
    a.codes[q] = (int8_t)(code >= 2 ? code : (any ? kLcN : kLcZero));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) a.olo[k * n + q] = s_lo[k * kOutStride + t];
  }
  if constexpr (kPairs) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a.ohi[k * n + q] = s_hi[k * kOutStride + t];
    const int32_t lo = pw[t * kPairCols + kLo], hi = pw[t * kPairCols + kHi];
    const bool pa = hi > lo;
    a.freq[q] = pa ? (int32_t)((uint32_t)hi - (uint32_t)lo) : 0;
    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int32_t cf = (int32_t)((uint32_t)s_hi[c * kOutStride + t] -
                                   (uint32_t)s_lo[c * kOutStride + t]);
      const bool act = pa && cf >= a.fmin;
      a.keepc[c * n + q] = (uint8_t)(act && ((a.sym_mask >> c) & 1));
      bits |= (uint32_t)act << c;
    }
    a.cbits[q] = (uint8_t)bits;
  }
}

// ---- the per-level engines' dense expand (K12) --------------------------
//
// Replaces dsm_tpu/mining/engine.py expand_core + leftchar_codes (:263-333)
// as _level_step_impl (:382) and, under a vmap over the prefix rows,
// parallel/engine_sharded.py _sharded_step_impl (:125) run them: the dense
// frontier (R rows, CAP nodes, S samples) expanded in one launch.  A cell
// (r, u, s) is parent-active when hi > lo and row (r, u) is valid; then its
// forward ranks at lo and hi give the four children's bounds (C4 baked),
// their reverse starts rlo + psum_hi - psum_lo and their activity (width at
// least fmin), and every cell with hi > lo takes its leftChar code from the
// reverse ranks at rlo and rlo + (hi - lo).  A cell that is not active
// writes dsm_tpu's zeros, and one with hi == lo the code 0, without a
// gather (a level never holds lo > hi).  The per-node sums over the
// launch's samples are [active cells, active children under A, C, G, T].
// The tables are the launch's parameters: up to kMaxShards (forward rows,
// reverse rows, soff, first sample column), the columns ascending; a
// cell's table is the last whose first column is at or below its sample's.
//
// What bounds it on an H100: by count, bytes (the state in, 57 B a cell
// and 20 a node out); in practice the rank jobs wherever many cells are
// active (AC's one-row level, D512's widest): two 8-lane row gathers from
// the L2 a job and their popcounts, 20-30 SM clocks a job on an H100 as
// chip_smoke.level_variant_times measures it, cutting the kernel after
// each stage.  Empty rows cost their bytes.
//
// The first design took 256 consecutive CELLS a block and lost in three
// places.  Its stores: a cell wrote its four children at
// node * 4S + c * S + s, so at S = 5 one warp's store spanned six or seven
// nodes with gaps, and cact one byte at a time; the sums went through
// shared and then global atomics onto an array the entry zeroed with a
// memset.  Its empty tiles: a tile with no active cell still passed every
// barrier of both rank phases (three empty prefix rows cost 7x the one-row
// level's device time).  Its gathers: a group of 8 lanes ranked its cells
// one after another, one dependent row gather in flight, forward and
// reverse phases one after the other.
//
// The design, two kernels by S:
//   * S <= kCells, node-major tiles: a block takes kCells // S whole nodes,
//     a thread a cell.  A node's sums are complete inside its block: a
//     warp's cells add theirs in a segmented shuffle scan (a node's cells
//     are contiguous), one shared-memory atomic a node a warp, and each
//     sum is written once, with a plain store: no memset, no global
//     atomic.  The outputs are staged in shared memory in output order:
//     the tile's clo / chi / crlo / cact span (nodes x 4 x S) and its lc
//     span are contiguous in the output, each staged shifted by its
//     start's offset from a 16-byte boundary, so that the block's threads
//     store whole aligned 16-byte vectors of any of the five spans and
//     only their ragged ends go out as scalars; freq is stored coalesced
//     by the cell threads.  A tile without a cell to rank (no hi > lo)
//     learns it from one barrier, stores its zeros and freq straight to
//     the output and skips the rank phase: an empty prefix row or invalid
//     node costs its bytes.  The rank jobs are one list a tile, built with
//     warp-aggregated shared atomics: a forward job (lo, hi in the forward
//     table) for each active cell and a reverse job (rlo, rlo + freq in
//     the reverse table) for each cell with hi > lo.  A group of 8 lanes
//     takes every 32nd job and issues the next job's row loads before it
//     popcounts the current one (two jobs' gathers in flight), so forward
//     and reverse ends of different cells overlap; it keeps K1's 8-lane
//     row gather and uint32 arithmetic.  The lanes that hold child c's values write its clo,
//     chi, crlo and cact straight into the staged span; a reverse job's
//     code comes from two ballots of the group.
//   * S > kCells (D512): a block takes one node, and each warp chunks of
//     32 of its samples.  A chunk's child c is one contiguous run of the
//     output, so each lane stores its own cell's outputs, coalesced,
//     without staging the span; the warp ranks its chunk's jobs by its
//     four groups (cells handed over by shuffles, a round of four jobs
//     ranked while the next round's rows load), loads its next chunk's
//     cells meanwhile, and the warps run apart: one barrier, before the
//     node's five sums.  The rank jobs bound it there, as they bound the
//     first design: the node in passes of 256 samples through the staged
//     tile measured no faster.
//   A cell's table is bisected in the launch's parameters, so its soff
//   load issues with the cell's own loads.

constexpr int kCells = 256;        // a node tile's cells: one a thread
static_assert(kCells == kThreads, "one thread a cell when staging");
constexpr int kWarps = kThreads / 32;
constexpr int kExpandBlocks = 4;   // blocks an SM the registers allow
constexpr int kWideBlocks = 4;     // the same for the S > kCells kernel
constexpr int kSpanI = 4 * kCells + 4;   // a tile's span + its phase
constexpr int kSpanB = 4 * kCells + 16;
constexpr int kSumFields = 5;      // active cells, then A C G T children
constexpr int kFieldBits = 6;      // a warp's count of one field (<= 32)
constexpr int kRevJob = 0x100;     // a job's cell, and this bit: reverse

struct LevelTables {
  int n;
  int base[kMaxShards];
  const uint4* frows[kMaxShards];
  const uint4* rrows[kMaxShards];
  const int32_t* soff[kMaxShards];
};

struct LevelArgs {
  const int32_t* lo;                     // (R, CAP, S)
  const int32_t* hi;
  const int32_t* rlo;
  const uint8_t* valid;                  // (R, CAP)
  long long nodes;                       // R * CAP
  int S, fmin;
  int npb;                               // nodes a block (S <= kCells)
  int32_t* clo;                          // (R, CAP, 4, S), 16-byte aligned
  int32_t* chi;
  int32_t* crlo;
  uint8_t* cact;                         // (R, CAP, 4, S) bool
  int32_t* freq;                         // (R, CAP, S)
  int8_t* lc;                            // (R, CAP, S), 16-byte aligned
  int32_t* sums;                         // (R, CAP, 5)
};

// A cell's inputs: its interval, reverse start, valid node, table and
// soff entry.  The table (the last whose first column is at or below s) is
// bisected in the launch's parameters, so that the soff load issues with
// the cell's own loads.
struct Cell {
  int32_t lo, hi, rlo, soff;
  int l;
  bool valid;
};

__device__ __forceinline__ Cell load_cell(const LevelArgs& a,
                                          const LevelTables& tab,
                                          long long q, long long node,
                                          int s) {
  Cell c;
  int l = 0, h = tab.n - 1;
  while (l < h) {
    const int mid = (l + h + 1) >> 1;
    if (tab.base[mid] <= s) l = mid; else h = mid - 1;
  }
  c.l = l;
  c.lo = a.lo[q];
  c.hi = a.hi[q];
  c.rlo = a.rlo[q];
  c.valid = a.valid[node] != 0;
  c.soff = __ldg(tab.soff[l] + (s - tab.base[l]));
  return c;
}

// One interval end's values in plane lane 2 + j (K1's rank_end, kept in
// registers): for the lanes of child c (2, 3, 4, 6 -> c = 0..3) `a` is
// output row c ([c1-c0, c2-c1, c3-c2, pos-c4]) and `b` row c + 4 (the
// psum c_c).
__device__ __forceinline__ void end_values(uint4 v, uint32_t cum,
                                           uint32_t pos, int lane,
                                           unsigned mask, uint32_t& a,
                                           uint32_t& b) {
  const int rem = (int)(pos & 127u);
  const uint32_t c = cum + __popc(v.x & low_bits(rem)) +
                     __popc(v.y & low_bits(rem - 32)) +
                     __popc(v.z & low_bits(rem - 64)) +
                     __popc(v.w & low_bits(rem - 96));
  const uint32_t next = __shfl_down_sync(mask, c, 1, 8);
  a = lane == 6 ? pos - c : next - c;
  b = c;
}

// A rank job: its two ends and their rows' numbers in `rows`.
struct Job {
  const uint4* rows;
  uint32_t pa, pb;
  long long ba, bb;
};

__device__ __forceinline__ Job make_job(const LevelTables& tab, bool rev,
                                        int32_t lo, int32_t hi, int32_t rlo,
                                        int32_t soff, int l) {
  Job jo;
  jo.pa = rev ? (uint32_t)rlo : (uint32_t)lo;
  jo.pb = rev ? (uint32_t)rlo + ((uint32_t)hi - (uint32_t)lo) : (uint32_t)hi;
  jo.rows = rev ? tab.rrows[l] : tab.frows[l];
  jo.ba = (long long)(jo.pa >> 7) + soff;
  jo.bb = (long long)(jo.pb >> 7) + soff;
  return jo;
}

// A job with its cell, its reverse start and its two ends' rows as loaded
// (vb unused where both ends share a row).
struct Fetched {
  Job jo;
  uint4 va, vb;
  int i;
  int32_t rlo;
  bool rev;
};

__device__ __forceinline__ void load_rows(Fetched& f, int gl) {
  f.va = load_row(f.jo.rows, f.jo.ba, gl);
  if (f.jo.bb != f.jo.ba) f.vb = load_row(f.jo.rows, f.jo.bb, gl);
}

// Both ends of a fetched job ranked by its group of 8 lanes: for the child
// lanes, `a0`/`a1` rows c of the two ends and `c0`/`c1` rows c + 4.
__device__ __forceinline__ void rank_job(const Fetched& f, int gl,
                                         unsigned gmask, uint32_t& a0,
                                         uint32_t& c0, uint32_t& a1,
                                         uint32_t& c1) {
  const bool same = f.jo.bb == f.jo.ba;
  uint32_t cum = cum_word(f.va, gl, gmask);
  end_values(f.va, cum, f.jo.pa, gl, gmask, a0, c0);
  if (!same) cum = cum_word(f.vb, gl, gmask);
  end_values(same ? f.va : f.vb, cum, f.jo.pb, gl, gmask, a1, c1);
}

// A reverse job's leftChar code from its child lanes' counts: the first
// base that every occurrence extends with, else N if any extends, else 0.
// All 8 lanes of the group call it; lane 0's result is the code.
__device__ __forceinline__ int lc_code(uint32_t a0, uint32_t a1,
                                       const Job& jo, bool child_lane,
                                       unsigned gmask) {
  const int32_t cf = (int32_t)(a1 - a0);
  const int32_t fr = (int32_t)(jo.pb - jo.pa);
  const unsigned eq = __ballot_sync(gmask, child_lane && cf == fr) & gmask;
  const unsigned any = __ballot_sync(gmask, child_lane && cf > 0) & gmask;
  const unsigned e = (eq >> (threadIdx.x & 24)) & 0x5Cu;   // lanes 2,3,4,6
  if (e) {
    const int L = __ffs(e) - 1;
    return (L == 6 ? 3 : L - 2) + 2;
  }
  return any ? kLcN : kLcZero;
}

// Vector i of a staged run: elements k of run[phase + k] (the run 16-byte
// aligned) to dst[k], k < n, where dst - phase is 16-byte aligned; whole
// 16-byte vectors, scalars at the run's two ragged ends.  A null run
// stores zeros.
template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const T* run, int phase,
                                          int n, int i) {
  constexpr int V = 16 / sizeof(T);
  const int end = phase + n, k0 = i * V;
  if (k0 >= end) return;
  T* base = dst - phase;
  if (k0 >= phase && k0 + V <= end) {
    reinterpret_cast<uint4*>(base)[i] =
        run ? reinterpret_cast<const uint4*>(run)[i] : make_uint4(0, 0, 0, 0);
  } else {
    const int k1 = k0 + V < end ? k0 + V : end;
    for (int k = k0 > phase ? k0 : phase; k < k1; ++k)
      base[k] = run ? run[k] : T(0);
  }
}

// A node tile's outputs: its clo, chi, crlo and cact span and its lc span,
// from their staged copies or (staged false) zeros; every thread of the
// block takes vectors of any of the five.
__device__ __forceinline__ void store_tile(
    const LevelArgs& a, bool staged, long long out0, long long cell0,
    int cnt, const int32_t* s_clo, const int32_t* s_chi,
    const int32_t* s_crlo, const uint8_t* s_cact, const int8_t* s_lc) {
  const int span = 4 * cnt;
  const int nvi = (span + 6) >> 2;       // the span's int vectors, at most
  const int nvb = (span + 30) >> 4;      // and its byte vectors
  const int nvl = (cnt + 30) >> 4;
  const int phi = (int)(out0 & 3), phb = (int)(out0 & 15);
  for (int v = threadIdx.x; v < 3 * nvi + nvb + nvl; v += kThreads) {
    if (v < 3 * nvi) {
      const int arr = v / nvi;
      int32_t* dst = (arr == 0 ? a.clo : arr == 1 ? a.chi : a.crlo) + out0;
      const int32_t* run =
          staged ? (arr == 0 ? s_clo : arr == 1 ? s_chi : s_crlo) : nullptr;
      store_vec<int32_t>(dst, run, phi, span, v - arr * nvi);
    } else if (v < 3 * nvi + nvb) {
      store_vec<uint8_t>(a.cact + out0, staged ? s_cact : nullptr, phb, span,
                         v - 3 * nvi);
    } else {
      store_vec<int8_t>(a.lc + cell0, staged ? s_lc : nullptr,
                        (int)(cell0 & 15), cnt, v - 3 * nvi - nvb);
    }
  }
}

// S <= kCells: a block takes kCells // S whole nodes, a thread a cell.
__global__ void __launch_bounds__(kThreads, kExpandBlocks)
    level_expand_kernel(const LevelArgs a,
                        const __grid_constant__ LevelTables tab) {
  __shared__ __align__(16) int32_t s_clo[kSpanI];
  __shared__ __align__(16) int32_t s_chi[kSpanI];
  __shared__ __align__(16) int32_t s_crlo[kSpanI];
  __shared__ __align__(16) uint8_t s_cact[kSpanB];
  __shared__ __align__(16) int8_t s_lc[kCells + 16];
  __shared__ int32_t s_lo[kCells], s_hi[kCells], s_rlo[kCells];
  __shared__ int32_t s_soff[kCells];
  __shared__ int16_t s_l0[kCells];       // a cell's child-0 slot in the span
  __shared__ uint8_t s_tab[kCells];
  __shared__ uint16_t s_jobs[2 * kCells];
  __shared__ int s_sum[kCells * kSumFields];
  __shared__ int s_njobs;

  const int t = threadIdx.x;
  const int S = a.S;
  const long long node0 = (long long)blockIdx.x * a.npb;
  const int nn = a.nodes - node0 < a.npb ? (int)(a.nodes - node0) : a.npb;
  const int cnt = nn * S;
  const long long cell0 = node0 * S;           // freq / lc of cell 0
  const long long out0 = node0 * 4 * S;        // child 0 of cell 0
  for (int k = t; k < nn * kSumFields; k += kThreads) s_sum[k] = 0;
  if (t == 0) s_njobs = 0;

  int j = -1, l0 = 0;                          // the cell's node, its slot
  Cell cell{};
  bool pa = false, need = false;
  if (t < cnt) {
    j = t / S;
    const int s = t - j * S;
    l0 = j * 4 * S + s;
    cell = load_cell(a, tab, cell0 + t, node0 + j, s);
    need = cell.hi > cell.lo;
    pa = need && cell.valid;
    a.freq[cell0 + t] = (int32_t)((uint32_t)cell.hi - (uint32_t)cell.lo);
  }
  if (!__syncthreads_or(need)) {
    // nothing to rank: the zeros straight to the output
    store_tile(a, false, out0, cell0, cnt, s_clo, s_chi, s_crlo, s_cact,
               s_lc);
    for (int k = t; k < nn * kSumFields; k += kThreads)
      a.sums[node0 * kSumFields + k] = 0;
    return;
  }
  // child c of cell i is staged at s_l0[i] + phi + c * S (ints) and
  // s_l0[i] + phb + c * S (bytes), a cell's code at phl + i
  const int phi = (int)(out0 & 3), phb = (int)(out0 & 15);
  const int phl = (int)(cell0 & 15);

  // ---- stage the cells and list the rank jobs ---------------------------
  if (t < cnt) {
    s_lo[t] = cell.lo;
    s_hi[t] = cell.hi;
    s_rlo[t] = cell.rlo;
    s_l0[t] = (int16_t)l0;
    s_tab[t] = (uint8_t)cell.l;
    s_soff[t] = cell.soff;
    if (!pa) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_clo[l0 + phi + c * S] = 0;
        s_chi[l0 + phi + c * S] = 0;
        s_crlo[l0 + phi + c * S] = 0;
        s_cact[l0 + phb + c * S] = 0;
      }
    }
    if (!need) s_lc[phl + t] = 0;
  }
  {
    const int wl = t & 31;
    const unsigned mf = __ballot_sync(0xFFFFFFFFu, pa);
    const unsigned mr = __ballot_sync(0xFFFFFFFFu, need);
    int first = 0;
    if (wl == 0 && (mf | mr))
      first = atomicAdd(&s_njobs, __popc(mf) + __popc(mr));
    first = __shfl_sync(0xFFFFFFFFu, first, 0);
    const unsigned below = (1u << wl) - 1;
    if (pa) s_jobs[first + __popc(mf & below)] = (uint16_t)t;
    if (need)
      s_jobs[first + __popc(mf) + __popc(mr & below)] =
          (uint16_t)(t | kRevJob);
  }
  __syncthreads();

  // ---- the rank jobs: a group of 8 lanes a job, the next job's rows
  // loading while the current one is ranked ------------------------------
  const int gl = t & 7;
  const unsigned gmask = 0xFFu << (t & 24);
  const bool child_lane = gl >= 2 && gl != 5 && gl != 7;
  const int my_c = gl == 6 ? 3 : gl - 2;
  const int J = s_njobs;
  auto fetch = [&](int jb) -> Fetched {
    Fetched f{};
    if (jb < J) {                          // group-uniform
      const int job = s_jobs[jb];
      f.i = job & (kRevJob - 1);
      f.rev = (job & kRevJob) != 0;
      f.rlo = s_rlo[f.i];
      f.jo = make_job(tab, f.rev, s_lo[f.i], s_hi[f.i], f.rlo, s_soff[f.i],
                      s_tab[f.i]);
      load_rows(f, gl);
    }
    return f;
  };
  Fetched cur = fetch(t >> 3);
#pragma unroll 1
  for (int jb = t >> 3; jb < J; jb += kGroups) {
    const Fetched nxt = fetch(jb + kGroups);
    uint32_t a0, c0, a1, c1;
    rank_job(cur, gl, gmask, a0, c0, a1, c1);
    if (!cur.rev) {
      if (child_lane) {
        const int li = s_l0[cur.i] + my_c * S;
        s_clo[li + phi] = (int32_t)a0;
        s_chi[li + phi] = (int32_t)a1;
        s_crlo[li + phi] = (int32_t)((uint32_t)cur.rlo + c1 - c0);
        s_cact[li + phb] = (int32_t)(a1 - a0) >= a.fmin;
      }
    } else {
      const int code = lc_code(a0, a1, cur.jo, child_lane, gmask);
      if (gl == 0) s_lc[phl + cur.i] = (int8_t)code;
    }
    cur = nxt;
  }
  __syncthreads();

  // ---- the nodes' sums: a warp's segments, one atomic a node ------------
  {
    const int wl = t & 31;
    uint32_t v = 0;
    if (pa) {
      v = 1u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v += (uint32_t)s_cact[l0 + phb + c * S] << (kFieldBits * (c + 1));
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, v, o);
      const int k = __shfl_up_sync(0xFFFFFFFFu, j, o);
      if (wl >= o && k == j) v += u;
    }
    const int next = __shfl_down_sync(0xFFFFFFFFu, j, 1);
    if (j >= 0 && (wl == 31 || next != j) && v) {
#pragma unroll
      for (int f = 0; f < kSumFields; ++f) {
        const int x =
            (int)((v >> (kFieldBits * f)) & ((1u << kFieldBits) - 1));
        if (x) atomicAdd(s_sum + j * kSumFields + f, x);
      }
    }
  }

  // ---- the staged spans out, 16 bytes a store ---------------------------
  store_tile(a, true, out0, cell0, cnt, s_clo, s_chi, s_crlo, s_cact, s_lc);
  __syncthreads();
  for (int k = t; k < nn * kSumFields; k += kThreads)
    a.sums[node0 * kSumFields + k] = s_sum[k];
}

// S > kCells: a block takes one node, its warps chunks of 32 samples.
// Each warp ranks its chunk's jobs by its four groups and stores its cells'
// outputs itself: for a chunk, child c's 32 cells are one contiguous run of
// the output, so a lane's stores are coalesced without a block barrier,
// and the warps run apart (one barrier before the node's sums).
__global__ void __launch_bounds__(kThreads, kWideBlocks)
    level_expand_wide_kernel(const LevelArgs a,
                             const __grid_constant__ LevelTables tab) {
  __shared__ int32_t w_clo[kWarps][4][32];
  __shared__ int32_t w_chi[kWarps][4][32];
  __shared__ int32_t w_crlo[kWarps][4][32];
  __shared__ uint8_t w_cact[kWarps][4][32];
  __shared__ int8_t w_lc[kWarps][32];
  __shared__ int s_sum[kSumFields];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int S = a.S;
  const long long node = blockIdx.x;
  if (t < kSumFields) s_sum[t] = 0;
  __syncthreads();

  const int gl = lane & 7, g = lane >> 3;
  const unsigned gmask = 0xFFu << (lane & 24);
  const bool child_lane = gl >= 2 && gl != 5 && gl != 7;
  const int my_c = gl == 6 ? 3 : gl - 2;
  const int nchunks = (S + 31) / 32;
  uint32_t sums[kSumFields] = {0, 0, 0, 0, 0};   // lane 0's, of this warp

  auto load = [&](int k) -> Cell {
    const int s = k * 32 + lane;
    return s < S ? load_cell(a, tab, node * S + s, node, s) : Cell{};
  };
  Cell cell = warp < nchunks ? load(warp) : Cell{}, nxt{};
  for (int k = warp; k < nchunks; k += kWarps, cell = nxt) {
    // the next chunk's cells load while this one runs
    nxt = k + kWarps < nchunks ? load(k + kWarps) : Cell{};
    const int s = k * 32 + lane;
    const long long q = node * S + s;
    const bool in = s < S;
    const bool need = in && cell.hi > cell.lo;
    const bool pa = need && cell.valid;
    if (in) a.freq[q] = (int32_t)((uint32_t)cell.hi - (uint32_t)cell.lo);
    const unsigned mf = __ballot_sync(0xFFFFFFFFu, pa);
    const unsigned mr = __ballot_sync(0xFFFFFFFFu, need);
    const int nf = __popc(mf), J = nf + __popc(mr);
    // jobs: the forward ones (cells of mf) then the reverse ones (of mr),
    // a round of four, one a group; the next round's rows load while this
    // one is ranked.  Every lane calls fetch (its shuffles).
    auto fetch = [&](int jb) -> Fetched {
      Fetched f{};
      f.rev = jb >= nf;
      f.i = jb < J ? (int)__fns(f.rev ? mr : mf, 0,
                                (f.rev ? jb - nf : jb) + 1)
                   : 0;
      const int32_t lo = __shfl_sync(0xFFFFFFFFu, cell.lo, f.i);
      const int32_t hi = __shfl_sync(0xFFFFFFFFu, cell.hi, f.i);
      f.rlo = __shfl_sync(0xFFFFFFFFu, cell.rlo, f.i);
      const int32_t soff = __shfl_sync(0xFFFFFFFFu, cell.soff, f.i);
      const int l = __shfl_sync(0xFFFFFFFFu, cell.l, f.i);
      if (jb < J) {                          // group-uniform
        f.jo = make_job(tab, f.rev, lo, hi, f.rlo, soff, l);
        load_rows(f, gl);
      }
      return f;
    };
    Fetched cur = fetch(g);
#pragma unroll 1
    for (int r0 = 0; r0 < J; r0 += 4) {      // warp-uniform
      const Fetched nxt = fetch(r0 + 4 + g);
      if (r0 + g < J) {                      // group-uniform
        uint32_t a0, c0, a1, c1;
        rank_job(cur, gl, gmask, a0, c0, a1, c1);
        if (!cur.rev) {
          if (child_lane) {
            w_clo[warp][my_c][cur.i] = (int32_t)a0;
            w_chi[warp][my_c][cur.i] = (int32_t)a1;
            w_crlo[warp][my_c][cur.i] =
                (int32_t)((uint32_t)cur.rlo + c1 - c0);
            w_cact[warp][my_c][cur.i] = (int32_t)(a1 - a0) >= a.fmin;
          }
        } else {
          const int code = lc_code(a0, a1, cur.jo, child_lane, gmask);
          if (gl == 0) w_lc[warp][cur.i] = (int8_t)code;
        }
      }
      cur = nxt;
    }
    __syncwarp();
    // this lane's cell out: its four children (child c's 32 cells one
    // contiguous run), freq above, lc
    const long long o = node * 4 * S + s;    // child 0
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool act = pa && w_cact[warp][c][lane];
      if (in) {
        a.clo[o + (long long)c * S] = pa ? w_clo[warp][c][lane] : 0;
        a.chi[o + (long long)c * S] = pa ? w_chi[warp][c][lane] : 0;
        a.crlo[o + (long long)c * S] = pa ? w_crlo[warp][c][lane] : 0;
        a.cact[o + (long long)c * S] = act;
      }
      const unsigned m = __ballot_sync(0xFFFFFFFFu, act);
      if (lane == 0) sums[1 + c] += __popc(m);
    }
    if (in) a.lc[q] = need ? w_lc[warp][lane] : (int8_t)kLcZero;
    if (lane == 0) sums[0] += __popc(mf);
    __syncwarp();
  }
  if (lane == 0)
#pragma unroll
    for (int f = 0; f < kSumFields; ++f)
      if (sums[f]) atomicAdd(s_sum + f, (int)sums[f]);
  __syncthreads();
  if (t < kSumFields) a.sums[node * kSumFields + t] = s_sum[t];
}

template <int kMode>
int launch(const Args& a, const Shards<kMode>& tab, void* stream) {
  const long long blocks = (a.n + kTile - 1) / kTile;
  rank_kernel<kMode><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, tab);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch(const Args& a, void* stream) {
  return launch<kMode>(a, Shards<kMode>{0}, stream);
}

}  // namespace

// rows (R, 32) int32; pos, soff (q,) int32 at any stride; out (8, q).
extern "C" int dsm_occ_cum8(const void* rows, const void* pos,
                            long long pos_stride, const void* soff,
                            long long soff_stride, void* out,
                            long long q_total, void* stream) {
  Args a{};
  a.rows = (const uint4*)rows;
  a.lo = (const int32_t*)pos;
  a.lo_stride = pos_stride;
  a.soff = (const int32_t*)soff;
  a.soff_stride = soff_stride;
  a.olo = (int32_t*)out;
  a.n = q_total;
  return launch<kSingle>(a, stream);
}

// The expand step: pairs (p, 6) int32 contiguous and 16-byte aligned;
// olo, ohi (8, p) int32, freq (p,) int32, keepc (4, p) bool, cbits (p,)
// uint8.
extern "C" int dsm_expand(const void* rows, const void* pairs, void* olo,
                          void* ohi, void* freq, void* keepc, void* cbits,
                          long long p, int fmin, int sym_mask, void* stream) {
  Args a{};
  a.rows = (const uint4*)rows;
  a.pairs = (const int32_t*)pairs;
  a.olo = (int32_t*)olo;
  a.ohi = (int32_t*)ohi;
  a.freq = (int32_t*)freq;
  a.keepc = (uint8_t*)keepc;
  a.cbits = (uint8_t*)cbits;
  a.n = p;
  a.fmin = fmin;
  a.sym_mask = sym_mask;
  return launch<kExpand>(a, stream);
}

// The expand step over a process's shard tables: pairs, outputs, p, fmin
// and sym_mask as in dsm_expand, each pair's PC_SOFF an offset into its own
// table; tables: ntables x (forward rows pointer, first process-local
// sample id) int64 in HOST memory, copied into the launch's parameters, the
// ids ascending, every pair's PC_SID at or above the first.
// 1 <= ntables <= kMaxShards.
extern "C" int dsm_expand_tables(const void* tables, int ntables,
                                 const void* pairs, void* olo, void* ohi,
                                 void* freq, void* keepc, void* cbits,
                                 long long p, int fmin, int sym_mask,
                                 void* stream) {
  if (ntables < 1 || ntables > kMaxShards) return (int)cudaErrorInvalidValue;
  Shards<kExpandTables> tab;
  tab.n = ntables;
  const long long* h = (const long long*)tables;
  for (int k = 0; k < ntables; ++k) {
    tab.rows[k] = (const uint4*)h[2 * k];
    tab.base[k] = (int)h[2 * k + 1];
  }
  Args a{};
  a.pairs = (const int32_t*)pairs;
  a.olo = (int32_t*)olo;
  a.ohi = (int32_t*)ohi;
  a.freq = (int32_t*)freq;
  a.keepc = (uint8_t*)keepc;
  a.cbits = (uint8_t*)cbits;
  a.n = p;
  a.fmin = fmin;
  a.sym_mask = sym_mask;
  return launch<kExpandTables>(a, tab, stream);
}

// leftChar codes of the staged output rows: orows (n, 5) int32 contiguous
// (16-byte aligned for the vector loads; any 4-byte alignment works);
// shards: nshards x (reverse rows pointer, soff pointer, first global
// sample id) int64 in HOST memory, copied into the launch's parameters,
// the ids ascending, every row's OC_SID at or above the first; codes (n,)
// int8.  1 <= nshards <= kMaxShards.
extern "C" int dsm_leftchar(const void* orows, long long n, const void* shards,
                            int nshards, void* codes, void* stream) {
  if (nshards < 1 || nshards > kMaxShards) return (int)cudaErrorInvalidValue;
  Shards<kLeftChar> tab;
  tab.n = nshards;
  const long long* h = (const long long*)shards;
  for (int k = 0; k < nshards; ++k)
    tab.s[k] = LcShard{(const uint4*)h[3 * k], (const int32_t*)h[3 * k + 1],
                       h[3 * k + 2]};
  Args a{};
  a.orows = (const int32_t*)orows;
  a.codes = (int8_t*)codes;
  a.n = n;
  return launch<kLeftChar>(a, tab, stream);
}

// The per-level engines' dense expand (K12): lo, hi, rlo (R, CAP, S) int32
// contiguous, valid (R, CAP) bool; nodes = R * CAP; tables: ntables x
// (forward rows, reverse rows, soff, first sample column) int64 in HOST
// memory, copied into the launch's parameters, the columns ascending from
// 0; outputs clo, chi, crlo (R, CAP, 4, S) int32, cact (R, CAP, 4, S)
// bool, freq (R, CAP, S) int32, lc (R, CAP, S) int8, sums (R, CAP, 5)
// int32, every element written by the kernel (no memset); clo, chi, crlo,
// cact and lc 16-byte aligned.  1 <= ntables <= kMaxShards.
extern "C" int dsm_level_expand(const void* tables, int ntables,
                                const void* lo, const void* hi,
                                const void* rlo, const void* valid,
                                long long nodes, int S, int fmin, void* clo,
                                void* chi, void* crlo, void* cact, void* freq,
                                void* lc, void* sums, void* stream) {
  if (ntables < 1 || ntables > kMaxShards || S < 0)
    return (int)cudaErrorInvalidValue;
  const void* staged[] = {clo, chi, crlo, cact, lc};
  for (const void* p : staged)
    if (reinterpret_cast<uintptr_t>(p) & 15)
      return (int)cudaErrorMisalignedAddress;
  if (nodes <= 0) return 0;
  LevelTables tab;
  tab.n = ntables;
  const long long* h = (const long long*)tables;
  for (int k = 0; k < ntables; ++k) {
    tab.frows[k] = (const uint4*)h[4 * k];
    tab.rrows[k] = (const uint4*)h[4 * k + 1];
    tab.soff[k] = (const int32_t*)h[4 * k + 2];
    tab.base[k] = (int)h[4 * k + 3];
  }
  LevelArgs a{};
  a.lo = (const int32_t*)lo;
  a.hi = (const int32_t*)hi;
  a.rlo = (const int32_t*)rlo;
  a.valid = (const uint8_t*)valid;
  a.nodes = nodes;
  a.S = S;
  a.fmin = fmin;
  // whole nodes a block, or one node a block in chunks of 32 samples
  a.npb = S > kCells ? 1 : (S > 0 ? kCells / S : kCells);
  a.clo = (int32_t*)clo;
  a.chi = (int32_t*)chi;
  a.crlo = (int32_t*)crlo;
  a.cact = (uint8_t*)cact;
  a.freq = (int32_t*)freq;
  a.lc = (int8_t*)lc;
  a.sums = (int32_t*)sums;
  const long long blocks = (nodes + a.npb - 1) / a.npb;
  if (S > kCells)
    level_expand_wide_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(a, tab);
  else
    level_expand_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(a, tab);
  return (int)cudaGetLastError();
}
