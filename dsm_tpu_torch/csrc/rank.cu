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
// launch's samples, [active cells, active children under A, C, G, T], are
// added in shared memory a tile and then to the (R, CAP, 5) output with one
// atomic a node and column that is not zero (the entry zeroes it first).
//
// A block takes 256 consecutive cells; the cells are staged in pair-row
// layout (lo, hi, rlo, table, soff, flags) and ranked by the groups of 8
// lanes above, first both forward ends of the active cells, then both
// reverse ends of the cells with hi > lo.  The tables are the launch's
// parameters: up to kMaxShards (forward rows, reverse rows, soff, first
// sample column), the columns ascending; a cell's table is the last whose
// first column is at or below its sample's.

constexpr int kRlo = 2, kFlags = 5;     // the staged cell's other columns
constexpr int kActive = 1, kLcNeed = 2;  // kFlags bits

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
  int32_t* clo;                          // (R, CAP, 4, S)
  int32_t* chi;
  int32_t* crlo;
  uint8_t* cact;                         // (R, CAP, 4, S) bool
  int32_t* freq;                         // (R, CAP, S)
  int8_t* lc;                            // (R, CAP, S)
  int32_t* sums;                         // (R, CAP, 5)
};

// Both ends (pw[i]'s kLo and kHi) of staged cell i ranked in `rows` by the
// group of 8 lanes: rows 0..7 of column i of s_lo and s_hi.
__device__ __forceinline__ void rank_both(const uint4* rows, const int32_t* p,
                                          int lane, unsigned mask,
                                          int32_t* s_lo, int32_t* s_hi,
                                          int i) {
  const uint32_t lo = (uint32_t)p[kLo], hi = (uint32_t)p[kHi];
  const long long b_lo = (long long)(lo >> 7) + p[kSoff];
  const long long b_hi = (long long)(hi >> 7) + p[kSoff];
  const uint4 v_lo = load_row(rows, b_lo, lane);
  const bool same = b_hi == b_lo;
  const uint4 v_hi = same ? v_lo : load_row(rows, b_hi, lane);
  uint32_t cum = cum_word(v_lo, lane, mask);
  rank_end(v_lo, cum, lo, lane, mask, s_lo, i);
  if (!same) cum = cum_word(v_hi, lane, mask);
  rank_end(v_hi, cum, hi, lane, mask, s_hi, i);
}

__global__ void __launch_bounds__(kThreads)
    level_expand_kernel(const LevelArgs a,
                        const __grid_constant__ LevelTables tab) {
  __shared__ __align__(16) int32_t pw[kTile * kPairCols];
  __shared__ int32_t s_lo[8 * kOutStride];
  __shared__ int32_t s_hi[8 * kOutStride];
  __shared__ int s_base[kMaxShards];
  __shared__ int s_sum[kTile * 5];       // a tile's nodes' sums

  const long long cells = a.nodes * a.S;
  const long long base = (long long)blockIdx.x * kTile;
  const int cnt = cells - base < kTile ? (int)(cells - base) : kTile;
  const int t = threadIdx.x;
  const long long node0 = base / a.S;
  for (int k = t; k < tab.n; k += kThreads) s_base[k] = tab.base[k];
  for (int k = t; k < kTile * 5; k += kThreads) s_sum[k] = 0;
  __syncthreads();

  // ---- stage the tile's cells ------------------------------------------
  long long q = 0, node = 0;
  int s = 0;
  int32_t lo = 0, hi = 0, rlo = 0;
  bool pa = false;
  if (t < cnt) {
    q = base + t;
    node = q / a.S;
    s = (int)(q - node * a.S);
    lo = a.lo[q];
    hi = a.hi[q];
    rlo = a.rlo[q];
    pa = hi > lo && a.valid[node];
    int l = 0, h = tab.n - 1;            // the last table whose base <= s
    while (l < h) {
      const int mid = (l + h + 1) >> 1;
      if (s_base[mid] <= s) l = mid; else h = mid - 1;
    }
    int32_t* p = pw + t * kPairCols;
    p[kLo] = lo;
    p[kHi] = hi;
    p[kShard] = l;
    p[kSoff] = __ldg(tab.soff[l] + (s - s_base[l]));
    p[kFlags] = (pa ? kActive : 0) | (hi > lo ? kLcNeed : 0);
  }
  __syncthreads();

  const int lane = t & 7;
  const int g = t >> 3;
  const unsigned mask = 0xFFu << (t & 24);
  // ---- forward ranks of the active cells ---------------------------------
#pragma unroll 1
  for (int i = g; i < cnt; i += kGroups) {
    const int32_t* p = pw + i * kPairCols;
    if (p[kFlags] & kActive)
      rank_both(tab.frows[p[kShard]], p, lane, mask, s_lo, s_hi, i);
  }
  __syncthreads();

  const int32_t freq = (int32_t)((uint32_t)hi - (uint32_t)lo);
  const int ln = (int)(node - node0);
  if (t < cnt) {
    a.freq[q] = freq;
    const long long out0 = node * 4 * a.S + s;   // (node, child 0, s)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int32_t clo = 0, chi = 0, crlo = 0;
      bool act = false;
      if (pa) {
        clo = s_lo[c * kOutStride + t];
        chi = s_hi[c * kOutStride + t];
        crlo = (int32_t)((uint32_t)rlo +
                         (uint32_t)s_hi[(4 + c) * kOutStride + t] -
                         (uint32_t)s_lo[(4 + c) * kOutStride + t]);
        act = chi - clo >= a.fmin;
      }
      const long long o = out0 + (long long)c * a.S;
      a.clo[o] = clo;
      a.chi[o] = chi;
      a.crlo[o] = crlo;
      a.cact[o] = act;
      if (act) atomicAdd(s_sum + ln * 5 + 1 + c, 1);
    }
    if (pa) atomicAdd(s_sum + ln * 5, 1);
    // the reverse ends of this cell: rlo and rlo + freq
    pw[t * kPairCols + kLo] = rlo;
    pw[t * kPairCols + kHi] = (int32_t)((uint32_t)rlo + (uint32_t)freq);
  }
  __syncthreads();

  // ---- reverse ranks of the cells with hi > lo: the leftChar codes ------
#pragma unroll 1
  for (int i = g; i < cnt; i += kGroups) {
    const int32_t* p = pw + i * kPairCols;
    if (p[kFlags] & kLcNeed)
      rank_both(tab.rrows[p[kShard]], p, lane, mask, s_lo, s_hi, i);
  }
  __syncthreads();
  if (t < cnt) {
    int code = kLcZero;
    if (hi > lo) {
      bool any = false;
#pragma unroll
      for (int c = 3; c >= 0; --c) {
        const int32_t cf = (int32_t)((uint32_t)s_hi[c * kOutStride + t] -
                                     (uint32_t)s_lo[c * kOutStride + t]);
        if (cf == freq) code = c + 2;
        any |= cf > 0;
      }
      if (code < 2) code = any ? kLcN : kLcZero;
    }
    a.lc[q] = (int8_t)code;
  }

  // ---- the tile's node sums into the output ------------------------------
  const int nn = cnt > 0 ? (int)((base + cnt - 1) / a.S - node0) + 1 : 0;
  for (int k = t; k < nn * 5; k += kThreads) {
    const int v = s_sum[k];
    if (v) atomicAdd(a.sums + node0 * 5 + k, v);
  }
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
// int32 (zeroed here).  1 <= ntables <= kMaxShards.
extern "C" int dsm_level_expand(const void* tables, int ntables,
                                const void* lo, const void* hi,
                                const void* rlo, const void* valid,
                                long long nodes, int S, int fmin, void* clo,
                                void* chi, void* crlo, void* cact, void* freq,
                                void* lc, void* sums, void* stream) {
  if (ntables < 1 || ntables > kMaxShards) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(sums, 0, (size_t)nodes * 5 * 4, st);
  if (err) return err;
  const long long cells = nodes * S;
  if (cells == 0) return 0;
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
  a.clo = (int32_t*)clo;
  a.chi = (int32_t*)chi;
  a.crlo = (int32_t*)crlo;
  a.cact = (uint8_t*)cact;
  a.freq = (int32_t*)freq;
  a.lc = (int8_t*)lc;
  a.sums = (int32_t*)sums;
  const long long blocks = (cells + kTile - 1) / kTile;
  level_expand_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a, tab);
  return (int)cudaGetLastError();
}
