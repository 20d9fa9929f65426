// The children step of a trie level in one pass: the kept (pair, symbol)
// lanes become the next level's pair rows in (node, symbol, pair) order,
// with the child ids, the next node starts and the history entries.
//
// Replaces the children block of dsm_tpu/mining/engine_device.py
// _level_single (:789-846): a 5-operand lax.sort of the 4B lanes keyed on
// hv = (nid*4 + c)*P2 + poff (with a drop sentinel), a boundary cumsum for
// the child ids, and a second sort that writes the history entries and the
// nb boundaries.  A node's pairs are already contiguous and in pair order,
// so every output slot follows from scans and no sort is needed.
//
// dsm_children_ids (kOutsideIds) is the same step for one process's pair
// list of a sample-sharded level (_level_sharded, the children block at
// :474-507): a child exists when ANY process keeps a lane of it, so which
// symbols of a
// node have a child (the exists bits of `flags`) and the node's first child
// id (`kid0`) come from the level's global numbering (shardstats.cu), every
// existing child gets an nb_next entry here (an empty segment when this
// process keeps no lane of it), and the history, one a rank, is not
// written.
//
// What bounds it on an H100: bytes, and before them the loads a thread has
// in flight.  A pair brings 4 keep bytes and its 24-byte row, a kept lane 16
// bytes of the rank outputs in and a 24-byte row out.  One launch; keep is
// read once; every access of a warp falls on neighbouring addresses; every
// load leaves as soon as its address is known:
//
//   * A tile is a run of whole nodes: tile t owns the nodes whose first
//     pair nb[u] lies in [t*T, (t+1)*T), T = 1024.  Each end is the lower
//     bound of its position in nb, found from the node that the pair row at
//     that position names (two dependent loads; a search in nb took five or
//     more).  The lower bound on both ends gives every node, a node without
//     a pair too, to exactly one tile (the one of the pair position it sits
//     at; the last tile takes what sits at P).  A node has at most 512
//     pairs (MAX_SAMPLES), so the tile's pairs lie in the 1536 slots from
//     t*T on, whatever the sample count.
//   * Threads own pairs (slots t, t + 256, ...).  A thread reads its pairs'
//     keep bytes without waiting for the tile's ends (the slots are known
//     from t alone), then the kept pairs' nodes and those nodes' ends, and
//     keeps them in registers: the scan, the numbering and the look-back
//     run while these loads are in flight.
//   * A pair's keep bytes become a 4-bit mask and, spread to four 16-bit
//     fields of one word, the input of an exclusive scan over the slots, X.
//     For a node with slots [f, l), X[l] - X[f] holds its four per-symbol
//     counts, the fields of X[f] add up to its first row within the tile,
//     and X[j] - X[f] counts the node's kept lanes before pair j under each
//     symbol: lane (s, j) lands at  first row + counts below s + that.
//   * The ids of a tile's children: one thread a node counts the symbols
//     with a lane and a block scan numbers them (not with outside ids).
//   * The tile's totals (lanes, children) go through a decoupled look-back
//     (lookback.cuh), one status word each, since each needs up to 31
//     bits: warp 0 chains the lanes while warp 1 chains the children.
//     Tiles are handed out by an atomic counter, in order.
//   * The map.  The pair threads write, for each row of the tile's run,
//     where it comes from (slot, symbol, children below: 15 bits) into
//     shared memory, from the scan alone.  The first kept lane of a (node,
//     symbol) group also writes the child's nb_next and history entry: each
//     tile's are a contiguous run.  With outside ids one thread a node
//     writes the nb_next entries of all its existing children.
//   * The rows.  Threads then own ROWS of the run, in output order, four at
//     a time: a row's eight loads (four rank outputs, its pair row) are
//     unconditional and all of a batch's leave before the first is used, so
//     a thread has up to 32 loads in flight; a row goes out as three 8-byte
//     stores and a warp's rows are one contiguous 768 bytes.  The earlier
//     form of this pass, threads owning pairs with a predicated load a
//     symbol and the rows staged in shared memory for 16-byte stores, had
//     fewer loads in flight and was 1.07-1.13x slower (PERF.md); registers
//     (64 a thread, four blocks an SM) are what the batch is sized to.
//
// Shared memory: 12,304 (X) + 12,288 (the map, 2 bytes a lane) + 3,072 (the
// nodes' first child ids, by first slot) + 1,536 (masks) = 29,200 bytes a
// block of 256 threads.  It does not grow with the pairs a node holds.
// Writes past pair_count or child_total are dropped (the host's counts size
// the outputs).  A tile whose nodes are nearly all without a pair is walked
// by its one block: a process that holds no pair costs one block's walk
// over the nodes, not a fault.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePairs = 1024;                // T
constexpr int kMaxNode = 512;                   // MAX_SAMPLES
constexpr int kCap = kTilePairs + kMaxNode;     // pairs a tile can hold
constexpr int kItems = kCap / kThreads;         // scan items a thread
constexpr int kBlocksPerSM = 4;                 // 64 registers a thread
constexpr int kBatch = 4;                       // rows a thread has in flight
constexpr int kCols = 6;
constexpr size_t kXBytes = ((kCap + 1) * 8 + 15) & ~(size_t)15;
constexpr size_t kSrcBytes = 4 * kCap * 2;      // a source word a lane
constexpr size_t kSmem = kXBytes + kSrcBytes + kCap * 2 + kCap;
static_assert(kCap % kThreads == 0, "a thread scans kItems pairs");

struct Level {
  const int32_t *nb, *pairs, *olo, *ohi;
  const uint8_t* keep;
  const int32_t *flags, *kid0;   // outside ids only
  long long U, P, pair_count, child_total, ntiles;
  unsigned long long *lanes_status, *kids_status, *next_tile;
  int32_t *newp, *nb_next, *hist;
};

__device__ __forceinline__ int field(unsigned long long x, int s) {
  return (int)(x >> (16 * s)) & 0xFFFF;
}

__device__ __forceinline__ int field_sum(unsigned long long x) {
  return field(x, 0) + field(x, 1) + field(x, 2) + field(x, 3);
}

// Exclusive scan of v over the block and its sum; sums: kWarps words that
// are free again when it returns.
template <typename V>
__device__ __forceinline__ V block_scan(V v, V* sums, V* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    V u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  V run = incl - v, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += sums[w];
    all += sums[w];
  }
  __syncthreads();
  *total = all;
  return run;
}

template <bool kOutsideIds>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    children_kernel(Level a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* X = reinterpret_cast<unsigned long long*>(smem);
  uint16_t* lane_src = reinterpret_cast<uint16_t*>(smem + kXBytes);
  uint16_t* kid_at = reinterpret_cast<uint16_t*>(smem + kXBytes + kSrcBytes);
  uint8_t* kb = smem + kXBytes + kSrcBytes + kCap * 2;
  __shared__ unsigned long long sums64[kWarps];
  __shared__ int sums32[kWarps];
  __shared__ long long tile_sh, end_u[2], end_p[2], lane0_sh, kidbase_sh;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long P = a.P;
  if (t == 0) tile_sh = (long long)atomicAdd(a.next_tile, 1ull);
  __syncthreads();
  const long long tile = tile_sh;
  // Slot j of the tile is pair q0 + j.  The tile's own pairs [p0, p1) lie
  // in slots [0, kCap): p0 >= q0, and its last node starts before q0 + T.
  const long long q0 = tile * kTilePairs;

  // ---- everything the tile reads before its scan leaves here, each load
  // as soon as its address is known: the two ends (warps 0 and 1: the pair
  // row at the end's position names the node that holds it), the window's
  // keep bytes, the kept pairs' nodes, those nodes' ends ------------------
  // An end is the smallest node u with nb[u] >= key, and nb[u]: the
  // successor of the node holding pair `key` when that node starts before
  // key; else the node itself, or the first of the nodes without a pair
  // that sit at key before it (read 32 at a time, backwards).
  const long long key = q0 + (warp == 1 ? kTilePairs : 0);
  const bool probe = warp < 2 && key < P;   // else: 0, or what sits at P
  long long end_node = 0;
  if (probe) end_node = a.pairs[key * kCols + 5];

  unsigned bits = 0;   // this thread's pairs, 4 bits each
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = q0 + t + i * kThreads;
    if (p < P) {
      const uint8_t* k = a.keep + p;
      bits |= ((k[0] != 0) | (k[P] != 0) << 1 | (k[2 * P] != 0) << 2 |
               (k[3 * P] != 0) << 3)
              << (4 * i);
    }
  }
  long long end_start = 0, end_next = 0, end_back = -1;
  if (probe) {
    end_start = a.nb[end_node];
    end_next = a.nb[end_node + 1];
    if (end_node - 1 - lane >= 0) end_back = a.nb[end_node - 1 - lane];
  }
  int node[kItems], pf[kItems], pl[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    node[i] = (bits >> (4 * i)) & 15
                  ? a.pairs[(q0 + t + i * kThreads) * kCols + 5]
                  : -1;
  if (warp < 2) {
    long long u = key == 0 ? 0 : a.U, p = key == 0 ? 0 : P;
    if (probe && end_start < key) {
      u = end_node + 1;
      p = end_next;
    } else if (probe) {
      u = end_node;
      p = key;
      for (;;) {
        const unsigned same = __ballot_sync(0xFFFFFFFFu, end_back == key);
        const int run = __ffs(~same) - 1;   // -1: all 32 sit at key
        u -= run < 0 ? 32 : run;
        if (run >= 0) break;
        end_back = u - 1 - lane >= 0 ? a.nb[u - 1 - lane] : -1;
      }
    }
    if (lane == 0) end_u[warp] = u, end_p[warp] = p;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (node[i] < 0) continue;
    pf[i] = (int)(a.nb[node[i]] - q0);
    pl[i] = (int)(a.nb[node[i] + 1] - q0);
  }
  __syncthreads();
  const long long u_lo = end_u[0], u_hi = end_u[1];
  const int s0 = (int)(end_p[0] - q0), s1 = (int)(end_p[1] - q0);
  if (s1 > kCap) __trap();   // a node of more than kMaxNode pairs
  // the first round of the node pass below: its loads leave now
  int node_f = 0, node_l = 0;
  if (!kOutsideIds && u_lo + t < u_hi) {
    node_f = a.nb[u_lo + t];
    node_l = a.nb[u_lo + t + 1];
  }

  // ---- the masks of the tile's own pairs, and X, their scan by symbol --
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int j = t + i * kThreads;
    if (j < s0 || j >= s1) {
      bits &= ~(15u << (4 * i));
      node[i] = -1;
    }
    kb[j] = (uint8_t)((bits >> (4 * i)) & 15);
  }
  __syncthreads();
  {
    unsigned long long incl[kItems], run = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned long long b = kb[t * kItems + i];
      run += (b & 1) | (b & 2) << 15 | (b & 4) << 30 | (b & 8) << 45;
      incl[i] = run;
    }
    unsigned long long all;
    const unsigned long long before = block_scan(run, sums64, &all);
    X[t * kItems] = before;
#pragma unroll
    for (int i = 1; i < kItems; ++i) X[t * kItems + i] = before + incl[i - 1];
    if (t == kThreads - 1) X[kCap] = all;
  }
  __syncthreads();
  const int lanes = field_sum(X[kCap]);

  // ---- the first child id of each node with a pair, within the tile ----
  int kids = 0;
  if (!kOutsideIds) {
    for (long long ub = u_lo; ub < u_hi; ub += kThreads) {
      const long long u = ub + t;
      int k = 0, f = 0;
      bool has = false;
      if (u < u_hi) {
        if (ub > u_lo) {
          node_f = a.nb[u];
          node_l = a.nb[u + 1];
        }
        f = (int)(node_f - q0);
        const int l = (int)(node_l - q0);
        const unsigned long long d = X[l] - X[f];
        k = (field(d, 0) > 0) + (field(d, 1) > 0) + (field(d, 2) > 0) +
            (field(d, 3) > 0);
        has = l > f;
      }
      int all;
      const int before = block_scan(k, sums32, &all);
      if (has) kid_at[f] = (uint16_t)(kids + before);
      kids += all;
    }
  }

  // ---- the tile's first row and first child id: look-back --------------
  if (t == 0) {
    const unsigned long long flag = tile == 0 ? dsm::kPrefix : dsm::kAggregate;
    dsm::put(a.lanes_status + tile, flag | (unsigned)lanes);
    if (!kOutsideIds) dsm::put(a.kids_status + tile, flag | (unsigned)kids);
    if (tile == 0) lane0_sh = kidbase_sh = 0;
  }
  if (tile > 0 && warp == 0) {
    const unsigned long long e = dsm::lookback_exclusive(a.lanes_status, tile);
    if (lane == 0) {
      dsm::put(a.lanes_status + tile, dsm::kPrefix | (unsigned)(e + lanes));
      lane0_sh = (long long)e;
    }
  } else if (tile > 0 && warp == 1 && !kOutsideIds) {
    const unsigned long long e = dsm::lookback_exclusive(a.kids_status, tile);
    if (lane == 0) {
      dsm::put(a.kids_status + tile, dsm::kPrefix | (unsigned)(e + kids));
      kidbase_sh = (long long)e;
    }
  }
  __syncthreads();
  const long long lane0 = lane0_sh, kidbase = kidbase_sh;
  if (tile == a.ntiles - 1 && t == 0) {
    const long long k = kOutsideIds ? a.child_total : kidbase + kids;
    if (k <= a.child_total) a.nb_next[k] = (int32_t)(lane0 + lanes);
  }

  // ---- outside ids: every existing child's first row, a thread a node --
  if (kOutsideIds) {
    for (long long u = u_lo + t; u < u_hi; u += kThreads) {
      const int exists = (a.flags[u] >> 4) & 15;
      if (!exists) continue;
      const unsigned long long xf = X[a.nb[u] - q0];
      const unsigned long long d = X[a.nb[u + 1] - q0] - xf;
      long long row = lane0 + field_sum(xf), kid = a.kid0[u];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if ((exists >> s) & 1) {
          if (kid < a.child_total) a.nb_next[kid] = (int32_t)row;
          ++kid;
        }
        row += field(d, s);
      }
    }
  }

  // ---- the map: where each row of the tile's run comes from; nothing is
  // loaded here but the scan -----------------------------------------------
  if (lanes == 0) return;
  const long long room = a.pair_count - lane0;
  const int nrow = room <= 0 ? 0 : (room < lanes ? (int)room : lanes);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (node[i] < 0) continue;
    const int j = t + i * kThreads, f = pf[i];
    const unsigned b = (bits >> (4 * i)) & 15;
    const unsigned long long xf = X[f];
    const unsigned long long dn = X[pl[i]] - xf;
    const unsigned long long dj = X[j] - xf;
    int first = field_sum(xf);   // of the node's rows under the symbol
    long long kid = 0;   // of the node's first child
    int below = 0;       // the node's children under lower symbols
    if (!kOutsideIds) {
      kid = kidbase + kid_at[f];
      kid_at[j] = kid_at[f];   // j == f, or a slot no node starts at
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int cn = field(dn, s);
      if ((b >> s) & 1) {
        const int before = field(dj, s);
        if (!kOutsideIds && before == 0 && kid + below < a.child_total) {
          a.nb_next[kid + below] = (int32_t)(lane0 + first);
          a.hist[kid + below] = (int32_t)(node[i] * 4 + s);
        }
        const int at = first + before;
        if (at < nrow) lane_src[at] = (uint16_t)(j | s << 11 | below << 13);
      }
      first += cn;
      below += cn > 0;
    }
  }
  __syncthreads();

  // ---- the rows: threads own rows of the run, kBatch at a time, all of
  // a batch's loads in flight together -----------------------------------
  int2* dst = reinterpret_cast<int2*>(a.newp + lane0 * kCols);
  for (int base = t; base < nrow; base += kBatch * kThreads) {
    int32_t r[kBatch][kCols];
    uint32_t lo4[kBatch], hi4[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int at = base + i * kThreads;
      if (at >= nrow) break;
      const unsigned w = lane_src[at];
      const int j = w & 2047, sym = (w >> 11) & 3;
      const long long p = q0 + j;
      const int32_t* src = a.pairs + p * kCols;
      r[i][0] = a.olo[sym * P + p];
      r[i][1] = a.ohi[sym * P + p];
      lo4[i] = (uint32_t)a.olo[(4 + sym) * P + p];
      hi4[i] = (uint32_t)a.ohi[(4 + sym) * P + p];
      r[i][2] = src[2];
      r[i][3] = src[3];
      r[i][4] = src[4];
      if (kOutsideIds) {   // the node's first child id + its children below
        const int32_t u = src[5];
        const int lower = (a.flags[u] >> 4) & ((1 << sym) - 1);
        r[i][5] = a.kid0[u] + __popc(lower);
      } else {
        r[i][5] = (int32_t)(kidbase + kid_at[j] + (w >> 13));
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int at = base + i * kThreads;
      if (at >= nrow) break;
      int2* to = dst + (long long)at * 3;   // a row is three 8-byte words
      to[0] = make_int2(r[i][0], r[i][1]);
      to[1] = make_int2((int32_t)((uint32_t)r[i][2] + (hi4[i] - lo4[i])),
                        r[i][3]);
      to[2] = make_int2(r[i][4], r[i][5]);
    }
  }
}

// scratch: 2 * ntiles + 1 int64 (the lanes' and the children's status
// words, the tile counter), ntiles = max(1, ceil(P / 1024)).
template <bool kOutsideIds>
int run(Level a, void* scratch, cudaStream_t s) {
  int err;
  if ((err = (int)cudaFuncSetAttribute(
           children_kernel<kOutsideIds>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem)))
    return err;
  a.ntiles = (a.P + kTilePairs - 1) / kTilePairs;
  if (a.ntiles < 1) a.ntiles = 1;
  a.lanes_status = (unsigned long long*)scratch;
  a.kids_status = a.lanes_status + a.ntiles;
  a.next_tile = a.kids_status + a.ntiles;
  if ((err = (int)cudaMemsetAsync(scratch, 0, (size_t)(2 * a.ntiles + 1) * 8,
                                  s)))
    return err;
  children_kernel<kOutsideIds><<<(unsigned)a.ntiles, kThreads, kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

Level level(const void* nb, const void* pairs, const void* olo,
            const void* ohi, const void* keep, long long U, long long P,
            const void* flags, const void* kid0, long long pair_count,
            long long child_total, void* newp, void* nb_next, void* hist) {
  Level a{};
  a.nb = (const int32_t*)nb;
  a.pairs = (const int32_t*)pairs;
  a.olo = (const int32_t*)olo;
  a.ohi = (const int32_t*)ohi;
  a.keep = (const uint8_t*)keep;
  a.flags = (const int32_t*)flags;
  a.kid0 = (const int32_t*)kid0;
  a.U = U;
  a.P = P;
  a.pair_count = pair_count;
  a.child_total = child_total;
  a.newp = (int32_t*)newp;
  a.nb_next = (int32_t*)nb_next;
  a.hist = (int32_t*)hist;
  return a;
}

}  // namespace

// U >= 1; every pair row's last column is its node, nb[node] <= p <
// nb[node + 1], and no node holds more than 512 pairs.
extern "C" int dsm_children(const void* nb, const void* pairs, const void* olo,
                            const void* ohi, const void* keep, long long U,
                            long long P, long long pair_count,
                            long long child_total, void* scratch, void* newp,
                            void* nb_next, void* hist, void* stream) {
  return run<false>(level(nb, pairs, olo, ohi, keep, U, P, nullptr, nullptr,
                          pair_count, child_total, newp, nb_next, hist),
                    scratch, (cudaStream_t)stream);
}

// flags, kid0: (U,) int32 from dsm_node_gates; nb_next has child_total + 1
// entries whatever this process keeps.
extern "C" int dsm_children_ids(const void* nb, const void* pairs,
                                const void* olo, const void* ohi,
                                const void* keep, long long U, long long P,
                                const void* flags, const void* kid0,
                                long long pair_count, long long child_total,
                                void* scratch, void* newp, void* nb_next,
                                void* stream) {
  return run<true>(level(nb, pairs, olo, ohi, keep, U, P, flags, kid0,
                         pair_count, child_total, newp, nb_next, nullptr),
                   scratch, (cudaStream_t)stream);
}
