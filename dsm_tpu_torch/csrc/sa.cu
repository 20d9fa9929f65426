// Prefix-doubling suffix array: one round's sort and rank update.
//
// Replaces dsm_tpu/ops/sa.py suffix_array_jax, whose rounds were one
// two-key lax.sort of (rank, rank[i+k]) carrying the suffix index (XLA's
// sort unit), an adjacent-difference cumsum and a scatter, over an input
// padded to a power of two so that one compiled program served every length.
// Here the host loop (ops/sa.py) runs the rounds at the input's own length,
// and each round is two entry points:
//
//   dsm_sa_sort  the suffixes in stable order of key[i] = rank[i] << 32 |
//                second(i), second(i) = i + k < n ? rank[i+k] + 1 : 0, with
//                the packed keys.  Two ways in:
//                - with the previous round's order (every round after the
//                  first, while k < n).  That order is sorted by rank with
//                  ties in ascending index, so the stable order by second is
//                  the k suffixes i >= n-k, then p - k for each p >= k of
//                  the previous order.  The first pass reads its keys in
//                  that order straight from the previous order (the derive
//                  is its load: nothing is written), and the passes sort by
//                  the rank bits alone.
//                - without it (the first round, or k >= n): the passes sort
//                  rank << lo | second over the lo + hi bits they need.
//                One kernel first counts the digits of every pass in one
//                read.  Then each pass is one 8-bit onesweep LSD launch: a
//                block takes the next tile (4096 keys) from a counter,
//                brings a whole tile of the previous order, or of the last
//                pass's keys and values, into shared memory by bulk async
//                copy (the first round builds its keys from rank as it
//                loads, and a ragged tile is read by the threads), ranks it
//                by digit with warp match-any and per-warp histograms
//                (stable: a warp holds consecutive keys),
//                learns each digit's start from its predecessors by
//                decoupled look-back (one status word per tile and digit,
//                tagged with the pass so one zeroing serves every pass),
//                reorders the tile in shared memory and writes each digit's
//                run coalesced.  The last pass writes the packed uint64 key
//                and the order.
//   dsm_sa_rank  new[i] = #{j <= i : key[j] != key[j-1]} by count -> scan
//                -> scatter (the structure of compact.cu), writes
//                rank[order[i]] = new[i], and stores new[n-1] (the round's
//                largest rank; n-1 when every suffix is distinct) for the
//                host's 4-byte readback.
//
// Bytes a key, a round after the first: 4 of rank read by the counts; the
// first pass 4 (previous order) + 4 (gathered rank) read and 8 written;
// each middle pass 8 read, 8 written; the last pass 8 read, 4 gathered
// (rank[i+k]) and 12 written.  With 21 rank bits (3 passes) that is ~60
// bytes a key in 5 launches (memset, counts, 3 passes), where the 4-bit
// count/scan/scatter design it replaced moved ~480 bytes in 33 launches.
// What bounds it on an H100: at n = 2^24 a middle pass moves its 16 bytes
// a key at ~1.2 TB/s, and the two random 4-byte gathers of rank (a 32-byte
// sector each once rank outgrows the L2) double the first and last
// passes; at 1.6M keys (all in L2) the per-tile latency of ~1.5 waves of
// blocks, two per SM.  Smaller tiles, more blocks per SM and look-back
// reading ahead did not move it (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "lookback.cuh"

namespace {

constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kThreads = 256;             // a sort block; thread d owns digit d
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread
constexpr int kWarpTile = 32 * kItems;    // consecutive keys per warp
constexpr int kTile = kThreads * kItems;  // keys per tile
constexpr int kMaxPasses = 8;             // 64 key bits
constexpr int kNoDigit = kRadix;          // a tile slot that holds no key
constexpr int kHistBlocks = 1024;         // at most; they stride the keys
constexpr int kHistCopies = 4;            // shared histograms per block
constexpr int kHistBatch = 4;             // keys a thread loads at once
constexpr int kRankBlock = 1024;          // keys (and threads) per rank block
constexpr int kScanThreads = 1024;

// A look-back status word (lookback.cuh): the pass + 1 from bit 34 up,
// the flag in bits 32-33, the tile's count of the digit (aggregate) or the
// count up to and including the tile (prefix) in bits 0-31.
using dsm::get;
using dsm::kAggregate;
using dsm::kPrefix;
using dsm::put;

struct Round {
  const int32_t* rank;
  const int32_t* prev;   // the previous round's order, or null
  long long n, k;
  int lo_bits;           // bits of second in the key; 0: the rank alone
  long long tail;        // with prev: the k suffixes whose second is 0
  int tail_tiles;        // with prev: the tiles they fill
  bool prev_bulk;        // prev is 16-byte aligned
  const int32_t* hist;   // [pass][digit] counts of all keys
  int32_t* next_tile;    // [pass] tile counters
  unsigned long long* status;  // [tile][digit], zeroed once per sort
};

__device__ __forceinline__ uint32_t second(const Round& r, long long i) {
  return i + r.k < r.n ? (uint32_t)r.rank[i + r.k] + 1u : 0u;
}

template <typename K>
__device__ __forceinline__ K make_key(const Round& r, long long i) {
  K key = (K)(uint32_t)r.rank[i] << r.lo_bits;
  if (r.lo_bits) key |= (K)second(r, i);
  return key;
}

// Exclusive scan of v over the block; *total, if not null, receives the
// sum.  sums: kWarps ints of shared memory that no other scan uses at the
// same time.
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int run = incl - v, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += sums[w];
    all += sums[w];
  }
  if (total) *total = all;
  return run;
}

// hist[p][d] = keys whose digit p is d, for the passes' digits.  Warps
// w and w + 4 share one of kHistCopies shared histograms (plain shared
// atomics); each thread loads kHistBatch keys before it counts them.
template <typename K>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(Round r, int passes, int32_t* __restrict__ hist) {
  __shared__ int cnt[kHistCopies][kMaxPasses * kRadix];
  for (int e = threadIdx.x; e < kHistCopies * kMaxPasses * kRadix;
       e += kThreads)
    (&cnt[0][0])[e] = 0;
  __syncthreads();
  int* mine = cnt[(threadIdx.x >> 5) % kHistCopies];
  const long long stride = (long long)gridDim.x * kThreads * kHistBatch;
  for (long long base = (long long)blockIdx.x * kThreads * kHistBatch +
                        threadIdx.x;
       base < r.n; base += stride) {
    K key[kHistBatch];
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      long long i = base + (long long)u * kThreads;
      key[u] = i < r.n ? make_key<K>(r, i) : (K)0;
    }
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      if (base + (long long)u * kThreads >= r.n) continue;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&mine[p * kRadix +
                         ((int)(key[u] >> (p * kDigitBits)) & (kRadix - 1))],
                  1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < passes * kRadix; e += kThreads) {
    int v = 0;
    for (int c = 0; c < kHistCopies; ++c) v += cnt[c][e];
    if (v) atomicAdd(&hist[e], v);
  }
}

enum Load { kArrays, kIdentity, kDerive };

// One onesweep pass over the digit at bit pass * 8.  Reads keys_in/vals_in
// (kArrays), the identity order (kIdentity) or the derived order from
// r.prev (kDerive); writes keys_out/vals_out, or, in the last pass, the
// packed keys to final_keys and the order to vals_out.
template <typename K, int kLoad, bool kFinal>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(Round r, int pass, const K* __restrict__ keys_in,
                const int32_t* __restrict__ vals_in, K* __restrict__ keys_out,
                uint64_t* __restrict__ final_keys,
                int32_t* __restrict__ vals_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  K* skey = reinterpret_cast<K*>(smem);                       // [kTile]
  int32_t* sval = reinterpret_cast<int32_t*>(skey + kTile);  // [kTile]
  int* whist = reinterpret_cast<int*>(sval + kTile);         // [warp][digit]
  __shared__ int local_start[kRadix], out_base[kRadix];
  __shared__ int sums_a[kWarps], sums_b[kWarps];
  __shared__ int tile_sh;
  __shared__ uint64_t bar;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int shift = pass * kDigitBits;
  if (t == 0) {
    tile_sh = atomicAdd(r.next_tile + pass, 1);
    dsm::bar_init(&bar);
  }
  for (int e = t; e < kWarps * kRadix; e += kThreads) whist[e] = 0;
  __syncthreads();
  const int tile = tile_sh;

  // Item j of this thread is slot warp * kWarpTile + j * 32 + lane of the
  // tile: each warp holds consecutive keys, 32 at a time, so the ranking
  // below, item by item and lane by lane, walks them in order.
  K key[kItems];
  int32_t val[kItems];
  bool ok[kItems];
  if (kLoad == kArrays) {
    const long long base = (long long)tile * kTile;
    const long long cnt = r.n - base < kTile ? r.n - base : kTile;
    const bool bulk = cnt == kTile;
    if (bulk) {
      if (t == 0) {
        dsm::bar_expect(&bar, kTile * (unsigned)(sizeof(K) + 4));
        dsm::bulk_load(skey, keys_in + base, kTile * sizeof(K), &bar);
        dsm::bulk_load(sval, vals_in + base, kTile * 4, &bar);
      }
      dsm::bar_wait(&bar, 0);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      int s = warp * kWarpTile + j * 32 + lane;
      ok[j] = s < cnt;
      key[j] = 0;
      val[j] = 0;
      if (bulk) {
        key[j] = skey[s];
        val[j] = sval[s];
      } else if (ok[j]) {
        key[j] = keys_in[base + s];
        val[j] = vals_in[base + s];
      }
    }
  } else if (kLoad == kIdentity) {
    const long long base = (long long)tile * kTile;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      long long i = base + warp * kWarpTile + j * 32 + lane;
      ok[j] = i < r.n;
      key[j] = ok[j] ? make_key<K>(r, i) : (K)0;
      val[j] = (int32_t)i;
    }
  } else {  // kDerive: the tail, then the previous order shifted by k
    const bool in_tail = tile < r.tail_tiles;
    const long long base = (long long)(in_tail ? tile : tile - r.tail_tiles) *
                           kTile;
    const long long cnt = in_tail ? 0 : (r.n - base < kTile ? r.n - base
                                                            : kTile);
    const bool bulk = !in_tail && cnt == kTile && r.prev_bulk;
    if (bulk) {
      if (t == 0) {
        dsm::bar_expect(&bar, kTile * 4);
        dsm::bulk_load(sval, r.prev + base, kTile * 4, &bar);
      }
      dsm::bar_wait(&bar, 0);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      int s = warp * kWarpTile + j * 32 + lane;
      long long idx;
      if (in_tail) {
        ok[j] = base + s < r.tail;
        idx = r.n - r.tail + base + s;
      } else {
        long long p = bulk ? sval[s] : (s < cnt ? r.prev[base + s] : -1);
        ok[j] = p >= r.k;
        idx = p - r.k;
      }
      key[j] = ok[j] ? (K)(uint32_t)r.rank[idx] : (K)0;
      val[j] = (int32_t)idx;
    }
  }

  // Rank each key among the warp's keys of its digit: rnk = the warp's
  // earlier keys of that digit.  packed[j] = digit << 16 | rnk.
  const unsigned below = (1u << lane) - 1u;
  int* wh = whist + warp * kRadix;
  int packed[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    int d = ok[j] ? (int)(key[j] >> shift) & (kRadix - 1) : kNoDigit;
    unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    int before = __popc(peers & below);
    int c = ok[j] ? wh[d] : 0;
    __syncwarp();
    if (ok[j] && before == 0) wh[d] = c + __popc(peers);
    __syncwarp();
    packed[j] = d << 16 | (c + before);
  }
  __syncthreads();

  // Thread t, digit t: the warps' exclusive prefix, the tile's count and
  // its tile-local start; then the tile is reordered in shared memory.
  int count = 0;
  for (int w = 0; w < kWarps; ++w) {
    int c = whist[w * kRadix + t];
    whist[w * kRadix + t] = count;
    count += c;
  }
  unsigned long long* st = r.status + (long long)tile * kRadix + t;
  const unsigned long long tag = (unsigned long long)(pass + 1) << 34;
  put(st, tag | (tile == 0 ? kPrefix : kAggregate) | (unsigned)count);
  int kept;
  const int ls = block_scan(count, sums_a, &kept);
  local_start[t] = ls;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    int d = packed[j] >> 16;
    if (d == kNoDigit) continue;
    int pos = local_start[d] + wh[d] + (packed[j] & 0xFFFF);
    skey[pos] = key[j];
    sval[pos] = val[j];
  }

  // The digit's global start, and its keys in earlier tiles by look-back:
  // walk back over the predecessors' words, each waited for until this
  // pass has published it, summing aggregates up to the first prefix.
  const int gs = block_scan(r.hist[pass * kRadix + t], sums_b, nullptr);
  long long excl = 0;
  if (tile > 0) {
    for (int p = tile - 1;; --p) {
      unsigned long long w;
      do {
        w = get(r.status + (long long)p * kRadix + t);
      } while ((w >> 34) != (unsigned long long)(pass + 1));
      excl += (uint32_t)w;
      if (w & kPrefix) break;
    }
    put(st, tag | kPrefix | (unsigned)(excl + count));
  }
  out_base[t] = (int)(gs + excl - ls);
  __syncthreads();

  // Consecutive slots of one digit go to consecutive places: runs.
  for (int p = t; p < kept; p += kThreads) {
    K k2 = skey[p];
    int32_t v = sval[p];
    long long dst = (long long)out_base[(int)(k2 >> shift) & (kRadix - 1)] + p;
    if (kFinal) {
      uint64_t lo = r.lo_bits ? (uint64_t)(k2 & (((K)1 << r.lo_bits) - 1))
                              : (uint64_t)second(r, v);
      final_keys[dst] = (uint64_t)(k2 >> r.lo_bits) << 32 | lo;
    } else {
      keys_out[dst] = k2;
    }
    vals_out[dst] = v;
  }
}

// The sort's scratch, carved from one buffer: the zeroed head (counts,
// tile counters, status words), then up to two ping-pong key/value pairs.
struct Layout {
  int passes, key_bytes;
  size_t hist, next_tile, status, head, keys[2], vals[2], total;
};

Layout layout(long long n, long long tail, int bits) {
  Layout L{};
  L.passes = bits > 0 ? (bits + kDigitBits - 1) / kDigitBits : 1;
  L.key_bytes = bits <= 32 ? 4 : 8;
  long long tiles = (n + kTile - 1) / kTile + (tail + kTile - 1) / kTile;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off += (bytes + 255) & ~(size_t)255;
    return at;
  };
  L.hist = take(kMaxPasses * kRadix * sizeof(int32_t));
  L.next_tile = take(kMaxPasses * sizeof(int32_t));
  L.status = take((size_t)tiles * kRadix * sizeof(unsigned long long));
  L.head = off;
  for (int b = 0; b < L.passes - 1 && b < 2; ++b) {
    L.keys[b] = take((size_t)n * L.key_bytes);
    L.vals[b] = take((size_t)n * sizeof(int32_t));
  }
  L.total = off;
  return L;
}

template <typename K, int kLoad, bool kFinal>
int launch_pass(const Round& r, int pass, long long tiles, const void* kin,
                const void* vin, void* kout, void* fkeys, void* vout,
                cudaStream_t s) {
  const int smem = kTile * (int)(sizeof(K) + 4) + kWarps * kRadix * 4;
  int err = (int)cudaFuncSetAttribute(pass_kernel<K, kLoad, kFinal>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
  if (err) return err;
  pass_kernel<K, kLoad, kFinal><<<(unsigned)tiles, kThreads, smem, s>>>(
      r, pass, (const K*)kin, (const int32_t*)vin, (K*)kout, (uint64_t*)fkeys,
      (int32_t*)vout);
  return (int)cudaGetLastError();
}

template <typename K, int kLoad>
int run_pass(bool last, const Round& r, int pass, long long tiles,
             const void* kin, const void* vin, void* kout, void* fkeys,
             void* vout, cudaStream_t s) {
  return last ? launch_pass<K, kLoad, true>(r, pass, tiles, kin, vin, kout,
                                             fkeys, vout, s)
              : launch_pass<K, kLoad, false>(r, pass, tiles, kin, vin, kout,
                                              fkeys, vout, s);
}

template <typename K>
int sort(const Round& r, const Layout& L, unsigned char* w, void* keys,
         void* order, cudaStream_t s) {
  int err = (int)cudaMemsetAsync(w, 0, L.head, s);
  if (err) return err;
  const long long tiles = (r.n + kTile - 1) / kTile;
  const long long hblocks = (r.n + kThreads * kHistBatch - 1) /
                            (kThreads * kHistBatch);
  hist_kernel<K><<<(unsigned)(hblocks < kHistBlocks ? hblocks : kHistBlocks),
                   kThreads, 0, s>>>(r, L.passes, (int32_t*)(w + L.hist));
  if ((err = (int)cudaGetLastError())) return err;
  for (int p = 0; p < L.passes; ++p) {
    const bool last = p == L.passes - 1;
    const void* kin = p ? w + L.keys[(p - 1) & 1] : nullptr;
    const void* vin = p ? w + L.vals[(p - 1) & 1] : nullptr;
    void* kout = last ? nullptr : w + L.keys[p & 1];
    void* vout = last ? order : w + L.vals[p & 1];
    if (p > 0)
      err = run_pass<K, kArrays>(last, r, p, tiles, kin, vin, kout, keys,
                                    vout, s);
    else if (r.prev)
      err = run_pass<K, kDerive>(last, r, p, tiles + r.tail_tiles, kin,
                                    vin, kout, keys, vout, s);
    else
      err = run_pass<K, kIdentity>(last, r, p, tiles, kin, vin, kout, keys,
                                      vout, s);
    if (err) return err;
  }
  return 0;
}

__device__ __forceinline__ bool differs(const uint64_t* __restrict__ keys,
                                        long long n, long long i) {
  return i > 0 && i < n && keys[i] != keys[i - 1];
}

// Exclusive scan of m int32 counts by one block: thread t owns a
// contiguous chunk, so any m is scanned in one launch.  total, if not
// null, receives the sum.
__global__ void scan_kernel(const int32_t* __restrict__ in, long long m,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ total) {
  __shared__ int32_t part[kScanThreads];
  int t = threadIdx.x;
  long long chunk = (m + kScanThreads - 1) / kScanThreads;
  long long b0 = t * chunk;
  long long b1 = b0 + chunk < m ? b0 + chunk : m;
  int32_t s = 0;
  for (long long b = b0; b < b1; ++b) s += in[b];
  part[t] = s;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // Hillis-Steele, inclusive
    int32_t v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int32_t run = part[t] - s;
  for (long long b = b0; b < b1; ++b) {
    int32_t c = in[b];
    out[b] = run;
    run += c;
  }
  if (total != nullptr && t == kScanThreads - 1) *total = part[t];
}

__global__ void flag_count_kernel(const uint64_t* __restrict__ keys,
                                  long long n,
                                  int32_t* __restrict__ block_count) {
  __shared__ int warp_count[kRankBlock / 32];
  long long i = (long long)blockIdx.x * kRankBlock + threadIdx.x;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, differs(keys, n, i));
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_count[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) block_count[blockIdx.x] = v;
  }
}

__global__ void rank_scatter_kernel(const uint64_t* __restrict__ keys,
                                    const int32_t* __restrict__ order,
                                    long long n,
                                    const int32_t* __restrict__ block_off,
                                    int32_t* __restrict__ rank) {
  __shared__ int warp_off[kRankBlock / 32];
  long long i = (long long)blockIdx.x * kRankBlock + threadIdx.x;
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, differs(keys, n, i));
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_off[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += u;
    }
    warp_off[lane] = incl - v;
  }
  __syncthreads();
  if (i >= n) return;
  unsigned upto = ballot & ((2u << lane) - 1u);  // lanes <= this one
  rank[order[i]] = block_off[blockIdx.x] + warp_off[warp] + __popc(upto);
}

}  // namespace

// Bytes of scratch dsm_sa_sort needs: tail = min(k, n) with a previous
// order, else 0; bits = the key bits the passes sort.
extern "C" long long dsm_sa_sort_workspace(long long n, long long tail,
                                           int bits) {
  return (long long)layout(n, tail, bits).total;
}

// One round's sort.  rank: n int32 in [0, 2^hi); prev: the previous
// round's order (n int32) or null, and then lo_bits = 0; bits = hi +
// lo_bits.  keys (n uint64) and order (n int32) receive the
// sorted packed keys and the suffix order; work: the workspace's bytes.
extern "C" int dsm_sa_sort(const void* rank, const void* prev, long long n,
                           long long k, int lo_bits, int bits, void* keys,
                           void* order, void* work, void* stream) {
  Round r{};
  r.rank = (const int32_t*)rank;
  r.prev = (const int32_t*)prev;
  r.n = n;
  r.k = k;
  r.lo_bits = lo_bits;
  r.tail = prev ? (k < n ? k : n) : 0;
  r.tail_tiles = (int)((r.tail + kTile - 1) / kTile);
  r.prev_bulk = ((uintptr_t)prev & 15) == 0;
  const Layout L = layout(n, r.tail, bits);
  unsigned char* w = (unsigned char*)work;
  r.hist = (const int32_t*)(w + L.hist);
  r.next_tile = (int32_t*)(w + L.next_tile);
  r.status = (unsigned long long*)(w + L.status);
  cudaStream_t s = (cudaStream_t)stream;
  return L.key_bytes == 4 ? sort<uint32_t>(r, L, w, keys, order, s)
                          : sort<uint64_t>(r, L, w, keys, order, s);
}

// One round's rank update from the sorted keys and their suffix order.
// block_count, block_off: ceil(n / 1024) int32 each; last: one int32.
extern "C" int dsm_sa_rank(const void* keys, const void* order, long long n,
                           void* rank, void* block_count, void* block_off,
                           void* last, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long nblocks = (n + kRankBlock - 1) / kRankBlock;
  flag_count_kernel<<<(unsigned)nblocks, kRankBlock, 0, s>>>(
      (const uint64_t*)keys, n, (int32_t*)block_count);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)block_count, nblocks,
                                        (int32_t*)block_off, (int32_t*)last);
  err = (int)cudaGetLastError();
  if (err) return err;
  rank_scatter_kernel<<<(unsigned)nblocks, kRankBlock, 0, s>>>(
      (const uint64_t*)keys, (const int32_t*)order, n,
      (const int32_t*)block_off, (int32_t*)rank);
  return (int)cudaGetLastError();
}
