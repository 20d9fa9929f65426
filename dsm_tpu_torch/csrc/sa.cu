// Prefix-doubling suffix array: one round's sort and rank update.
//
// Replaces dsm_tpu/ops/sa.py suffix_array_jax, whose rounds were one
// two-key lax.sort of (rank, rank[i+k]) carrying the suffix index (XLA's
// sort unit), an adjacent-difference cumsum and a scatter, over an input
// padded to a power of two so that one compiled program served every length.
// Here the host loop (ops/sa.py) runs the rounds at the input's own length,
// and each round is two entry points:
//
//   dsm_sa_sort  builds key[i] = rank[i] << 32 | (i+k < n ? rank[i+k]+1 : 0)
//                with payload i, then LSD radix-sorts the pairs, 4 bits a
//                pass, over only the bits the round's largest rank needs
//                (low half: bits of max_rank+1; high half: bits of
//                max_rank).  A pass is count -> scan -> stable scatter:
//                  count:   per 4096-key block, the 16 digit counts;
//                  scan:    one block scans the (digit, block) counts in
//                           digit-major order into global offsets;
//                  scatter: each thread owns 16 consecutive keys, so the
//                           block's keys of one digit keep their order
//                           (thread-major, then key-major): stable.
//   dsm_sa_rank  new[i] = #{j <= i : key[j] != key[j-1]} by count -> scan
//                -> scatter (the structure of compact.cu), writes
//                rank[order[i]] = new[i], and stores new[n-1] (the round's
//                largest rank; n-1 when every suffix is distinct) for the
//                host's 4-byte readback.
//
// What bounds it on an H100: bytes.  A pass reads each 8-byte key three
// times (the count, and the scatter's two walks over its keys) and each
// 4-byte payload once, and writes both, scattered over 16 digit runs per
// block: 40 bytes a key, ~0.9 GB for a round of 11 passes at n = 2^21.
// The 4-bit digit keeps per-thread counters in two registers (8 bits per
// digit, packed) and the scan table small; wider digits, a one-sweep scan
// and reading the tile through shared memory are the next steps for speed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 4;                  // radix digit width
constexpr int kRadix = 1 << kBits;        // digit values
constexpr int kThreads = 256;             // threads of a sort block
constexpr int kItems = 16;                // consecutive keys per thread
constexpr int kTile = kThreads * kItems;  // keys per sort block
constexpr int kCells = kRadix * kThreads; // per-(digit, thread) counters
constexpr int kRankBlock = 1024;          // keys (and threads) per rank block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned digit_of(uint64_t key, int shift) {
  return (unsigned)(key >> shift) & (kRadix - 1);
}

// A thread's digit counts over at most 255 keys, 8 bits per digit: digits
// 0-7 in lo, 8-15 in hi.
__device__ __forceinline__ void bump(uint64_t& lo, uint64_t& hi, unsigned d) {
  uint64_t one = 1ull << ((d & 7u) * 8u);
  if (d < 8u) lo += one; else hi += one;
}

__device__ __forceinline__ int unpack(uint64_t lo, uint64_t hi, int d) {
  return (int)(((d < 8 ? lo : hi) >> ((d & 7) * 8)) & 0xFFu);
}

// Shared-memory index with one pad word per 32: both the digit-major
// writes (consecutive threads) and the scan's per-thread runs of kRadix
// cells hit distinct banks.
__device__ __forceinline__ int skew(int e) { return e + (e >> 5); }

__global__ void keys_kernel(const int32_t* __restrict__ rank, long long n,
                            long long k, uint64_t* __restrict__ keys,
                            int32_t* __restrict__ vals) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t second = i + k < n ? (uint32_t)rank[i + k] + 1u : 0u;
  keys[i] = (uint64_t)(uint32_t)rank[i] << 32 | second;
  vals[i] = (int32_t)i;
}

// counts[d * nblocks + b] = keys of block b whose digit is d.
__global__ void digit_count_kernel(const uint64_t* __restrict__ keys,
                                   long long n, int shift, int nblocks,
                                   int32_t* __restrict__ counts) {
  __shared__ int cnt[kRadix][kThreads];
  int t = threadIdx.x;
  long long base = (long long)blockIdx.x * kTile;
  uint64_t lo = 0, hi = 0;
  for (int j = 0; j < kItems; ++j) {  // coalesced: order does not matter here
    long long i = base + (long long)j * kThreads + t;
    if (i < n) bump(lo, hi, digit_of(keys[i], shift));
  }
  for (int d = 0; d < kRadix; ++d) cnt[d][t] = unpack(lo, hi, d);
  __syncthreads();
  int lane = t & 31, warp = t >> 5;
  for (int d = warp; d < kRadix; d += kThreads / 32) {
    int v = 0;
    for (int u = lane; u < kThreads; u += 32) v += cnt[d][u];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) counts[(long long)d * nblocks + blockIdx.x] = v;
  }
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

__global__ void digit_scatter_kernel(const uint64_t* __restrict__ keys,
                                     const int32_t* __restrict__ vals,
                                     long long n, int shift, int nblocks,
                                     const int32_t* __restrict__ offsets,
                                     uint64_t* __restrict__ keys_out,
                                     int32_t* __restrict__ vals_out) {
  __shared__ int cell[kCells + kCells / 32];  // [skew(d * kThreads + t)]
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int digit_start[kRadix];
  int t = threadIdx.x;
  long long first = (long long)blockIdx.x * kTile + (long long)t * kItems;
  uint64_t lo = 0, hi = 0;
  for (int j = 0; j < kItems; ++j) {
    long long i = first + j;
    if (i < n) bump(lo, hi, digit_of(keys[i], shift));
  }
  for (int d = 0; d < kRadix; ++d)
    cell[skew(d * kThreads + t)] = unpack(lo, hi, d);
  __syncthreads();

  // Exclusive scan of the cells in digit-major order; thread t scans the
  // run of cells [t * kRadix, (t + 1) * kRadix).
  int s = 0;
  for (int j = 0; j < kRadix; ++j) s += cell[skew(t * kRadix + j)];
  int lane = t & 31, warp = t >> 5;
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - s;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int j = 0; j < kRadix; ++j) {
    int e = skew(t * kRadix + j);
    int c = cell[e];
    cell[e] = run;
    run += c;
  }
  __syncthreads();
  if (t < kRadix) digit_start[t] = cell[skew(t * kThreads)];
  __syncthreads();

  // Each thread's cells become the output position of its next key of
  // each digit: the block's global offset for the digit plus the keys of
  // that digit held by lower threads.
  for (int d = 0; d < kRadix; ++d)
    cell[skew(d * kThreads + t)] +=
        offsets[(long long)d * nblocks + blockIdx.x] - digit_start[d];
  for (int j = 0; j < kItems; ++j) {
    long long i = first + j;
    if (i >= n) break;
    uint64_t key = keys[i];
    int e = skew((int)digit_of(key, shift) * kThreads + t);
    int dst = cell[e]++;
    keys_out[dst] = key;
    vals_out[dst] = vals[i];
  }
}

__device__ __forceinline__ bool differs(const uint64_t* __restrict__ keys,
                                        long long n, long long i) {
  return i > 0 && i < n && keys[i] != keys[i - 1];
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

// One round's sort.  keys/vals receive the built pairs; each pass moves
// them to the other buffer pair, so the sorted pairs end in keys_alt/
// vals_alt when the number of passes, ceil(lo_bits/4) + ceil(hi_bits/4),
// is odd.  counts and offsets: 16 * ceil(n / 4096) int32 each.
extern "C" int dsm_sa_sort(const void* rank, long long n, long long k,
                           int lo_bits, int hi_bits, void* keys, void* vals,
                           void* keys_alt, void* vals_alt, void* counts,
                           void* offsets, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const int32_t*)rank, n, k, (uint64_t*)keys, (int32_t*)vals);
  int err = (int)cudaGetLastError();
  if (err) return err;
  int nblocks = (int)((n + kTile - 1) / kTile);
  uint64_t* kin = (uint64_t*)keys;
  int32_t* vin = (int32_t*)vals;
  uint64_t* kout = (uint64_t*)keys_alt;
  int32_t* vout = (int32_t*)vals_alt;
  auto pass = [&](int shift) -> int {
    digit_count_kernel<<<nblocks, kThreads, 0, s>>>(kin, n, shift, nblocks,
                                                    (int32_t*)counts);
    int e = (int)cudaGetLastError();
    if (e) return e;
    scan_kernel<<<1, kScanThreads, 0, s>>>((const int32_t*)counts,
                                          (long long)kRadix * nblocks,
                                          (int32_t*)offsets, nullptr);
    e = (int)cudaGetLastError();
    if (e) return e;
    digit_scatter_kernel<<<nblocks, kThreads, 0, s>>>(
        kin, vin, n, shift, nblocks, (const int32_t*)offsets, kout, vout);
    e = (int)cudaGetLastError();
    uint64_t* kt = kin; kin = kout; kout = kt;
    int32_t* vt = vin; vin = vout; vout = vt;
    return e;
  };
  for (int b = 0; b < lo_bits; b += kBits)
    if ((err = pass(b))) return err;
  for (int b = 0; b < hi_bits; b += kBits)
    if ((err = pass(32 + b))) return err;
  return 0;
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
