// Per-node segment statistics and output gates of one trie level.
//
// Replaces the stats block of dsm_tpu/mining/engine_device.py _level_single
// (the (6+nwin, B) cumsum + forward cummax + reverse cummin segment
// broadcasts, and the int32 fixed-point entropy windows _nln_windows_w).
// Those existed because the TPU has no int64 and no f64; here one thread
// per node walks its contiguous pairs [nb[n], nb[n+1]) (at most S <= 512)
// and sums exactly: the int64 frequency sum, the f64 sum of
// (f+1)*log(f+1)/log(2) in ascending pair (= sample) order, the per-symbol
// counts of active children and the number of active readers.
//
// Outputs per node: flags (bit 0 present, bit 1 counts for the entropy
// min/max, bit 2 gated for output, bits 4-7 the existing child symbols)
// and the f64 entropy; per pair: the node's output gate.  The gate is a
// prefilter with a margin on the entropy window, as on the TPU; the host
// drain re-gates in f64 with the reference's expression shapes.
//
// What bounds it on an H100: bytes.  Per pair it reads 4 + 1 bytes and
// writes 1; per node 8 + 8 + 4 bytes.  Neighbouring threads walk
// neighbouring ranges, so the reads are close to coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Gates {
  int depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask;
  double emin_lo, emax_hi;  // emin - margin, emax + margin
};

__global__ void segstats_kernel(const int32_t* __restrict__ nb,
                                const int32_t* __restrict__ freq,
                                const uint8_t* __restrict__ cact,
                                long long n_nodes, Gates g,
                                int32_t* __restrict__ flags,
                                double* __restrict__ ent,
                                uint8_t* __restrict__ pair_out) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const double kLog2 = 0.69314718055994530942;
  int s = nb[n], e = nb[n + 1];
  long long sumf = 0;
  double sumnln = 0.0;
  int cnt[4] = {0, 0, 0, 0};
  int nact = 0;
  for (int p = s; p < e; ++p) {
    int f = freq[p];
    if (f > 0) {
      ++nact;
      sumf += f;
      double f1 = (double)f + 1.0;
      sumnln += (f1 * log(f1)) / kLog2;
    }
    unsigned b = cact[p];
#pragma unroll
    for (int c = 0; c < 4; ++c) cnt[c] += (b >> c) & 1u;
  }
  int exists = 0, numchildren = 0, sum_ex = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (cnt[c] > 0 && ((g.sym_mask >> c) & 1)) {
      exists |= 1 << c;
      ++numchildren;
      sum_ex += cnt[c];
    }
  }
  bool single_full = numchildren == 1 && sum_ex == nact;
  double sum_n = (double)((long long)g.s_total + sumf);
  double h = log(sum_n) / kLog2 - sumnln / sum_n;
  bool present = nact > 0 && g.depth >= 1;
  bool egate = !g.use_egate || (h >= g.emin_lo && h <= g.emax_hi);
  bool gated = present && g.depth >= g.mindepth && nact >= g.pmin &&
               (g.pmax == 0 || nact <= g.pmax) && egate && !single_full;
  bool stat = present && !(nact == 1 && g.pmin > 1);
  flags[n] = (int)present | ((int)stat << 1) | ((int)gated << 2) |
             (exists << 4);
  ent[n] = h;
  for (int p = s; p < e; ++p) pair_out[p] = (uint8_t)gated;
}

}  // namespace

extern "C" int dsm_segstats(const void* nb, const void* freq, const void* cact,
                            long long n_nodes, int depth, int s_total,
                            int mindepth, int pmin, int pmax, int use_egate,
                            int sym_mask, double emin_lo, double emax_hi,
                            void* flags, void* ent, void* pair_out,
                            void* stream) {
  Gates g{depth, s_total, mindepth, pmin, pmax, use_egate, sym_mask,
          emin_lo, emax_hi};
  const int threads = 256;
  long long blocks = (n_nodes + threads - 1) / threads;
  segstats_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nb, (const int32_t*)freq, (const uint8_t*)cact, n_nodes,
      g, (int32_t*)flags, (double*)ent, (uint8_t*)pair_out);
  return (int)cudaGetLastError();
}
