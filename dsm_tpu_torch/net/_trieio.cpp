// Native trie-stream codec: the byte-crunching hot loop of the interop
// server/client (dsm_tpu_torch/net, a copy of dsm_tpu/net's).  Implements
// the reference wire protocol (SURVEY.md §5.8; varints per
// ClientSocket.h:20-39 / ServerSocket.h:45-71, node framing per
// EnumerateQuery.cpp:207-221 / TrieReader.h:50-106) as a batch
// parser/encoder over whole buffers — one C call per socket chunk instead
// of one Python bytecode dance per byte.
//
// Build: g++ -O3 -shared -fPIC -o _trieio.so _trieio.cpp  (net/native.py
// compiles on demand into build/net and falls back to the pure-Python
// codec in wire.py).
//
// extern "C" ctypes API; no Python headers needed.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

struct TrieState {
  uint64_t depth;
  uint64_t n;        // '(' opens seen (TrieReader's node counter)
  int32_t err;       // 0 ok; 1 bad byte; 2 checksum mismatch
  char errmsg[256];
};

static inline bool is_dna(uint8_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'N';
}
static inline bool is_left(uint8_t c) {
  return c == '0' || c == 'N' || c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// ServerSocket::getulong.  Returns next position, or -1 if incomplete.
static inline int64_t get_varint(const uint8_t *buf, int64_t pos, int64_t len,
                                 uint64_t *out) {
  if (pos >= len) return -1;
  uint8_t c = buf[pos];
  if (c >= 0x80) {
    *out = (uint64_t)(c ^ 0x80);
    return pos + 1;
  }
  if (pos + 1 + (int64_t)c > len) return -1;
  uint64_t u = 0;
  for (uint8_t i = 0; i < c; ++i) u |= ((uint64_t)buf[pos + 1 + i]) << (8 * i);
  *out = u;
  return pos + 1 + c;
}

// Parse complete events from buf[0..len).  Events: types[i] 0=open
// (syms[i]=dna byte) / 1=close (syms[i]=leftchar, freqs[i]=freq).
// Returns the number of events emitted; *consumed = bytes consumed
// (callers keep the unconsumed tail for the next call).  On malformed
// input sets st->err and stops (consumed points at the bad event).
int64_t trie_parse(const uint8_t *buf, int64_t len, TrieState *st,
                   uint8_t *types, uint8_t *syms, uint64_t *freqs,
                   int64_t max_events, int64_t *consumed) {
  int64_t pos = 0, nev = 0;
  uint64_t depth = st->depth, n = st->n;
  while (pos < len && nev < max_events) {
    int64_t start = pos;
    uint8_t b = buf[pos];
    if (b == '(') {
      if (pos + 2 > len) break;
      uint8_t sym = buf[pos + 1];
      if (!is_dna(sym)) {
        st->err = 1;
        snprintf(st->errmsg, sizeof st->errmsg,
                 "expecting dna byte but got %c", sym);
        break;
      }
      types[nev] = 0;
      syms[nev] = sym;
      freqs[nev] = 0;
      ++nev;
      ++depth;
      ++n;
      pos += 2;
      continue;
    }
    if (depth == 0) {
      st->err = 1;
      snprintf(st->errmsg, sizeof st->errmsg,
               "expecting ( byte but got %c", b);
      break;
    }
    uint64_t freq = 0, checksum = 0;
    int64_t p = get_varint(buf, pos, len, &freq);
    if (p < 0) break;
    if (depth <= 6) {
      if (p >= len) { pos = start; break; }
      if (buf[p] != 'R') {
        st->err = 1;
        snprintf(st->errmsg, sizeof st->errmsg,
                 "expecting R byte but got %c", buf[p]);
        break;
      }
      p = get_varint(buf, p + 1, len, &checksum);
      if (p < 0) { pos = start; break; }
      if (checksum != n) {
        st->err = 2;
        snprintf(st->errmsg, sizeof st->errmsg,
                 "total number traversed = %llu but checksum was %llu",
                 (unsigned long long)n, (unsigned long long)checksum);
        break;
      }
    }
    if (p + 2 > len) { pos = start; break; }
    uint8_t leftchar = buf[p];
    if (!is_left(leftchar)) {
      st->err = 1;
      snprintf(st->errmsg, sizeof st->errmsg,
               "invalid leftchar byte %c", leftchar);
      break;
    }
    if (buf[p + 1] != ')') {
      st->err = 1;
      snprintf(st->errmsg, sizeof st->errmsg,
               "expecting ) byte but got %c", buf[p + 1]);
      break;
    }
    types[nev] = 1;
    syms[nev] = leftchar;
    freqs[nev] = freq;
    ++nev;
    --depth;
    pos = p + 2;
  }
  st->depth = depth;
  st->n = n;
  *consumed = pos;
  return nev;
}

static inline int64_t put_varint(uint8_t *out, int64_t pos, uint64_t u) {
  if (u < (1u << 7)) {
    out[pos] = (uint8_t)(u | 0x80);
    return pos + 1;
  }
  uint8_t l = 0;
  uint64_t tmp = u;
  do { ++l; } while ((tmp >>= 8));
  out[pos++] = l;
  do { out[pos++] = (uint8_t)(u & 0xFF); } while ((u >>= 8));
  return pos;
}

// Serialize DFS events to wire bytes; checksums generated from the
// running open counter exactly as EnumerateQuery does (cpp:207-221).
// out must hold >= 21*n_events bytes.  Returns bytes written; updates
// *state_n / *state_depth for chunked streaming.
int64_t trie_encode(const uint8_t *types, const uint8_t *syms,
                    const uint64_t *freqs, int64_t n_events, uint8_t *out,
                    uint64_t *state_n, uint64_t *state_depth) {
  int64_t pos = 0;
  uint64_t n = *state_n, depth = *state_depth;
  for (int64_t i = 0; i < n_events; ++i) {
    if (types[i] == 0) {
      out[pos++] = '(';
      out[pos++] = syms[i];
      ++n;
      ++depth;
    } else {
      pos = put_varint(out, pos, freqs[i]);
      if (depth <= 6) {
        out[pos++] = 'R';
        pos = put_varint(out, pos, n);
      }
      out[pos++] = syms[i];
      out[pos++] = ')';
      --depth;
    }
  }
  *state_n = n;
  *state_depth = depth;
  return pos;
}

}  // extern "C"
