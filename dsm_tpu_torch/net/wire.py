"""Reference wire protocol: varints + pre-order trie streams.

The reference's client/server exchange (SURVEY.md §5.8) is a TCP byte
stream per (sample, server) pair:

  session header   'S' <libname bytes> '.'        (metaenumerate.cpp:286-287)
  trie stream      per node, pre-order:
                   '(' <base in ACGT>
                       ... children ...
                   <freq : varint>
                   ['R' <checksum : varint>]      iff node depth <= 6
                   <leftchar in {0, N, A, C, G, T}>
                   ')'
                   (EnumerateQuery.cpp:207-221, TrieReader.h:50-81)

Varint (ClientSocket.h:20-39 / ServerSocket.h:45-71): a value < 128 is
one byte with the MSB set; otherwise a length byte L followed by L
little-endian payload bytes.

The checksum is the client's cumulative count of '(' opens at the moment
the node closes; the server validates it against its own readChild count
(TrieReader.h:84-106) — a rolling distributed integrity check.

This module is the pure-Python codec (the semantics reference); the
byte-crunching C++ twin lives in _trieio.cpp via net/native.py and is
differentially tested against this one.  Both are the port's copies of
dsm_tpu/net's (host code: no device runs here).
"""

from __future__ import annotations

from dataclasses import dataclass, field

OPEN = 0
CLOSE = 1

DNA_BYTES = frozenset(b"ACGTN")
LEFT_BYTES = frozenset(b"0NACGT")
CHECK_DEPTH = 6  # 'R' checksums on nodes at depth <= 6 (EnumerateQuery.cpp:213)


def put_varint(out: bytearray, u: int) -> None:
    """ClientSocket::putulong (ClientSocket.h:20-39)."""
    if u < (1 << 7):
        out.append((u & 0xFF) | 0x80)
        return
    length = 0
    tmp = u
    while True:
        length += 1
        tmp >>= 8
        if not tmp:
            break
    out.append(length)
    while True:
        out.append(u & 0xFF)
        u >>= 8
        if not u:
            break


def encode_header(libname: str | bytes) -> bytes:
    if isinstance(libname, str):
        libname = libname.encode()
    return b"S" + libname + b"."


class StreamError(ValueError):
    pass


@dataclass
class TrieParser:
    """Incremental parser of one trie stream into (type, sym, freq) events.

    Mirrors TrieReader's byte validation (TrieReader.h:50-106): '(' must
    be followed by a DNA byte, closes must end with ')', and every
    depth<=6 checksum is verified against the running open count.
    State persists across feed() calls, so arbitrary chunking works.
    """

    depth: int = 0
    n: int = 0              # '(' opens seen (TrieReader's node counter)
    _buf: bytearray = field(default_factory=bytearray)

    def feed(self, data: bytes, max_events: int | None = None):
        """-> list of events: (OPEN, sym_byte) | (CLOSE, freq, leftchar)."""
        self._buf.extend(data)
        events = []
        pos = 0
        buf = self._buf
        blen = len(buf)
        while pos < blen and (max_events is None or len(events) < max_events):
            start = pos
            if buf[pos] == 0x28:  # '('
                if pos + 2 > blen:
                    break
                sym = buf[pos + 1]
                if sym not in DNA_BYTES:
                    raise StreamError(
                        f"expecting dna byte but got {chr(sym)!r}")
                events.append((OPEN, sym))
                self.depth += 1
                self.n += 1
                pos += 2
                continue
            if self.depth == 0:
                raise StreamError(
                    f"expecting ( byte but got {chr(buf[pos])!r}")
            # close event: varint freq ['R' varint] leftchar ')'
            freq, pos2 = self._varint(buf, pos, blen)
            if pos2 < 0:
                break
            pos = pos2
            if self.depth <= CHECK_DEPTH:
                if pos >= blen:
                    pos = start
                    break
                if buf[pos] != 0x52:  # 'R'
                    raise StreamError(
                        f"expecting R byte but got {chr(buf[pos])!r}")
                checksum, pos2 = self._varint(buf, pos + 1, blen)
                if pos2 < 0:
                    pos = start
                    break
                pos = pos2
                if checksum != self.n:
                    raise StreamError(
                        f"total number traversed = {self.n} but checksum "
                        f"was {checksum}")
            if pos + 2 > blen:
                pos = start
                break
            leftchar = buf[pos]
            if leftchar not in LEFT_BYTES:
                raise StreamError(
                    f"invalid leftchar byte {chr(leftchar)!r}")
            if buf[pos + 1] != 0x29:  # ')'
                raise StreamError(
                    f"expecting ) byte but got {chr(buf[pos + 1])!r}")
            events.append((CLOSE, freq, leftchar))
            self.depth -= 1
            pos += 2
        del self._buf[:pos]
        return events

    @staticmethod
    def _varint(buf, pos: int, blen: int):
        """ServerSocket::getulong (ServerSocket.h:45-71).
        -> (value, next_pos) or (0, -1) if incomplete."""
        if pos >= blen:
            return 0, -1
        c = buf[pos]
        if c >= 0x80:
            return c ^ 0x80, pos + 1
        if pos + 1 + c > blen:
            return 0, -1
        u = 0
        for i in range(c):
            u |= buf[pos + 1 + i] << (8 * i)
        return u, pos + 1 + c

    @property
    def pending(self) -> int:
        return len(self._buf)


def encode_events(types, syms, freqs, start_n: int = 0,
                  start_depth: int = 0) -> tuple[bytes, int, int]:
    """Serialize DFS events to wire bytes (pure-Python twin of the C++
    encoder).  types[i]: OPEN/CLOSE; syms[i]: dna byte for opens,
    leftchar byte for closes; freqs[i]: close frequency.  Checksums are
    generated from the running open counter exactly as the client does
    (EnumerateQuery.cpp:207-221).  Returns (bytes, n, depth)."""
    out = bytearray()
    n, depth = start_n, start_depth
    for i in range(len(types)):
        if types[i] == OPEN:
            out.append(0x28)
            out.append(syms[i])
            n += 1
            depth += 1
        else:
            put_varint(out, int(freqs[i]))
            if depth <= CHECK_DEPTH:
                out.append(0x52)
                put_varint(out, n)
            out.append(syms[i])
            out.append(0x29)
            depth -= 1
    return bytes(out), n, depth
