"""Reference .fmi (v14-v17) index file compatibility (the port's copy of
dsm_tpu/index/fmi_compat.py; both write the same bytes).

Read and write the reference's binary FM-index artifact so users can mix
fleets: `mine` loads indexes produced by the reference `builder`, and the
reference `metaenumerate` loads indexes written by `build --format fmi`.

Layout (FMIndex::save, FMIndex.cpp:155-217; 64-bit build: ulong = u64):

  u8    version (17; loads 14/15/16 with field-width migrations,
                 FMIndex.cpp:264-291)
  u64   n
  u32   samplerate
  u64   C[256]            (v14: u32[256])
  u64   bwtEndPos         (0 in builder-produced files — only the unused
                           outputReads/maketables paths set it,
                           FMIndex.cpp:95,440)
  HuffWT (HuffWT::save, HuffWT.cpp:194-207):
    256 x TCodeEntry { u64 count (v<16: u32); u32 bits; u32 code }
    preorder tree: { u8 leaf; u8 ch;
                     if !leaf: BitRank; left subtree; right subtree }
    BitRank (BitRank.cpp:154-199): { u64 nbits; u64 integers; u32 b; u32 s;
                     u64 data[integers]; u64 Rs[nbits/s+1]; u8 Rb[nbits/b+1] }
                     (bits are LSB-first within words, Tools.h:49-76)
  u32   numberOfTexts
  u64   maxTextLength
  u8    name flag (+ TextStorage if set — never set by the builder,
                   FMIndex.cpp:102-116 "FIXME disabled")
  u8    textStorage flag (+ TextStorage if set — mining never stores text)
  u8    colorCoded
  u32   rotationLength

Loading reconstructs the BWT from the wavelet tree bottom-up — leaves
contribute constant runs, each internal node interleaves its children by
its bit vector — one vectorized pass per node, O(n log sigma) total.
Writing builds a Huffman code (any deterministic prefix-free code is
valid: the reference loader takes both the codetable and the tree
explicitly from the file and never re-derives them) and emits the tree
with the same top-down bit-partition the HuffWT constructor applies
(HuffWT.cpp:5-56).
"""

from __future__ import annotations

import heapq
import os
import struct

import numpy as np

from . import alphabet
from .fmindex import FMIndex
from ..ops.rank import OccTable

FMI_EXTENSION = ".fmi"
VERSION = 17
_W = 64  # reference is built 64-bit (ulong = 8 bytes)


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def array(self, dtype, count: int) -> np.ndarray:
        arr = np.frombuffer(self.data, dtype=dtype, count=count,
                            offset=self.pos)
        self.pos += arr.nbytes
        return arr


def _read_bitrank(r: _Reader) -> np.ndarray:
    """-> bool array of the stored bits (length nbits)."""
    nbits = r.take("Q")
    integers = r.take("Q")
    b, s = r.take("II")
    if b != _W:
        raise ValueError(f".fmi BitRank word size {b} != 64 "
                         "(32-bit reference build not supported)")
    data = r.array(np.uint64, integers)
    r.array(np.uint64, nbits // s + 1)   # Rs — recomputed on our side
    r.array(np.uint8, nbits // b + 1)    # Rb
    bits = np.unpackbits(data.view(np.uint8), bitorder="little")
    return bits[:nbits].astype(bool)


def _read_tree(r: _Reader) -> tuple:
    """-> nested ('leaf', ch) | ('node', bits, left, right)."""
    leaf = r.take("B")
    ch = r.take("B")
    if leaf:
        return ("leaf", ch)
    bits = _read_bitrank(r)
    left = _read_tree(r)
    right = _read_tree(r)
    return ("node", bits, left, right)


def _decode_tree(node, m: int) -> np.ndarray:
    """Wavelet tree -> symbol sequence, bottom-up interleave."""
    if node[0] == "leaf":
        return np.full(m, node[1], dtype=np.uint8)
    bits = node[1]
    if bits.shape[0] != m:
        raise ValueError(".fmi wavelet node length mismatch")
    k = int(bits.sum())
    left = _decode_tree(node[2], m - k)
    right = _decode_tree(node[3], k)
    out = np.empty(m, dtype=np.uint8)
    out[~bits] = left
    out[bits] = right
    return out


def _read_blockarray(r: _Reader) -> np.ndarray:
    """BlockArray::Load (BlockArray.h:68-80): n, blockLength, then n
    blockLength-bit fields packed LSB-first into u64 words
    (Tools::GetField, Tools.h:61-76)."""
    n = r.take("Q")
    bl = r.take("Q")
    words = r.array(np.uint64, n * bl // _W + 1)
    if n == 0 or bl == 0:
        return np.zeros(int(n), dtype=np.int64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    mat = bits[: n * bl].reshape(int(n), int(bl))
    weights = (np.uint64(1) << np.arange(bl, dtype=np.uint64))
    return (mat.astype(np.uint64) * weights).sum(axis=1).astype(np.int64)


def load_sa(path: str):
    """Read a reference .sa side file (FMIndex::saveSamples,
    FMIndex.cpp:125-147) into our SASamples.

    Layout: BitRank `sampled` (marks sampled BWT rows; terminator rows
    are never sampled, FMIndex.cpp:624), BlockArray `suffixes` (offset
    from text start per sampled row, in row-rank order), BlockArray
    `suffixDocId`, BlockArray `textLength`, ArrayDoc (a BlockArray
    mapping end-marker rank -> doc id, used when a locate walk reaches
    a '\0' BWT entry: FMIndex.h:117-123)."""
    from .fmindex import SASamples

    with open(path, "rb") as f:
        r = _Reader(f.read())
    sampled = _read_bitrank(r)
    suffixes = _read_blockarray(r)
    suffix_doc = _read_blockarray(r)
    text_length = _read_blockarray(r)
    endmarker_doc = _read_blockarray(r)
    rows = np.flatnonzero(sampled).astype(np.int64)
    if rows.shape[0] != suffixes.shape[0]:
        raise ValueError(f"{path}: sampled-row/suffix count mismatch")
    text_starts = np.concatenate(
        [[0], np.cumsum(text_length + 1)[:-1]]).astype(np.int64)
    return SASamples(rows=rows, vals=text_starts[suffix_doc] + suffixes,
                     text_starts=text_starts, endmarker_doc=endmarker_doc)


def load_fmi(path: str) -> FMIndex:
    """Read a reference .fmi into our flat occ-table index.  A sibling
    reference .sa side file (base.sa next to base.fmi) is picked up
    automatically — the reference requires an explicit samplefile
    argument instead (FMIndex.cpp:255-262)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    ver = r.take("B")
    if ver not in (14, 15, 16, 17):
        raise ValueError(f"{path}: invalid .fmi save file version {ver}")
    n = r.take("Q")
    samplerate = r.take("I")
    C = (r.array(np.uint32, 256) if ver == 14
         else r.array(np.uint64, 256)).astype(np.int64)
    r.take("Q")  # bwtEndPos
    # codetable: only the tree is needed to reconstruct the BWT
    for _ in range(256):
        if ver < 16:
            r.take("I")
        else:
            r.take("Q")
        r.take("II")
    tree = _read_tree(r)
    bwt_bytes = _decode_tree(tree, n)
    number_of_texts = r.take("I")
    max_text_length = r.take("Q")
    if r.take("B"):
        raise NotImplementedError(f"{path}: .fmi with name storage")
    if r.take("B"):
        raise NotImplementedError(f"{path}: .fmi with plain-text storage")
    color_coded = r.take("B")
    if color_coded:
        raise ValueError(f"{path}: color-coded indexes are not minable "
                         "(metaenumerate.cpp:243-248)")
    r.take("I")  # rotationLength

    codes = alphabet.encode(bwt_bytes)
    table = OccTable.build(codes)
    # cross-check the stored 256-wide C table against ours
    for ch, code in ((0, 0), (0x2D, 1), (0x41, 2), (0x43, 3), (0x47, 4),
                     (0x4E, 5), (0x54, 6)):
        nxt = C[ch + 1] if ch < 255 else n
        # C is cumulative; count of ch = C[ch+1] - C[ch]
        if int(nxt - C[ch]) != int(table.counts[code]):
            raise ValueError(f"{path}: C table mismatch for byte {ch}")
    samples = None
    base = path[: -len(FMI_EXTENSION)] if path.endswith(FMI_EXTENSION) else path
    for sa_path in (base + ".sa", path + ".sa"):
        if os.path.exists(sa_path):
            samples = load_sa(sa_path)
            break
    return FMIndex(
        n=int(n), table=table, number_of_texts=int(number_of_texts),
        max_text_length=int(max_text_length), samplerate=int(samplerate),
        names=[], sa_samples=samples)


# ------------------------------------------------------------------ write --

def _huffman_codes(counts: np.ndarray) -> dict[int, tuple[int, int]]:
    """byte -> (code, bits), codes read LSB-first from the root
    (node::maketable convention, HuffWT.cpp:150-166: bit at position
    `depth` selects the child at tree level `depth`)."""
    heap = []
    seq = 0
    for byte in range(256):
        if counts[byte]:
            heap.append((int(counts[byte]), seq, ("leaf", byte)))
            seq += 1
    heapq.heapify(heap)
    if len(heap) == 1:
        return {heap[0][2][1]: (0, 0)}
    while len(heap) > 1:
        c0 = heapq.heappop(heap)
        c1 = heapq.heappop(heap)
        heapq.heappush(heap, (c0[0] + c1[0], seq, ("node", c0[2], c1[2])))
        seq += 1
    out: dict[int, tuple[int, int]] = {}

    def walk(node, code, depth):
        if node[0] == "leaf":
            out[node[1]] = (code, depth)
            return
        walk(node[1], code, depth + 1)              # child0: bit 0
        walk(node[2], code | (1 << depth), depth + 1)  # child1: bit 1
    walk(heap[0][2], 0, 0)
    return out


def _write_bitrank(out: list[bytes], bits: np.ndarray) -> None:
    nbits = bits.shape[0]
    integers = nbits // _W + 1
    packed = np.packbits(bits, bitorder="little")
    data = np.zeros(integers, dtype=np.uint64)
    data.view(np.uint8)[: packed.shape[0]] = packed
    words = data  # popcounts per word
    pc = np.zeros(integers, dtype=np.uint64)
    v = words.copy()
    for _ in range(8):  # byte-wise popcount via table-free sum
        pc += _POP8[(v & np.uint64(0xFF)).astype(np.int64)]
        v >>= np.uint64(8)
    s_words = 4  # superFactor on 64-bit: 256-bit superblocks
    num_sblock = nbits // (_W * s_words)
    num_block = nbits // _W
    Rs = np.zeros(num_sblock + 1, dtype=np.uint64)
    wsum = np.zeros(integers + s_words, dtype=np.uint64)
    np.cumsum(pc, out=wsum[1: integers + 1])
    wsum[integers + 1:] = wsum[integers]
    for j in range(1, num_sblock + 1):
        Rs[j] = wsum[min(j * s_words, integers)]
    Rb = np.zeros(num_block + 1, dtype=np.uint8)
    k = np.arange(1, num_block + 1)
    sb_start = (k // s_words) * s_words
    Rb[1:] = (wsum[np.minimum(sb_start + (k % s_words), integers)]
              - wsum[np.minimum(sb_start, integers)]).astype(np.uint8)
    out.append(struct.pack("<QQII", nbits, integers, _W, _W * s_words))
    out.append(data.tobytes())
    out.append(Rs.tobytes())
    out.append(Rb.tobytes())


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint64)


def _write_tree(out: list[bytes], seq: np.ndarray,
                codes: dict[int, tuple[int, int]], level: int,
                codearr: np.ndarray | None = None) -> None:
    """HuffWT constructor's top-down partition (HuffWT.cpp:5-56): split
    `seq` by code bit `level`; emit leaf when the split is trivial."""
    ch = int(seq[0])
    if codearr is None:
        codearr = np.array([codes.get(b, (0, 0))[0] for b in range(256)],
                           dtype=np.uint64)
    bits = (codearr[seq] >> np.uint64(level)) & np.uint64(1)
    bits = bits.astype(bool)
    k = int(bits.sum())
    if k == 0 or k == seq.shape[0]:
        out.append(struct.pack("<BB", 1, ch))
        return
    out.append(struct.pack("<BB", 0, ch))
    _write_bitrank(out, bits)
    _write_tree(out, seq[~bits], codes, level + 1, codearr)
    _write_tree(out, seq[bits], codes, level + 1, codearr)


def save_fmi(index: FMIndex, path: str) -> str:
    """Write a v17 .fmi loadable by the reference binaries."""
    if not path.endswith(FMI_EXTENSION):
        path += FMI_EXTENSION
    flat = index.table.blocks.reshape(-1)[: index.n]
    bwt_bytes = alphabet.CODE_TO_CHAR[flat.astype(np.int64)]

    counts = np.zeros(256, dtype=np.int64)
    for code in range(7):
        counts[alphabet.CODE_TO_CHAR[code]] = index.table.counts[code]
    C = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.uint64)
    codes = _huffman_codes(counts)

    out: list[bytes] = [struct.pack("<BQI", VERSION, index.n,
                                    index.samplerate)]
    out.append(C.tobytes())
    out.append(struct.pack("<Q", 0))  # bwtEndPos (builder leaves it 0)
    for byte in range(256):
        code, bits = codes.get(byte, (0, 0))
        out.append(struct.pack("<QII", int(counts[byte]), bits, code))
    _write_tree(out, bwt_bytes, codes, 0)
    out.append(struct.pack("<IQ", index.number_of_texts,
                           index.max_text_length))
    out.append(struct.pack("<BBBI", 0, 0, 0, 0))  # name/text/color/rotation
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path
