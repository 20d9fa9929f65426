"""The port's path decode (dsm_tpu_torch/ops/decode.py, K6) against
dsm_tpu's `_jitted_decode`, and what the mining episode builds on it.

`decode` (CPU tensors: its plain version) and `_jitted_decode` (jitted on
the CPU) walk the same random parent-pointer history from the same rows,
and a trie-shaped one (parents in (parent, symbol) order) from rows
sorted within each level as a drain stages them:
equal base rows, and equal symbols up to each row's relative level (the
port's are zero past it).  The episode's path assembly (the device
segment, a pulled PathHistory segment and a resumed snapshot's base
paths) is held against a plain Python walk, its frontier code matrix
against dsm_tpu's `_pack_paths` of the decoded paths (the snapshot's
`__paths`), and the halt's prefix match against `bytes.startswith`.
Exact throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.index.alphabet import EXT_CHARS
from dsm_tpu.mining import engine_device as jed
from dsm_tpu.mining.checkpoint import _pack_paths
from dsm_tpu_torch.mining import engine_device as ted
from dsm_tpu_torch.ops.decode import decode, decode_plain


def _history(rng, widths):
    """Random parent pointers: level k >= 1 holds widths[k] nodes, each
    with a parent among the widths[k-1] nodes of level k-1 and a symbol.
    -> (hist (sum widths[1:],) int32, lvl_off (levels,) int32)."""
    parts, offs, off = [], [], 0
    for k in range(1, len(widths)):
        parent = rng.integers(0, widths[k - 1], size=widths[k])
        parts.append((parent * 4 + rng.integers(0, 4, size=widths[k]))
                     .astype(np.int32))
        offs.append(off)
        off += widths[k]
    return np.concatenate(parts), np.asarray(offs, dtype=np.int32)


def _trie_history(rng, levels, width):
    """A trie-shaped history: the base holds `width` nodes and each node
    has 0-4 children (1 on average) with distinct ascending symbols,
    numbered in (parent, symbol) order as the children step numbers them,
    so each level's parents are non-decreasing.  -> (hist, lvl_off,
    widths)."""
    widths, parts, offs, off = [width], [], [], 0
    for _ in range(levels):
        kids = rng.choice(5, size=widths[-1], p=[0.5, 0.2, 0.15, 0.1, 0.05])
        kids[0] = max(kids[0], 1)                 # no level is empty
        parent = np.repeat(np.arange(widths[-1]), kids)
        first = np.cumsum(kids) - kids
        within = np.arange(parent.size) - first[parent]
        shift = (rng.random(widths[-1]) * (5 - kids)).astype(np.int64)
        sym = within + shift[parent]
        parts.append((parent * 4 + sym).astype(np.int32))
        offs.append(off)
        off += parent.size
        widths.append(parent.size)
    return np.concatenate(parts), np.asarray(offs, dtype=np.int32), widths


# widths per level (level 0 is the segment base), rows, their levels; the
# trie cases: (levels, base width), rows in (level, row) order, as a drain
# stages them
CASES = {
    "mixed": ([3, 7, 20, 50, 40, 90, 130, 5, 60], 400, "random"),
    "one_row": ([2, 5, 9], 1, "deepest"),
    "all_jrel0": ([6, 4], 30, "zero"),
    "one_level": ([1, 1], 12, "deepest"),
    "wide": ([50] + [700] * 30, 2000, "random"),
    "trie_maxj1": ((1, 300), 500, "sorted"),
    "trie_maxj96": ((96, 300), 3000, "sorted"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(case):
    widths, m, levels = CASES[case]
    rng = np.random.default_rng(len(widths) * 1000 + m)
    if levels == "sorted":
        hist, offs, widths = _trie_history(rng, *widths)
    else:
        hist, offs = _history(rng, widths)
    top = len(widths) - 1
    jrel = {"random": rng.integers(0, top + 1, size=m),
            "sorted": rng.integers(0, top + 1, size=m),
            "deepest": np.full(m, top),
            "zero": np.zeros(m, dtype=np.int64)}[levels].astype(np.int32)
    if levels == "sorted":
        jrel[:m // 10] = 0
        jrel[-1] = top
    rows = np.array([rng.integers(0, widths[j]) for j in jrel],
                    dtype=np.int32)
    if levels == "sorted":
        order = np.lexsort((rows, jrel))
        rows, jrel = rows[order], jrel[order]
    maxj = int(jrel.max(initial=0))
    base, syms = decode(torch.from_numpy(hist), torch.from_numpy(offs),
                        torch.from_numpy(rows), torch.from_numpy(jrel), maxj)
    assert base.dtype == torch.int32 and syms.dtype == torch.uint8
    assert syms.shape == (m, maxj)
    dcols = -(-max(maxj, 1) // 128) * 128
    jbase, jsyms = jax.device_get(jed._jitted_decode(dcols)(
        jnp.asarray(hist), jnp.asarray(offs), jnp.asarray(rows),
        jnp.asarray(jrel)))
    np.testing.assert_array_equal(base.numpy(), jbase)
    syms = syms.numpy()
    for i, j in enumerate(jrel):
        np.testing.assert_array_equal(syms[i, :j], jsyms[i, :j])
        assert not syms[i, j:].any()


def test_decode_dispatch_is_plain_on_cpu():
    rng = np.random.default_rng(3)
    hist, offs = _history(rng, [4, 9, 17, 30])
    rows = torch.from_numpy(rng.integers(0, 30, size=50).astype(np.int32))
    jrel = torch.full((50,), 3, dtype=torch.int32)
    got = decode(torch.from_numpy(hist), torch.from_numpy(offs), rows, jrel,
                 3)
    want = decode_plain(torch.from_numpy(hist), torch.from_numpy(offs), rows,
                        jrel, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _random_path(rng, n: int) -> bytes:
    return np.frombuffer(EXT_CHARS, dtype=np.uint8)[
        rng.integers(0, 4, size=n)].tobytes()


def _walk(levels, base_paths, depth, row):
    """The path of `row` at `depth`: a plain walk over per-depth entries
    down to a base path."""
    out = []
    for d in range(depth, min(levels) - 1, -1):
        e = int(levels[d][row])
        out.append(EXT_CHARS[e & 3])
        row = e >> 2
    return base_paths[row] + bytes(reversed(out))


def test_path_codes_across_segments():
    """A resumed snapshot's base paths at depth 3, one pulled segment
    (depths 4-5) and the device segment (depths 6-8)."""
    rng = np.random.default_rng(11)
    widths = {3: 10, 4: 25, 5: 40, 6: 60, 7: 33, 8: 70}
    levels = {d: (rng.integers(0, widths[d - 1], size=widths[d]) * 4
                  + rng.integers(0, 4, size=widths[d])).astype(np.int32)
              for d in range(4, 9)}
    base_paths = [_random_path(rng, 3) for _ in range(widths[3])]
    ph = jed.PathHistory(base_depth=3, base_paths=base_paths)
    ph.add_segment(3, np.concatenate([levels[4], levels[5]]),
                   np.array([widths[4], widths[5]]))
    seg = np.concatenate([levels[6], levels[7], levels[8]])
    hist = torch.zeros(seg.size + 17, dtype=torch.int32)
    hist[:seg.size] = torch.from_numpy(seg)
    st = ted.EpisodeState(
        pairs=torch.zeros((0, 6), dtype=torch.int32),
        nb=torch.zeros(widths[8] + 1, dtype=torch.int32), depth=8,
        hist=hist, hist_len=seg.size,
        lvl_off=[0, widths[6], widths[6] + widths[7]])
    depths = rng.integers(5, 9, size=200)
    rows = np.array([rng.integers(0, widths[d]) for d in depths])
    got = ted._decode_rows(st, ph, 5, rows, depths)
    assert got == [_walk(levels, base_paths, d, r)
                   for d, r in zip(depths, rows)]
    frontier = [_walk(levels, base_paths, 8, r) for r in range(widths[8])]
    np.testing.assert_array_equal(ted._frontier_codes(st, ph, 5),
                                  _pack_paths(frontier, 8))


@pytest.mark.parametrize("prefixes", [
    [b"A"], [b"", b"C"], [b"ACGTACGT"], [b"N", b"AX", b"a"],
    [b"GA", b"T", b"CCC"], [b"ACGTAC", b"G"], []])
def test_halt_match_is_startswith(prefixes):
    """Prefixes longer than the paths, with letters outside EXT_CHARS,
    empty, or none at all."""
    rng = np.random.default_rng(5)
    paths = [_random_path(rng, 6) for _ in range(600)]
    got = ted._match_prefixes(_pack_paths(paths, 6), prefixes)
    np.testing.assert_array_equal(
        got, [any(p.startswith(q) for q in prefixes) for p in paths])
