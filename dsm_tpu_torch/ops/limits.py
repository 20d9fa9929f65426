"""The sizes that the kernels' 32-bit formats hold, and the refusal that
the wrappers make beyond them, before anything is launched.

Every kernel of the port computes its global offsets (a row times its
width, a column times the pair count) in 64 bits.  What stays 32-bit is
the data: pair positions, node starts and child ids are int32, a history
entry is parent_row * 4 + symbol in an int32, and a look-back status word
carries a 32-bit running total.  A wrapper given a size past one of these
raises ValueError naming it; no kernel wraps a count silently.  Both the
kernel and the plain version refuse, on every device: the plain version
writes the same int32 formats.
"""

from __future__ import annotations

INT32_MAX = 2**31 - 1
# a level's pairs, kept lanes and children: int32 positions, node starts
# and child ids, and the stats kernels step a block past a position
MAX_PAIRS = 2**31 - 2**16
# a level's nodes: each child's history entry is parent_row * 4 + symbol
MAX_NODES = 2**29
# the compaction's look-back words carry the kept rows' total in 32 bits
MAX_COMPACT_ROWS = 2**32 - 1
# a compaction tile's 4,096 rows of C words are counted in an int
MAX_COMPACT_COLS = 2**31 // 4096 - 1
# the decode kernel's tile of 512 rows of maxj symbols is counted in an int
MAX_DECODE_LEVELS = 2**31 // 512 - 1
# a gather tile's 1,024 rows of C words are counted in an int
MAX_GATHER_COLS = 2**31 // 1024 - 1


def refuse_past(who: str, what: str, value: int, limit: int,
                why: str) -> None:
    """Raise ValueError when `value` is past `limit`."""
    if value > limit:
        raise ValueError(f"{who}: {what} {value:,} is past the limit "
                         f"{limit:,} ({why})")
