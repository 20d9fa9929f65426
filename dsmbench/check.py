"""The comparison that decides a run's `correct`.

Every job that the window ran is held against the plain reference's
answer for its prefix (reference.py), and each number below against the
limit that the cell's file gives it (key `limits`):

  failed_jobs   jobs that raised instead of answering
  paths_off     jobs whose path count differs
  lines_off     lines that differ in path or in `id:occs` (the symmetric
                difference of the two lists, or 1 where only the order
                differs), summed over the jobs
  counters_off  jobs whose line count, occurrence count or frequency
                histogram differs
  entropy_gap   the widest gap between a line's f64 entropy and the
                reference's, over the lines whose paths agree
  range_gap     the widest gap in the smallest or largest entropy
"""

from __future__ import annotations

from collections import Counter

import numpy as np

NAMES = ("failed_jobs", "paths_off", "lines_off", "counters_off",
         "entropy_gap", "range_gap")


def _lines_off(got, want) -> int:
    a = [(p, tuple(map(tuple, occs))) for p, _e, occs in got]
    b = [(p, tuple(map(tuple, occs))) for p, _e, occs in want]
    if a == b:
        return 0
    diff = Counter(a)
    diff.subtract(Counter(b))
    return sum(abs(v) for v in diff.values()) or 1


def _gap(a: float, b: float) -> float:
    """|a - b|, infinite where either is not a finite number."""
    g = abs(float(a) - float(b))
    return g if np.isfinite(g) else float("inf")


def _entropy_gap(got, want) -> float:
    ref = {p: e for p, e, _o in want}
    return max((_gap(e, ref[p]) for p, e, _o in got if p in ref),
               default=0.0)


def compare(answers, expected: dict, failed: int) -> dict:
    """answers: the jobs' (prefix, output) pairs (outputs with `lines`,
    `total_paths`, `total_output`, `total_occs`, `freq_histogram`,
    `smallest_entropy`, `largest_entropy`); expected: prefix -> the
    reference's output; failed: jobs that raised.  -> {name: value}."""
    got = dict.fromkeys(NAMES, 0)
    got["failed_jobs"] = failed
    got["entropy_gap"] = got["range_gap"] = 0.0
    for prefix, out in answers:
        ref = expected[prefix]
        got["paths_off"] += int(out.total_paths != ref.total_paths)
        got["lines_off"] += _lines_off(out.lines, ref.lines)
        got["counters_off"] += int(
            out.total_output != ref.total_output
            or out.total_occs != ref.total_occs
            or not np.array_equal(out.freq_histogram, ref.freq_histogram))
        got["entropy_gap"] = max(got["entropy_gap"],
                                 _entropy_gap(out.lines, ref.lines))
        got["range_gap"] = max(
            got["range_gap"],
            _gap(out.smallest_entropy, ref.smallest_entropy),
            _gap(out.largest_entropy, ref.largest_entropy))
    return got


def judge(got: dict, limits: dict) -> tuple[bool, dict]:
    """-> (whether every number is within its limit, {name: [value,
    limit]})."""
    table = {k: [got[k], limits[k]] for k in NAMES}
    ok = all(v <= lim for v, lim in table.values())
    return ok, table
