"""Spans and counters of the port's host phases, on the host's clock and,
behind one switch, on the profiler's.

A mining job keeps its spans and counters in the `profile` dict that the
episode engines fill (`mining/engine_device.mine_device` lists the keys);
work done once a process (the dense tables, the upload's packing and
copies) goes to `PROCESS`.  `span(prof, key)` adds the seconds of its
block by `time.perf_counter()` to `prof[key]` (nothing where `prof` is
None); `timed(prof, key, fn, *args)` is the same around one call, for
the level loop; `count(prof, key, n)` adds `n`.

With `annotate(True)` a span also opens
`torch.profiler.record_function("dsm." + key less its "_s")`, so that a
profiler window holds the phases beside the device's kernels on one clock
(the CLI's `DSM_TRACE=<dir>`).  It is off by default because a
`record_function` costs about 8.5 us a call even when no profiler records
(a narrow job runs a level in ~160 us), and because a harness that counts
every device event as activity would count these annotations as busy
device time.  Off, a span touches no `torch` at all.
"""

from __future__ import annotations

import time

ANNOTATE = False
# once-a-process set-up work: tables_s, pack_s, copy_s
PROCESS: dict = {}
_now = time.perf_counter


def annotate(on: bool) -> None:
    """Turn the spans' profiler annotations on or off."""
    global ANNOTATE
    ANNOTATE = bool(on)


class span:
    """`with span(prof, key):` adds the block's seconds to `prof[key]`,
    and annotates it as `dsm.<key less _s>` while `ANNOTATE` is on."""

    __slots__ = ("prof", "key", "rf", "t0")

    def __init__(self, prof: dict | None, key: str) -> None:
        self.prof, self.key, self.rf = prof, key, None

    def __enter__(self) -> "span":
        if ANNOTATE:
            import torch

            self.rf = torch.profiler.record_function(
                "dsm." + self.key.removesuffix("_s"))
            self.rf.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        dt = _now() - self.t0
        if self.prof is not None:
            self.prof[self.key] = self.prof.get(self.key, 0.0) + dt
        if self.rf is not None:
            self.rf.__exit__(*exc)


def timed(prof: dict | None, key: str, fn, *args):
    """`fn(*args)` inside `span(prof, key)` -> its result.  While
    `ANNOTATE` is off it costs a plain `perf_counter` pair: a `with` on a
    Python class costs ~0.8 us, and the level loop runs a level in as
    little as ~160 us."""
    if ANNOTATE:
        with span(prof, key):
            return fn(*args)
    t = _now()
    r = fn(*args)
    if prof is not None:
        prof[key] = prof.get(key, 0.0) + (_now() - t)
    return r


def count(prof: dict | None, key: str, n) -> None:
    """Add `n` to `prof[key]` (nothing where `prof` is None)."""
    if prof is not None:
        prof[key] = prof.get(key, 0) + n
