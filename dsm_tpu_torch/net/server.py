"""Interop server: merge reference-protocol trie streams over TCP.

The port's copy of dsm_tpu/net/server.py (host code, no device; it
imports no torch, so `python -m dsm_tpu_torch serve` binds its port soon
after it starts).

Byte-compatible replacement for `metaserver` (metaserver.cpp:488-815):
listens on a port, accepts one connection per expected sample name, then
lazily merges the d trie streams in lexicographic DFS order, computing
per-substring cross-sample entropy and printing rows that pass every
output gate — byte-identical stdout to the reference (differentially
tested against real metaenumerate clients in tests/test_interop.py).

The recursive traverse (metaserver.cpp:269-486) is implemented
ITERATIVELY (an explicit frame stack) so trie depth is unbounded, and
reader sets are GnuHashSet (mining/gnuorder.py) — an iteration-order-
exact model of the reference's libstdc++ unordered_set — so both the
entropy float accumulation order and the printed id:occ order match the
reference byte for byte.  Byte parsing itself runs in the native codec
(net/_trieio.cpp), one C call per socket chunk.

Intentional divergence: the reference's single-active-reader fast path
skips the depth<=6 checksum bytes and crashes on streams that contain
them ("FIXME this should not occur", metaserver.cpp:211-226); our parser
always consumes and validates checksums, so those topologies work here.
Every stdout byte is unaffected (the fast path never prints when
pmin > 1, and with pmin == 1 the normal path subsumes it).
"""

from __future__ import annotations

import math
import socket
import sys
import time

from ..mining.config import MiningConfig
from ..mining.gnuorder import GnuHashSet
from .native import make_parser
from .wire import CLOSE, OPEN, StreamError

LOG2 = math.log(2.0)
MAX_READERS = 273       # metaserver.cpp:19
ITODNA = b"ACGT"
DNATOI = {65: 0, 67: 1, 71: 2, 84: 3}  # ACGT only (metaserver.cpp:494-499)
RECV_CHUNK = 8 * 1024   # ServerSocket::BUFFER_SIZE (ServerSocket.h:104)


class SocketTrieReader:
    """TrieReader over a connected socket (TrieReader.h:24-235): lazy
    chunked recv, native batch parse, event-queue interface."""

    def __init__(self, rid: int, name: str, sock: socket.socket,
                 initial: bytes = b"") -> None:
        self.id = rid
        self.name = name
        self.sock = sock
        self.parser = make_parser()
        self.events: list = list(self.parser.feed(initial)) if initial else []
        self.eof = False
        self.occs = 0
        self.last_active = time.time()

    def _pump(self) -> None:
        while not self.events and not self.eof:
            data = self.sock.recv(RECV_CHUNK)
            if not data:
                self.eof = True
                if self.parser.pending:
                    raise StreamError(
                        f"connection closed mid-event at reader {self.name}")
                return
            try:
                self.events = list(self.parser.feed(data))
            except StreamError as e:
                raise StreamError(f"{e} at reader {self.name}") from None
            self.last_active = time.time()

    def has_child(self) -> bool:
        self._pump()
        return bool(self.events) and self.events[0][0] == OPEN

    def read_child(self) -> int:
        """-> child base as 0..3 (A..T); exits on N like the reference's
        dnatoi check (metaserver.cpp:180-187)."""
        self._pump()
        ev = self.events.pop(0)
        assert ev[0] == OPEN
        sym = ev[1]
        if sym not in DNATOI:
            raise StreamError(
                f"readChildren(): received invalid readChild byte {chr(sym)}")
        return DNATOI[sym]

    def read_close(self) -> tuple[int, int]:
        """readOccs + checkR + readClose in one: -> (freq, leftchar byte).
        Checksum was already validated stream-side by the parser."""
        self._pump()
        if not self.events:
            raise StreamError(f"unexpected EOF at reader {self.name}")
        ev = self.events.pop(0)
        if ev[0] != CLOSE:
            raise StreamError(f"expecting node close at reader {self.name}")
        self.occs = ev[1]
        return ev[1], ev[2]

    def rate(self) -> float:
        return time.time() - self.last_active

    def check_eof(self) -> bool:
        """TrieReader::checkEof (TrieReader.h:128-145): no pending input."""
        if self.events or self.parser.pending:
            return False
        if self.eof:
            return True
        self.sock.settimeout(0.25)
        try:
            data = self.sock.recv(RECV_CHUNK)
        except (TimeoutError, socket.timeout):
            return False
        finally:
            self.sock.settimeout(None)
        if not data:
            self.eof = True
            return True
        self.events = list(self.parser.feed(data))
        return False


class _Frame:
    __slots__ = ("order", "atr", "children", "nchildren")

    def __init__(self, order: list[int]) -> None:
        self.order = order          # gnu iteration order of this node's set
        self.atr = order            # readers to poll next round
        self.children: list = [None, None, None, None]
        self.nchildren = 0


class MergeServer:
    """The traverse state machine + counters (metaserver.cpp:115-160)."""

    def __init__(self, readers: list[SocketTrieReader], cfg: MiningConfig,
                 out=None, err=None, verbose: bool = False,
                 debug: bool = False, topfreq: int = 0, toptimes: int = 0,
                 outputall: bool = False):
        cfg.validate()
        self.readers = readers
        self.cfg = cfg
        self.out = out if out is not None else sys.stdout.buffer
        self.err = err if err is not None else sys.stderr
        self.verbose = verbose
        self.debug = debug
        self.outputall = outputall
        self.topfreq = topfreq
        self.toptimes = toptimes
        d = len(readers)
        self.total_paths = 0
        self.total_output = 0
        self.total_occs = 0
        self.smallest_entropy = 1000.0
        self.largest_entropy = -1000.0
        self.freqhistogram = [0] * d
        self.path = bytearray()
        self.wctime = time.time()

    # -- trie merge ---------------------------------------------------------

    def run(self) -> None:
        root = GnuHashSet()
        for i in range(len(self.readers)):  # metaserver.cpp:735-738
            root.insert(i)
        stack = [_Frame(root.order())]
        freq = [0] * len(self.readers)
        while stack:
            fr = stack[-1]
            # one readChildren round over fr.atr (metaserver.cpp:159-189)
            for r in fr.atr:
                tr = self.readers[r]
                if tr.has_child():
                    c = tr.read_child()
                    if fr.children[c] is None:
                        fr.children[c] = GnuHashSet()
                    fr.children[c].insert(r)
            ci = next((c for c in range(4) if fr.children[c]), None)
            if ci is not None:
                child_order = fr.children[ci].order()
                fr.atr = child_order
                fr.nchildren += 1
                fr.children[ci] = None  # children[i].clear()
                self.path.append(ITODNA[ci])
                self._progress(len(child_order))
                if len(child_order) == 1 and self.cfg.pmin > 1:
                    self._traverse_one(child_order[0])
                    self.path.pop()
                else:
                    stack.append(_Frame(child_order))
                continue
            # post-order close of this frame's node
            stack.pop()
            if not self.path:
                continue  # root: no occs/close on the wire
            self._emit(fr, freq)
            self.path.pop()

    def _traverse_one(self, r: int) -> None:
        """traverseOne (metaserver.cpp:211-232): single active reader with
        pmin>1 — consume the whole subtree, never output."""
        tr = self.readers[r]
        depth = 0
        while True:
            if tr.has_child():
                tr.read_child()
                depth += 1
                self.total_paths_inc()
                continue
            tr.read_close()
            if depth == 0:
                break
            depth -= 1
        self.total_paths += 1  # the entered node itself

    def total_paths_inc(self) -> None:
        self.total_paths += 1

    def _emit(self, fr: _Frame, freq: list[int]) -> None:
        """Post-order entropy + gates + print (metaserver.cpp:356-485),
        accumulating in fr.order (set-iteration) float order."""
        cfg = self.cfg
        left_char = 0
        sumN = len(self.readers)
        sumNlogN = 0.0
        for r in fr.order:
            f, lchar = self.readers[r].read_close()
            freq[r] = f
            sumN += f
            f1 = float(f + 1)
            sumNlogN += (f1 * math.log(f1)) / LOG2
            if left_char == 0:
                left_char = lchar
            elif left_char != lchar:
                left_char = 0x4E  # 'N'
        entropy = math.log(sumN) / LOG2 - sumNlogN / sumN
        self.smallest_entropy = min(self.smallest_entropy, entropy)
        self.largest_entropy = max(self.largest_entropy, entropy)

        nact = len(fr.order)
        output = True
        if len(self.path) < cfg.mindepth:
            output = False
        if cfg.pmax != 0 and nact > cfg.pmax:
            output = False
        if nact < cfg.pmin:
            output = False
        if cfg.emax > 0 and (entropy < cfg.emin or entropy > cfg.emax):
            output = False
        if fr.nchildren == 1 and nact == len(fr.atr):
            output = False  # not right branching (metaserver.cpp:416-417)
        if left_char in b"ACGT":
            output = False  # not left branching

        self.total_paths += 1
        if output:
            self.total_output += 1
            self.freqhistogram[nact - 1] += 1
            parts = [bytes(self.path), b" %f" % entropy]
            for r in fr.order:
                parts.append(b" %d:%d" % (r, freq[r]))
                self.total_occs += 1
            self.out.write(b"".join(parts) + b"\n")

    # -- diagnostics ---------------------------------------------------------

    def _progress(self, nactive: int) -> None:
        """Stall detector + histogram + status line (metaserver.cpp:271-310),
        printed while descending into shallow nodes — or at EVERY node
        under -A/--outputall ("Even more verbose (not safe)",
        metaserver.cpp:57,271)."""
        if not (self.outputall or (self.verbose and
                                   len(self.path) <= (5 + 2 * int(self.debug)))):
            return
        if self.toptimes:
            by_rate = sorted(self.readers, key=lambda t: -t.rate())
            row = []
            for i, tr in enumerate(by_rate[: self.toptimes]):
                if i > 10 and int(tr.rate()) == 0:
                    row.append("...")
                    break
                row.append(f"{tr.id}/{int(tr.rate())}ys")
            print("[ " + " ".join(row) + "]", file=self.err)
        if self.topfreq:
            h = self.freqhistogram
            row = []
            for i, v in enumerate(h):
                if i < self.topfreq or len(h) - i <= self.topfreq:
                    row.append(str(v))
                elif i == self.topfreq:
                    row.append("...")
            print("< " + " ".join(row) + " >", file=self.err)
        el = time.time() - self.wctime
        print(
            f"current path is {self.path.decode()} ({nactive} active, "
            f"{self.total_output} reported, {self.total_occs} occs, "
            f"{el:.0f} s, {el / 3600:.4g} hrs), entropies "
            f"[{self.smallest_entropy:g}, {self.largest_entropy:g}]",
            file=self.err)

    def print_stats(self) -> None:
        print(
            f"Number of paths: {self.total_paths}\n"
            f"Number of reported paths: {self.total_output}\n"
            f"Number of reported occs: {self.total_occs}\n"
            f"Smallest and largest entropies encountered: "
            f"{self.smallest_entropy:g} and {self.largest_entropy:g}",
            file=self.err)
        el = time.time() - self.wctime
        print(f"Wall-clock time: {el:.0f} seconds ({el / 3600:.4g} hours)",
              file=self.err)


def accept_readers(port: int, names: list[str], err=sys.stderr,
                   host: str = "", backlog: int = 256
                   ) -> list[SocketTrieReader]:
    """Bind + accept one connection per expected name
    (metaserver.cpp:682-728).  Blocks until all names have connected;
    duplicate or unknown names abort, as in the reference."""
    if len(names) != len(set(names)):
        raise ValueError("DUPLICATE CLIENT NAME IN stdin!")
    if len(names) > MAX_READERS:
        raise ValueError(f"Too many input readers requested! "
                         f"MAX_READERS was {MAX_READERS}")
    libtoid = {n: i for i, n in enumerate(names)}
    readers: list[SocketTrieReader | None] = [None] * len(names)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(backlog)
    try:
        pending = dict(libtoid)
        while pending:
            conn, _addr = srv.accept()
            header = b""
            while b"." not in header:
                data = conn.recv(RECV_CHUNK)
                if not data:
                    raise StreamError("connection closed during header")
                header += data
            if header[:1] != b"S":
                raise StreamError(
                    f"received invalid start byte: {header[0]}")
            name_b, _, rest = header[1:].partition(b".")
            name = name_b.decode()
            if name not in pending:
                raise StreamError(f'received invalid libname: "{name}"')
            rid = pending.pop(name)
            print(f"new connection id = {rid}, name = {name} "
                  f"({len(pending)} pending)", file=err)
            readers[rid] = SocketTrieReader(rid, name, conn, initial=rest)
    finally:
        srv.close()
    return readers  # type: ignore[return-value]


def serve(port: int, names: list[str], cfg: MiningConfig, out=None,
          err=None, verbose: bool = False, debug: bool = False,
          topfreq: int = 0, toptimes: int = 0,
          outputall: bool = False) -> MergeServer:
    """Full metaserver run: accept, merge, stats.  -> the server object
    (counters inspectable; stdout already written)."""
    err = err if err is not None else sys.stderr
    readers = accept_readers(port, names, err=err)
    ms = MergeServer(readers, cfg, out=out, err=err, verbose=verbose,
                     debug=debug, topfreq=topfreq, toptimes=toptimes,
                     outputall=outputall)
    ms.run()
    for tr in readers:
        if not tr.check_eof():
            print(f"WARNING: Something is wrong... more input pending at "
                  f"{tr.name}", file=err)
        tr.sock.close()
    if verbose:
        ms.print_stats()
    return ms
