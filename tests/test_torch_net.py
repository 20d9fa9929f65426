"""The wire-protocol pair of the port (dsm_tpu_torch/net, `enumerate`,
`serve`) against dsm_tpu's, on the CPU (mirror of tests/test_interop.py:73,
98 and tests/test_cli.py:58).

(a) The codec: the port's `encode_events`, `native_encode`, `TrieParser`
    and `NativeTrieParser` against dsm_tpu's on random event streams fed in
    random chunks, and on a bad checksum; without a compiler the port
    falls back to the pure-Python codec with the same bytes.
(b) The client: `serialize_trie` bytes equal dsm_tpu's on the same index
    at test_interop.py:167-169's (fmin, maxdepth, prefix) cases.
(c) The servers: dsm_tpu's clients into the port's `serve` and the port's
    clients into dsm_tpu's, in threads, against the frozen golden.
(d) The CLI: `serve` + 5 `enumerate` processes against
    tests/golden/server-output.default.C.txt.gz, and `enumerate`'s stdin
    errors against `dsm enumerate`'s.

Ports are picked free at run time.  The indexes are dsm_tpu's, built in
the process from the toydata, carried over by convert.py.
"""

from __future__ import annotations

import errno
import glob
import gzip
import io
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dsm_tpu.cli.main import main as dsm_main
from dsm_tpu.index.alphabet import transform
from dsm_tpu.index.fasta import read_fasta
from dsm_tpu.index.fmindex import FMIndex
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.net import client as jclient
from dsm_tpu.net import native as jnative
from dsm_tpu.net import server as jserver
from dsm_tpu.net import wire as jwire
from dsm_tpu_torch import convert
from dsm_tpu_torch.cli.main import main as port_main
from dsm_tpu_torch.net import client, native, server, wire

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
TOYDATA = os.path.join(HERE, "data", "toydata")
ENV = {**os.environ, "PYTHONPATH": REPO}


def golden(config: str, prefix: str) -> bytes:
    with gzip.open(os.path.join(
            GOLDEN, f"server-output.{config}.{prefix}.txt.gz")) as f:
        return f.read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _listening(port: int) -> bool:
    """Whether a socket listens on `port`: a probe that sets SO_REUSEADDR
    binds it until then.  The probe must set it: a probe without it that
    holds the port at the instant the server binds (with SO_REUSEADDR)
    makes the server's bind fail with EADDRINUSE."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("", port))
        except OSError:
            return True
    return False


def _wait_listening(port: int, server: threading.Thread,
                    seconds: float = 30) -> bool:
    """Wait until the server thread listens on `port` -> True, or has
    ended without (its bind failed) -> False."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not server.is_alive():
            return False
        if _listening(port):
            return True
        time.sleep(0.01)
    raise TimeoutError(f"nothing listens on port {port}")


@pytest.fixture(scope="module")
def indexes():
    return [FMIndex.from_texts([transform(r.seq) for r in read_fasta(p)])
            for p in sorted(glob.glob(os.path.join(TOYDATA,
                                                   "toy*.fasta.gz")))]


@pytest.fixture(scope="module")
def pidx(indexes):
    return [convert.fmindex_from_jax(i) for i in indexes]


NAMES = [f"toy{i}" for i in range(5)]


# ----------------------------------------------------------- (a) codec --

def random_events(rng, n_nodes=200, max_freq=1 << 40):
    """A well-formed stream of n_nodes opens and their closes."""
    types, syms, freqs = [], [], []
    depth = opened = 0
    while opened < n_nodes or depth > 0:
        if opened < n_nodes and (depth == 0 or rng.random() < 0.55):
            types.append(wire.OPEN)
            syms.append(rng.choice(list(b"ACGTN")))
            freqs.append(0)
            opened += 1
            depth += 1
        else:
            types.append(wire.CLOSE)
            syms.append(rng.choice(list(b"0NACGT")))
            freqs.append(int(rng.integers(0, max_freq)))
            depth -= 1
    return (np.array(types, np.uint8), np.array(syms, np.uint8),
            np.array(freqs, np.uint64))


def _parse_in_chunks(parser, data: bytes, rng) -> list:
    events, pos = [], 0
    while pos < len(data):
        step = int(rng.integers(1, 37))
        events.extend(parser.feed(data[pos:pos + step]))
        pos += step
    assert parser.pending == 0
    return events


@pytest.mark.parametrize("seed", range(5))
def test_codec_matches_dsm_tpu(seed):
    rng = np.random.default_rng(seed)
    types, syms, freqs = random_events(rng, n_nodes=50 + 100 * seed)
    want = jwire.encode_events(types, syms, freqs)
    assert wire.encode_events(types, syms, freqs) == want
    assert native.get_lib() is not None
    assert native.native_encode(types, syms, freqs) == \
        jnative.native_encode(types, syms, freqs) == want
    jevents = _parse_in_chunks(jwire.TrieParser(), want[0], rng)
    for parser in (wire.TrieParser(), native.NativeTrieParser()):
        assert _parse_in_chunks(parser, want[0], rng) == jevents
    assert len(jevents) == len(types)


def test_codec_detects_bad_checksum():
    # a node whose checksum is wrong: freq 1, checksum 5 but n == 1
    buf = b"(A" + bytes([0x81]) + b"R" + bytes([0x85]) + b"0)"
    for parser in (wire.TrieParser(), native.NativeTrieParser(),
                   jwire.TrieParser()):
        with pytest.raises(ValueError,
                           match="total number traversed = 1 but checksum "
                                 "was 5"):
            parser.feed(buf)


def test_without_a_compiler_the_pure_codec_serves(pidx, indexes, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "net")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    assert native.get_lib() is None
    assert native.native_encode(np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                                np.zeros(0, np.uint64)) is None
    assert isinstance(native.make_parser(), wire.TrieParser)
    assert native.codec_name() == "pure Python (wire.py)"
    assert client.serialize_trie(pidx[1], 2, enforcepath=b"G") == \
        jclient.serialize_trie(indexes[1], 2, enforcepath=b"G")


# ---------------------------------------------------------- (b) client --

@pytest.mark.parametrize("fmin,maxdepth,prefix", [
    (2, None, "A"), (5, None, "C"), (1, 14, "G"), (2, 12, "T"),
    (1, 10, "AC")])
def test_serialize_trie_matches_dsm_tpu(pidx, indexes, fmin, maxdepth,
                                        prefix):
    md = maxdepth or client.UNLIMITED_DEPTH
    got = client.serialize_trie(pidx[0], fmin, md, prefix.encode())
    want = jclient.serialize_trie(indexes[0], fmin, md, prefix.encode())
    assert got == want and got[1] > 0


# --------------------------------------------------------- (c) servers --

def _fleet(serve_mod, cfg, client_mod, idxs, prefix: str,
           attempts: int = 5) -> bytes:
    """One server (of `serve_mod`, merging under `cfg`) in a thread and one
    client (of `client_mod`) a sample in threads; -> the server's stdout.
    A port is picked free and released before the server binds it, so
    another process may take it in between: the server's bind then fails
    with EADDRINUSE and the fleet starts again on a fresh port."""
    for _ in range(attempts):
        port, out, errs = _free_port(), io.BytesIO(), []

        def run_server():
            try:
                readers = serve_mod.accept_readers(port, NAMES,
                                                   err=io.StringIO())
                ms = serve_mod.MergeServer(readers, cfg, out=out,
                                           err=io.StringIO())
                ms.run()
                for tr in readers:
                    tr.sock.close()
            except Exception as e:   # surfaced by the test
                errs.append(e)

        th = threading.Thread(target=run_server, daemon=True)
        th.start()
        if _wait_listening(port, th):
            break
        if not (errs and isinstance(errs[0], OSError)
                and errs[0].errno == errno.EADDRINUSE):
            raise errs[0] if errs else AssertionError(
                "the server ended before it listened")
    else:
        raise AssertionError(f"no free port in {attempts} attempts")
    clients = [threading.Thread(
        target=client_mod.run_client,
        args=(idx, name, [("localhost", port, prefix)], 2), daemon=True)
        for idx, name in zip(idxs, NAMES)]
    for c in clients:
        c.start()
    for c in clients + [th]:
        c.join(120)
        assert not c.is_alive()
    assert errs == []
    return out.getvalue()


SERVER_CFG = MiningConfig(fmin=1, emax=1.2)


def test_port_server_takes_dsm_tpu_clients(indexes):
    cfg = convert.config_from_jax(SERVER_CFG)
    assert _fleet(server, cfg, jclient, indexes, "G") == \
        golden("default", "G")


def test_dsm_tpu_server_takes_port_clients(pidx):
    assert _fleet(jserver, SERVER_CFG, client, pidx, "T") == \
        golden("default", "T")


# ------------------------------------------------------------ (d) CLI --

@pytest.fixture(scope="module")
def paths(indexes, tmp_path_factory):
    out = tmp_path_factory.mktemp("net_idx")
    found = []
    for name, idx in zip(NAMES, indexes):
        found.append(str(out / f"{name}.dsmi"))
        idx.save(found[-1])
    return found


def test_cli_serve_enumerate_pipeline(paths, tmp_path):
    port = _free_port()
    with open(tmp_path / "out.txt", "wb") as out, \
            open(tmp_path / "server.log", "wb") as log:
        srv = subprocess.Popen(
            [sys.executable, "-m", "dsm_tpu_torch", "serve", "-p", str(port),
             "-E", "1.2", "-v"], stdin=subprocess.PIPE, stdout=out,
            stderr=log, env=ENV, cwd=REPO)
    srv.stdin.write("".join(n + "\n" for n in NAMES).encode())
    srv.stdin.close()
    clients = []
    for path in paths:
        c = subprocess.Popen(
            [sys.executable, "-m", "dsm_tpu_torch", "enumerate", "-f", "2",
             path], stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, env=ENV, cwd=REPO)
        c.stdin.write(f"localhost {port} C\n".encode())
        c.stdin.close()
        clients.append(c)
    try:
        for c in clients:
            assert c.wait(timeout=120) == 0, c.stderr.read().decode()
        assert srv.wait(timeout=120) == 0
    finally:
        for p in clients + [srv]:
            p.kill()
            if p.stderr:
                p.stderr.close()
    assert (tmp_path / "out.txt").read_bytes() == golden("default", "C")
    log = (tmp_path / "server.log").read_text()
    assert "Number of paths:" in log and "pending" in log


@pytest.mark.parametrize("stdin,message", [
    ("localhost 5000\n", "error: truncated host info"),
    ("localhost 80 A\n", "error: invalid port number: 80"),
    ("", "error: empty host info"),
])
def test_cli_enumerate_hostinfo_errors(paths, monkeypatch, capsys, stdin,
                                       message):
    for main in (dsm_main, port_main):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        with pytest.raises(SystemExit) as e:
            main(["enumerate", "-f", "2", paths[0]])
        assert e.value.code == 1
        assert capsys.readouterr().err.strip() == message
