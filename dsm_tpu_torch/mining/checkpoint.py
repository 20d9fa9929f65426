"""Mining checkpoint/resume of the port: dsm_tpu's snapshot files.

Counterpart of dsm_tpu/mining/checkpoint.py (the port's copy of its
snapshot codec; its `save_checkpoint` pulls the episode state off the
device itself, here the state arrives as host numpy, already in dsm_tpu's
layouts).  The reference has no mining checkpoints: a failed run restarts
from scratch.  The episode's drained exits are natural checkpoints: the
output buffers are empty and the live frontier's paths can be decoded
from the device-resident history, so a complete snapshot is

  * the frontier (the live pair rows, nvalid, depth),
  * the decoded paths of the live frontier rows (the history itself is
    not persisted: the paths re-seed a PathHistory base on resume),
  * the run counters (total_paths, entropy range),
  * the outputs accumulated on the host so far,
  * a fingerprint of (config, prefix, sample sizes) to refuse resuming
    against different inputs.

The file is an atomically written (tmp + rename) plain `.npz` of arrays,
no pickle anywhere, so resuming from an untrusted snapshot can at worst
produce wrong mining output, never code execution.  Its keys: `__fp`,
`__paths` (the live frontier's (nodes, depth) uint8 symbol-code matrix),
the `o_*` arrays of the MinedOutput so far (concatenated path bytes +
lengths, float64 entropies, flattened (reader, freq) occ pairs + per-line
counts) and `st_` + every `_STATE_KEYS` entry.  A snapshot written by
either package resumes in the other.

The host tail stage (engine_np.mine_from_level) runs after the last
device episode and is not checkpointed mid-flight; a resume re-enters it
from the handed-off frontier.
"""

from __future__ import annotations

import os

import numpy as np

from ..index.alphabet import EXT_CHARS
from .config import MiningConfig
from .engine_np import MinedOutput

FORMAT = 5
# the frontier is stored SPARSE: the live pair rows in dsm_tpu's column
# order — O(pairs) bytes, not O(nodes x samples), so snapshots stay small
# at the reference's 273-sample scale.  "eskip" records the progress
# within a partially emitted level of a dsm_tpu snapshot (the port writes
# 0); absent in older snapshots -> 0.
_STATE_KEYS = ("pairs", "nvalid", "depth", "total_paths",
               "ent_min", "ent_max", "eskip")


def _fingerprint(cfg: MiningConfig, prefix: bytes, ns) -> np.ndarray:
    blob = repr((FORMAT, cfg, prefix, list(map(int, ns)))).encode()
    return np.frombuffer(blob, dtype=np.uint8)


def _unpack_paths(mat: np.ndarray) -> list[bytes]:
    ext = np.frombuffer(EXT_CHARS, dtype=np.uint8)
    return [ext[row.astype(np.int64)].tobytes() for row in mat]


def _encode_output(out: MinedOutput) -> dict[str, np.ndarray]:
    """MinedOutput -> plain arrays (no pickle)."""
    path_blob = b"".join(p for p, _, _ in out.lines)
    path_len = np.array([len(p) for p, _, _ in out.lines], dtype=np.int64)
    ents = np.array([e for _, e, _ in out.lines], dtype=np.float64)
    occ_cnt = np.array([len(o) for _, _, o in out.lines], dtype=np.int64)
    occ_flat = np.array(
        [v for _, _, o in out.lines for pair in o for v in pair],
        dtype=np.int64).reshape(-1, 2)
    return {
        "o_paths": np.frombuffer(path_blob, dtype=np.uint8),
        "o_plen": path_len,
        "o_ent": ents,
        "o_occn": occ_cnt,
        "o_occ": occ_flat,
        "o_counters": np.array(
            [out.total_paths, out.total_output, out.total_occs],
            dtype=np.int64),
        "o_entropy_range": np.array(
            [out.smallest_entropy, out.largest_entropy], dtype=np.float64),
        "o_freqhist": np.asarray(out.freq_histogram, dtype=np.int64),
    }


def _decode_output(z) -> MinedOutput:
    blob = bytes(np.asarray(z["o_paths"], dtype=np.uint8))
    plen = np.asarray(z["o_plen"], dtype=np.int64)
    ents = np.asarray(z["o_ent"], dtype=np.float64)
    occn = np.asarray(z["o_occn"], dtype=np.int64)
    occ = np.asarray(z["o_occ"], dtype=np.int64)
    lines = []
    po = oo = 0
    for i in range(len(plen)):
        path = blob[po:po + int(plen[i])]
        po += int(plen[i])
        k = int(occn[i])
        occs = [(int(a), int(b)) for a, b in occ[oo:oo + k]]
        oo += k
        lines.append((path, float(ents[i]), occs))
    counters = np.asarray(z["o_counters"], dtype=np.int64)
    erange = np.asarray(z["o_entropy_range"], dtype=np.float64)
    return MinedOutput(
        lines=lines,
        total_paths=int(counters[0]),
        total_output=int(counters[1]),
        total_occs=int(counters[2]),
        smallest_entropy=float(erange[0]),
        largest_entropy=float(erange[1]),
        freq_histogram=np.asarray(z["o_freqhist"], dtype=np.int64).copy(),
    )


def save_checkpoint(path: str, state: dict, out: MinedOutput,
                    cfg: MiningConfig, prefix: bytes, ns,
                    path_codes: np.ndarray) -> None:
    """Write the snapshot of a drained episode exit.  `state`: host arrays
    under every `_STATE_KEYS` name, in dsm_tpu's dtypes and pair-column
    layout; `path_codes`: (nvalid, depth) uint8 codes (indexes of
    EXT_CHARS) of the live frontier's paths, what dsm_tpu's `_pack_paths`
    makes of the decoded paths."""
    missing = [k for k in _STATE_KEYS if k not in state]
    if missing:
        raise ValueError(f"checkpoint state lacks {missing}")
    codes = np.asarray(path_codes, dtype=np.uint8)
    if codes.shape != (int(state["nvalid"]), int(state["depth"])):
        raise ValueError(f"path codes {codes.shape} do not match "
                         f"{int(state['nvalid'])} nodes at depth "
                         f"{int(state['depth'])}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            __fp=_fingerprint(cfg, prefix, ns),
            __paths=codes,
            **_encode_output(out),
            **{f"st_{k}": np.asarray(state[k]) for k in _STATE_KEYS})
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: MiningConfig, prefix: bytes, ns):
    """-> (host_state dict, MinedOutput, live frontier paths).
    Raises on fingerprint drift.  Pure array decode: no pickle."""
    with np.load(path, allow_pickle=False) as z:
        fp = _fingerprint(cfg, prefix, ns)
        if not np.array_equal(z["__fp"], fp):
            raise ValueError(
                f"{path}: checkpoint was written for a different "
                "config/prefix/input set")
        out = _decode_output(z)
        state = {k[3:]: z[k] for k in z.files if k.startswith("st_")}
        paths = _unpack_paths(z["__paths"])
    return state, out, paths
