"""Mining checkpoint/resume of the port: dsm_tpu's snapshot files.

Counterpart of dsm_tpu/mining/checkpoint.py, whose `save_checkpoint`
pulls the episode state with `jax.device_get`.  Here the state arrives as
host numpy, already in dsm_tpu's layouts, and the file is the same
atomically written `.npz` (no pickle) with the same keys: `__fp` (the
fingerprint of config, prefix and sample sizes), `__paths` (the live
frontier's (nodes, depth) uint8 symbol-code matrix), the `o_*` arrays of
the MinedOutput so far and `st_` + every `_STATE_KEYS` entry.  So a
snapshot written by either package resumes in the other.  Reading is
dsm_tpu's `load_checkpoint`, which is JAX-free.
"""

from __future__ import annotations

import os

import numpy as np

from dsm_tpu.mining.checkpoint import (_STATE_KEYS, _encode_output,
                                       _fingerprint, load_checkpoint)
from dsm_tpu.mining.config import MiningConfig
from dsm_tpu.mining.engine_np import MinedOutput

__all__ = ["load_checkpoint", "save_checkpoint"]


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
