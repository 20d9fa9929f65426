"""Device tables and the mining front door of the port.

Counterpart of dsm_tpu/mining/engine.py: `DeviceIndexes` (the S
per-sample bidirectional fused occ tables stacked on one device),
`hbm_budget`, `leftchar_codes_pairs` (the drain's deferred left-branching
codes, built on the rank kernel) and `mine_torch`, the dispatch of
`mine_tpu` for the ascending and gnu reader orders.

The tables are uploaded ROW-major, (R, ROWW) int32 bit patterns of the
uint32 `fused_rows(..., c4=)` rows: one 128-byte row per 128-symbol block
is what the rank kernel gathers.  The TPU's transposed (32, R) copies are
not made.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..ops.rank import ROWW, fused_rows, occ_cum8_pair
from ..utils.device import resolve_device
from .config import MiningConfig
from .engine_np import LC_N, LC_ZERO, MinedOutput

EXT4 = (2, 3, 4, 6)  # codes of A, C, G, T (alphabet.EXT_CODES as a tuple)
# dsm_tpu's episode constants, kept so that both engines drain, poll and
# save at the same levels and hand the same frontier to the host:
OUT_RESERVE = 1 << 15  # staged output rows that make a DRAIN exit
# hand the frontier to the host wavefront (engine_np.mine_from_level) once
# it is this narrow and past engine_device.TAIL_MIN_DEPTH: deep tries (long
# repeats) have thousands of near-empty levels, each a round of launches
TAIL_WIDTH = 768

# Hard sample-count bound of the episode engines: a node owns at most S
# pairs, and the segstats kernel walks them in one thread.  The
# reference caps a server at 273 readers (metaserver.cpp:19).
MAX_SAMPLES = 512


def hbm_budget(device: torch.device) -> int:
    """Device memory budget in bytes: 90% of what `torch.cuda.mem_get_info`
    reports free (env DSM_HBM_BYTES overrides).  The CPU's budget is
    unbounded (host RAM is the limit)."""
    env = os.environ.get("DSM_HBM_BYTES")
    if env:
        return int(env)
    if device.type == "cpu":
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(device)
    return int(free * 0.9)


@dataclass
class DeviceIndexes:
    """S per-sample fused occ tables stacked on one device.

    frows/rrows: (R, ROWW) int32 forward / reverse tables (C4 baked in,
    fused_rows c4=); soff: (S,) int32 first table row of each sample (the
    same in both directions); ns: (S,) int64 host text lengths."""

    S: int
    ns: np.ndarray
    frows: torch.Tensor
    rrows: torch.Tensor
    soff: torch.Tensor
    device: torch.device

    @classmethod
    def from_host(cls, ns, fnp: np.ndarray, rnp: np.ndarray, soff,
                  device) -> "DeviceIndexes":
        """Upload host tables ((R, ROWW) uint32 each) to `device`."""
        device = resolve_device(device)
        rows = fnp.shape[0]
        if fnp.shape != (rows, ROWW) or rnp.shape != fnp.shape:
            raise ValueError("forward and reverse tables must both be "
                             f"(R, {ROWW})")
        if rows >= 2**31 // ROWW:
            raise ValueError(f"stacked occ tables need {rows} rows; int32 "
                             "row offsets support fewer than "
                             f"{2**31 // ROWW}")
        resident = 2 * rows * ROWW * 4
        budget = hbm_budget(device)
        if resident > budget:
            raise ValueError(
                f"resident occ tables need {resident:,} bytes but the "
                f"device budget is {budget:,} (DSM_HBM_BYTES overrides)")

        def up(a):
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
            return torch.from_numpy(a).to(device)

        ns = np.asarray(ns, dtype=np.int64)
        return cls(S=int(ns.shape[0]), ns=ns, frows=up(fnp), rrows=up(rnp),
                   soff=torch.as_tensor(np.array(soff, dtype=np.int32),
                                        device=device),
                   device=device)

    @classmethod
    def build(cls, indexes: list[FMIndex], device) -> "DeviceIndexes":
        fparts, rparts, offs, ns = [], [], [], []
        off = 0
        for idx in indexes:
            c4 = [idx.C[c] for c in EXT4]
            fr = fused_rows(idx.table, c4=c4)
            rr = fused_rows(idx.rtable, c4=c4)
            fparts.append(fr)
            rparts.append(rr)
            offs.append(off)
            off += fr.shape[0]
            ns.append(idx.n)
        return cls.from_host(ns, np.concatenate(fparts),
                             np.concatenate(rparts), offs, device)


def leftchar_codes_pairs(rrows: torch.Tensor, soff_pair: torch.Tensor,
                         rlo: torch.Tensor, freq: torch.Tensor
                         ) -> torch.Tensor:
    """leftChar codes (EnumerateQuery.cpp:77-103) of K (node, sample)
    pairs from one two-ended rank-kernel launch on the reverse table
    (`occ_cum8_pair` at rlo and rlo + freq): a concrete
    base (code 2..5) iff every occurrence extends with it, LC_N if the
    extensions are mixed, LC_ZERO if none.  Counterpart of
    dsm_tpu.mining.engine.leftchar_codes_pairsT.  -> (K,) int8."""
    o_lo, o_hi = occ_cum8_pair(rrows, rlo, rlo + freq, soff_pair)
    rcnt = o_hi[:4] - o_lo[:4]                              # (4, K)
    is_full = (rcnt == freq[None, :]) & (freq[None, :] > 0)
    code = torch.where(
        is_full.any(dim=0), is_full.to(torch.int8).argmax(dim=0) + 2,
        torch.where((rcnt > 0).any(dim=0), LC_N, LC_ZERO))
    return code.to(torch.int8)


def mine_torch(indexes: list[FMIndex], cfg: MiningConfig,
               prefix: bytes = b"", reader_order: str = "ascending",
               device="cuda", dev: DeviceIndexes | None = None,
               tail_width: int = TAIL_WIDTH, out_reserve: int = OUT_RESERVE,
               profile: dict | None = None, checkpoint: str | None = None,
               halt=None) -> MinedOutput:
    """Mine the cross-sample union trie on `device` with the
    device-resident episode (mining/engine_device.mine_device, which
    documents the arguments, among them the snapshot file `checkpoint` and
    the steering callback `halt`).  Same semantics and output as dsm_tpu's
    mine_tpu and engine_np.mine_np: reader_order 'ascending', or 'gnu' for
    the reference's byte-exact reader order."""
    from .engine_device import mine_device

    return mine_device(indexes, cfg, prefix=prefix, dev=dev,
                       tail_width=tail_width, out_reserve=out_reserve,
                       reader_order=reader_order, device=device,
                       profile=profile, checkpoint=checkpoint, halt=halt)
