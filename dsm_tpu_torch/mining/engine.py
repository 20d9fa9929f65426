"""Device tables and the mining front door of the port.

Counterpart of dsm_tpu/mining/engine.py: `DeviceIndexes` (the S
per-sample bidirectional fused occ tables stacked on one device),
`hbm_budget`, the drain's deferred left-branching codes
(`leftchar_codes_pairs`, the plain counterpart of leftchar_codes_pairsT,
and `leftchar_rows`, the rank kernel's leftChar entry on the staged output
rows of one device or of every shard of a process) and `mine_torch`, the
dispatch of `mine_tpu` for the ascending and gnu reader orders.

The tables are uploaded ROW-major, (R, ROWW) int32 bit patterns of the
uint32 `fused_rows(..., c4=)` rows: one 128-byte row per 128-symbol block
is what the rank kernel gathers.  The TPU's transposed (32, R) copies are
not made.
"""

from __future__ import annotations

import array
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..index.fmindex import FMIndex
from ..ops import _build
from ..ops.rank import ROWW, fused_rows, occ_cum8_pair_plain
from ..ops.shardstats import MAX_SHARDS
from ..utils.device import resolve_device
from .config import MiningConfig
from .engine_np import LC_N, LC_ZERO, MinedOutput

EXT4 = (2, 3, 4, 6)  # codes of A, C, G, T (alphabet.EXT_CODES as a tuple)
# the staged output rows' columns ((k, 5) int32), as in dsm_tpu
OC_FREQ, OC_RLO, OC_SID, OC_ROW, OC_DEPTH = range(5)
OUT_COLS = 5
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
    reports free and of what this process's caching allocator holds
    unallocated (env DSM_HBM_BYTES overrides).  The CPU's budget is
    unbounded (host RAM is the limit)."""
    env = os.environ.get("DSM_HBM_BYTES")
    if env:
        return int(env)
    if device.type == "cpu":
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * 0.9)


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
                f"device budget is {budget:,} (DSM_HBM_BYTES overrides): "
                "shard the sample axis over more devices "
                "(parallel/engine_episode.py) or use `mine --engine auto` "
                "(mining.bigindex.mine_big), which plans sharding and "
                "falls back to the bounded-memory host engine")

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
    pairs from the ranks in the reverse table at rlo and rlo + freq: a
    concrete base (code 2..5) iff every occurrence extends with it, LC_N if
    the extensions are mixed, LC_ZERO if none.  Plain PyTorch (any device)
    counterpart of dsm_tpu.mining.engine.leftchar_codes_pairsT; the drains
    run `leftchar_rows`.  -> (K,) int8."""
    o_lo, o_hi = occ_cum8_pair_plain(rrows, rlo, rlo + freq, soff_pair)
    rcnt = o_hi[:4] - o_lo[:4]                              # (4, K)
    is_full = (rcnt == freq[None, :]) & (freq[None, :] > 0)
    code = torch.where(
        is_full.any(dim=0), is_full.to(torch.int8).argmax(dim=0) + 2,
        torch.where((rcnt > 0).any(dim=0), LC_N, LC_ZERO))
    return code.to(torch.int8)


def leftchar_rows_plain(tables, orows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the leftChar entry (any device): each row's
    shard is the last of `tables` whose first sample id is at or below its
    OC_SID, and its codes come from `leftchar_codes_pairs` on that shard's
    reverse table at its soff."""
    sid = orows[:, OC_SID].contiguous()
    bases = torch.tensor([int(b) for _r, _s, b in tables], dtype=torch.int32,
                         device=orows.device)
    shard = torch.searchsorted(bases, sid, right=True) - 1
    codes = torch.empty(orows.shape[0], dtype=torch.int8,
                        device=orows.device)
    for k, (rrows, soff, base) in enumerate(tables):
        mine = shard == k
        rows = orows[mine]
        codes[mine] = leftchar_codes_pairs(
            rrows, soff[(rows[:, OC_SID] - int(base)).to(torch.int64)],
            rows[:, OC_RLO], rows[:, OC_FREQ])
    return codes


def leftchar_rows(tables, orows: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """leftChar codes of staged output rows, in one launch of the rank
    kernel's leftChar entry (csrc/rank.cu, counted as `rank`).

    tables: 1 to MAX_SHARDS (rrows, soff, base) of the reverse tables the
    rows' samples lie in, `base` the global id of the table's first sample,
    ascending (one device: `[(dev.rrows, dev.soff, 0)]`); orows: (n, 5)
    int32 contiguous rows (columns OC_*) with global sample ids, each of a
    sample that one of the tables holds; out: (n,)
    int8 contiguous to write the codes into (a slice of a larger vector
    will do), or None.  -> the (n,) int8 codes.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if orows.device.type == "cpu":
        codes = leftchar_rows_plain(tables, orows)
        if out is None:
            return codes
        out.copy_(codes)
        return out
    device = orows.device
    if device.type != "cuda":
        raise ValueError(f"leftchar_rows: unsupported device {device}")
    if (orows.dtype != torch.int32 or orows.dim() != 2
            or orows.shape[1] != OUT_COLS or not orows.is_contiguous()):
        raise ValueError(f"leftchar_rows: rows must be contiguous "
                         f"(n, {OUT_COLS}) int32")
    if not 1 <= len(tables) <= MAX_SHARDS:
        raise ValueError(f"leftchar_rows: takes 1 to {MAX_SHARDS} tables "
                         f"(got {len(tables)})")
    entries = []
    for k, (rrows, soff, base) in enumerate(tables):
        if (rrows.dtype != torch.int32 or rrows.dim() != 2
                or rrows.shape[1] != ROWW or not rrows.is_contiguous()
                or rrows.device != device or soff.dtype != torch.int32
                or soff.dim() != 1 or not soff.is_contiguous()
                or soff.device != device):
            raise ValueError(f"leftchar_rows: table {k} must be contiguous "
                             f"(R, {ROWW}) int32 rows and 1-D int32 soff on "
                             f"{device}")
        if entries and int(base) < entries[-1][2]:
            raise ValueError("leftchar_rows: the tables' bases must ascend")
        entries.append((rrows.data_ptr(), soff.data_ptr(), int(base)))
    n = orows.shape[0]
    if out is None:
        out = torch.empty(n, dtype=torch.int8, device=device)
    elif (out.dtype != torch.int8 or out.shape != (n,)
          or not out.is_contiguous() or out.device != device):
        raise ValueError(f"leftchar_rows: out must be contiguous ({n},) int8 "
                         f"on {device}")
    if n:
        table = array.array("q", [v for e in entries for v in e])
        _build.launch("dsm_leftchar", "rank", device, orows.data_ptr(), n,
                      table.buffer_info()[0], len(entries), out.data_ptr())
    return out


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
