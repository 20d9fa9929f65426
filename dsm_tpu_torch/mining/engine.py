"""Device tables and the mining front door of the port.

Counterpart of dsm_tpu/mining/engine.py: `DeviceIndexes` (the S
per-sample bidirectional fused occ tables stacked on one device),
`hbm_budget`, the drain's deferred left-branching codes
(`leftchar_codes_pairs`, the plain counterpart of leftchar_codes_pairsT,
and `leftchar_rows`, the rank kernel's leftChar entry on the staged output
rows of one device or of every shard of a process), the per-level engine
(`_level_step`, `_seed_state`, `_resize`, `MIN_CAP` and `mine_levels`,
the dense level loop with host emission that mine_tpu's 'level-gnu' order
and parallel/engine_sharded's mesh engine run) and `mine_torch`, the
dispatch of `mine_tpu`: the ascending and gnu reader orders to the
episode, 'level-gnu' to the per-level loop.

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

from ..index.alphabet import EXT_CHARS
from ..index.fmindex import FMIndex
from ..ops import _build
from ..ops.level import LevelTables, compact_level, expand_level
from ..ops.rank import ROWW, fused_rows, occ_cum8_pair_plain
from ..ops.shardstats import MAX_SHARDS
from ..utils.device import resolve_device
from ..utils.trace import PROCESS, span
from .config import MiningConfig
from .engine_np import LC_N, LC_ZERO, MinedOutput, emit_level

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
        """Upload host tables ((R, ROWW) uint32 each) to `device`; the
        copies' seconds go to the process's `copy_s` (utils/trace.PROCESS)."""
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
            with span(PROCESS, "copy_s"):
                return torch.from_numpy(a).to(device)

        ns = np.asarray(ns, dtype=np.int64)
        return cls(S=int(ns.shape[0]), ns=ns, frows=up(fnp), rrows=up(rnp),
                   soff=torch.as_tensor(np.array(soff, dtype=np.int32),
                                        device=device),
                   device=device)

    @classmethod
    def build(cls, indexes: list[FMIndex], device) -> "DeviceIndexes":
        """Pack the indexes' tables on the host (`fused_rows`, in the
        process's `pack_s`) and upload them (`from_host`)."""
        fparts, rparts, offs, ns = [], [], [], []
        off = 0
        with span(PROCESS, "pack_s"):
            for idx in indexes:
                c4 = [idx.C[c] for c in EXT4]
                fr = fused_rows(idx.table, c4=c4)
                rr = fused_rows(idx.rtable, c4=c4)
                fparts.append(fr)
                rparts.append(rr)
                offs.append(off)
                off += fr.shape[0]
                ns.append(idx.n)
            fnp, rnp = np.concatenate(fparts), np.concatenate(rparts)
        return cls.from_host(ns, fnp, rnp, offs, device)


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


# ---------------------------------------------------- the per-level engine

MIN_CAP = 1024


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def _seed_state(ns, rows: int, cap: int, device):
    """The root frontier of `rows` prefix rows: (lo, hi, rlo) (rows, cap,
    S) int32 with node 0's intervals [0, n_s) and reverse starts 0, valid
    (rows, cap) bool with node 0 alone."""
    S = len(ns)
    lo = torch.zeros((rows, cap, S), dtype=torch.int32, device=device)
    hi = torch.zeros_like(lo)
    hi[:, 0] = torch.as_tensor(np.asarray(ns, dtype=np.int32),
                               device=device)
    rlo = torch.zeros_like(lo)
    valid = torch.zeros((rows, cap), dtype=torch.bool, device=device)
    valid[:, 0] = True
    return lo, hi, rlo, valid


def _resize(state, cap: int):
    """The frontier at another capacity: cut, or padded with empty
    nodes."""
    cur = state[0].shape[1]
    if cap == cur:
        return state
    if cap < cur:
        return tuple(a[:, :cap].contiguous() for a in state)
    grown = []
    for a in state:
        g = torch.zeros((a.shape[0], cap, *a.shape[2:]), dtype=a.dtype,
                        device=a.device)
        g[:, :cur] = a
        grown.append(g)
    return tuple(grown)


def _level_step(tables, state, fmin: int, sym_mask: torch.Tensor,
                group=None) -> dict:
    """One dense level (dsm_tpu's _level_step_impl, and with `group` its
    _sharded_step_impl): the expand (K12) over `tables` (ops/level.py), in
    a group one all-reduce of the per-node sums, and the analyse-and-compact
    (K13) -> the next frontier with parent_row, sym, child_count,
    single_full, freq and lc."""
    core = expand_level(tables, *state, fmin)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(core["sums"], group=group)
    res = compact_level(core, core["sums"], sym_mask)
    res.update(freq=core["freq"], lc=core["lc"])
    return res


def mine_levels(cfg: MiningConfig, d: int, tables, ns, row_masks: np.ndarray,
                prefix: bytes, trackers, cap: int, device, group=None,
                gather=None, profile: dict | None = None) -> MinedOutput:
    """The per-level loop of dsm_tpu's mine_tpu(reader_order='level-gnu')
    and mine_sharded: a dense frontier of R prefix rows, a level a step;
    the frontier regrows and redoes a level whose children pass its
    capacity and shrinks toward the live width; the host emits every level
    (engine_np.emit_level: one GnuOrderTracker a row, or none for ascending
    order) and builds the paths.

    d: the samples in all; tables, ns: this process's shard tables (the
    list ops/level.py takes) and their samples' text lengths; row_masks:
    (R, k, 4) bool, the symbols row r may take at depth < k
    (parallel/mesh.row_prefix_masks; one device: (1, 0, 4)); prefix: the
    enforced path; trackers: R trackers or None; cap: the first capacity;
    group: the process group whose processes hold the other samples (one
    all-reduce a level), and `gather`, which turns a (R, m, S_local) tensor
    into the (R, m, d) host array of every process's columns.  `profile`,
    a dict, receives the levels run (redone ones too), the regrows and the
    seconds of the level steps and of the host's part."""
    import time

    R, k_rows = row_masks.shape[0], row_masks.shape[1]
    tables = LevelTables(tables)      # checked and packed once a run
    out = MinedOutput(freq_histogram=np.zeros(d, dtype=np.int64))
    prefix_codes = [EXT_CHARS.index(b) for b in prefix]
    onehot = np.eye(4, dtype=bool)
    host = gather or (lambda t: t.cpu().numpy())
    state = _seed_state(ns, R, cap, device)
    paths: list[list[bytes]] = [[b""] for _ in range(R)]
    depth = levels = regrows = 0
    step_s = host_s = 0.0
    while True:
        t0 = time.perf_counter()
        if depth >= cfg.maxdepth:
            mask = np.zeros((R, 4), dtype=bool)
        else:
            # each row's prefix partition composed with the enforced path
            mask = np.ones((R, 4), dtype=bool)
            if depth < k_rows:
                mask &= row_masks[:, depth, :]
            if depth < len(prefix_codes):
                mask &= onehot[prefix_codes[depth]][None, :]
        res = _level_step(tables, state, cfg.fmin,
                          torch.from_numpy(mask).to(device), group)
        counts = res["child_count"].tolist()
        t1 = time.perf_counter()
        step_s += t1 - t0
        levels += 1
        cap_now, cmax = state[0].shape[1], max(counts)
        if cmax > cap_now:
            # frontier overflow: grow capacity and redo this level
            regrows += 1
            state = _resize(state, _next_pow2(cmax))
            continue
        if depth > 0:
            # rows past a row's paths are empty: no line, no path counted
            live = max(len(p) for p in paths)
            freq = host(res["freq"][:, :live]).astype(np.int64)
            lc = host(res["lc"][:, :live])
            sf = res["single_full"][:, :live].cpu().numpy()
            for r in range(R):
                n = len(paths[r])
                emit_level(out, cfg, d, depth, paths[r], freq[r, :n],
                           lc[r, :n], sf[r, :n],
                           trackers[r] if trackers else None)
        if cmax == 0:
            host_s += time.perf_counter() - t1
            break
        parent_row = res["parent_row"][:, :cmax].cpu().numpy()
        sym = res["sym"][:, :cmax].cpu().numpy()
        if trackers:
            act = host((res["hi"][:, :cmax] > res["lo"][:, :cmax])
                       .to(torch.uint8)).astype(bool)
        for r in range(R):
            cc = counts[r]
            pr, sy = parent_row[r, :cc].tolist(), sym[r, :cc].tolist()
            if trackers:
                trackers[r].advance(
                    depth, paths[r],
                    [(u, c, act[r, j]) for j, (u, c) in enumerate(zip(pr, sy))])
            paths[r] = [paths[r][u] + EXT_CHARS[c:c + 1]
                        for u, c in zip(pr, sy)]
        state = (res["lo"], res["hi"], res["rlo"], res["valid"])
        # shrink toward the live width to keep deep narrow levels cheap
        want = max(MIN_CAP, _next_pow2(cmax))
        if want < cap_now:
            state = _resize(state, want)
        depth += 1
        host_s += time.perf_counter() - t1
    if profile is not None:
        profile.update(levels=levels, regrows=regrows, level_s=step_s,
                       host_s=host_s)
    out.sort_postorder()
    return out


def _mine_level_gnu(indexes, cfg: MiningConfig, prefix: bytes, device,
                    dev: DeviceIndexes | None, cap: int,
                    profile: dict | None) -> MinedOutput:
    """mine_tpu's reader_order='level-gnu': the per-level loop on one device,
    its host emission driving the per-level GnuOrderTracker (the
    differential oracle of the episode's lazy gnu reconstruction)."""
    from .gnuorder import GnuOrderTracker

    if dev is None:
        dev = DeviceIndexes.build(indexes, device)
    tracker = GnuOrderTracker(dev.S, server_prefix_len=max(1, len(prefix)))
    return mine_levels(cfg, dev.S, [(dev.frows, dev.rrows, dev.soff, 0)],
                       dev.ns, np.ones((1, 0, 4), dtype=bool), prefix,
                       [tracker], cap, dev.device, profile=profile)


def mine_torch(indexes: list[FMIndex], cfg: MiningConfig,
               prefix: bytes = b"", reader_order: str = "ascending",
               device="cuda", dev: DeviceIndexes | None = None,
               tail_width: int = TAIL_WIDTH, out_reserve: int = OUT_RESERVE,
               profile: dict | None = None, checkpoint: str | None = None,
               halt=None, cap: int = MIN_CAP) -> MinedOutput:
    """Mine the cross-sample union trie on `device`.  Same semantics and
    output as dsm_tpu's mine_tpu and engine_np.mine_np.  reader_order
    'ascending', or 'gnu' for the reference's byte-exact reader order, runs
    the device-resident episode (mining/engine_device.mine_device, which
    documents the arguments, among them the snapshot file `checkpoint` and
    the steering callback `halt`).  'level-gnu' runs the per-level loop
    (`mine_levels`, kernels K12 and K13 a level, starting at capacity
    `cap`), whose host emission drives the per-level gnu order tracker: the
    same bytes as 'gnu'; it takes no `checkpoint` and no `halt`, and
    `profile` receives its levels, regrows and seconds.  With the
    profiler annotations on (utils/trace.annotate), the call is one
    `dsm.job` span that holds the spans of its phases."""
    with span(None, "job"):
        if reader_order == "level-gnu":
            cfg.validate()
            if checkpoint is not None:
                raise ValueError("checkpointing requires reader_order="
                                 "'ascending' or 'gnu' (the episode engine); "
                                 "the legacy 'level-gnu' per-level loop has "
                                 "no checkpoints")
            if halt is not None:
                raise ValueError("halt requires reader_order='ascending' or "
                                 "'gnu' (the episode engine)")
            return _mine_level_gnu(indexes, cfg, prefix,
                                   None if dev else resolve_device(device),
                                   dev, cap, profile)
        from .engine_device import mine_device

        return mine_device(indexes, cfg, prefix=prefix, dev=dev,
                           tail_width=tail_width, out_reserve=out_reserve,
                           reader_order=reader_order, device=device,
                           profile=profile, checkpoint=checkpoint, halt=halt)
