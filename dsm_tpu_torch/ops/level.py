"""The dense level step of the per-level engines: expand (kernel K12, an
entry of csrc/rank.cu) and analyse-and-compact (kernel K13, csrc/level.cu).

Counterpart of dsm_tpu/mining/engine.py `expand_core`, `leftchar_codes`,
`analyze_children` and `compact_children` (:263-379), which
`_level_step_impl` (:382) runs on one device's (CAP, S) frontier and
parallel/engine_sharded.py `_sharded_step_impl` (:125) on the (R, CAP, S)
frontier of R prefix rows, with a psum of the child statistics over the
sample shards between them.  Here the prefix rows are a batch axis of both
launches: a single device is R = 1.

The frontier: lo, hi, rlo (R, CAP, S) int32 (each (node, sample) cell's
forward interval and reverse start) and valid (R, CAP) bool.  The tables:
a list of (frows, rrows, soff, base), a table's forward and reverse fused
rows (mining/engine.DeviceIndexes), its samples' first rows and the first
sample column it holds; the columns of table k are [base_k, base_k+1), the
bases ascending from 0 (one device: `[(dev.frows, dev.rrows, dev.soff,
0)]`; a process's shards: parallel/engine_sharded `level_tables`), or the
same list prepared once a run, `LevelTables(list)`: checked once, its
pointers packed once for the launch's parameters, its device kept
(mining/engine.mine_levels prepares it; a list is prepared on each call).

`expand_level(tables, lo, hi, rlo, valid, fmin)` -> dict:
  clo, chi, crlo (R, CAP, 4, S) int32 and cactive (R, CAP, 4, S) bool: the
    four children of every cell (A, C, G, T), zero where the cell is not
    active (hi > lo in a valid row) — dsm_tpu's (CAP, S, 4) with the symbol
    before the sample, so that a child's S-wide row is contiguous;
  freq (R, CAP, S) int32: hi - lo; lc (R, CAP, S) int8: the leftChar code
    of every cell (engine_np LC_*; 0 where hi == lo);
  sums (R, CAP, 5) int32: a node's active cells and active children under
    A, C, G, T over the launch's samples (dsm_tpu's nactive and
    child_counts, side by side so a group sums them in one all-reduce);
    nactive and child_counts are views of it.
`compact_level(core, sums, sym_mask)` -> dict of the next frontier (lo,
hi, rlo, valid), parent_row and sym (R, CAP) int32, child_count (R,) int32
(past CAP: the level overflowed) and single_full (R, CAP) bool, as
dsm_tpu's step returns them, every row past the count included.  sym_mask
(R, 4) bool: the symbols each row may descend into at this depth.
"""

from __future__ import annotations

import array

import torch

from ..mining.engine_np import LC_N, LC_ZERO
from . import _build
from .rank import ROWW, _wrap32, occ_cum8_plain

SUM_COLS = 5       # sums: active cells, then active children under A C G T
MAX_TABLES = 128   # csrc/rank.cu kMaxShards
MAX_ROWS = 1024    # csrc/level.cu kMaxRows
TILE_FLAGS = 4096  # csrc/level.cu kTileFlags
TILE_THREADS = 256  # csrc/level.cu kThreads: a flag word a thread a tile
# K13's running state, a (device, stream): the look-back status words and
# the ticket (made zero; each launch leaves them zero, which spares a memset
# a level) and the flag words a tile that its second phase reads; launches
# on two streams never share one
_COMPACT_STATES: dict = {}


class LevelTables:
    """expand_level's tables prepared once: checked (1 to MAX_TABLES
    tables; forward and reverse rows contiguous (n, ROWW) int32 and soff
    contiguous 1-D int32, all on one device; the first base 0 and the bases
    ascending), their pointers packed once into the array the launch copies
    into its parameters, and their device kept.  `tables` is the list.  The
    tensors must outlive it."""

    __slots__ = ("tables", "device", "packed", "ptr")

    def __init__(self, tables):
        tables = list(tables)
        if not 1 <= len(tables) <= MAX_TABLES:
            raise ValueError(f"LevelTables: takes 1 to {MAX_TABLES} tables "
                             f"(got {len(tables)})")
        device = tables[0][0].device
        entries, last = [], 0
        for k, (frows, rrows, soff, base) in enumerate(tables):
            for name, t in (("frows", frows), ("rrows", rrows)):
                if (t.dtype != torch.int32 or t.dim() != 2
                        or t.shape[1] != ROWW or not t.is_contiguous()
                        or t.device != device):
                    raise ValueError(f"LevelTables: table {k}'s {name} must "
                                     f"be contiguous (n, {ROWW}) int32 on "
                                     f"{device}")
            if (soff.dtype != torch.int32 or soff.dim() != 1
                    or not soff.is_contiguous() or soff.device != device):
                raise ValueError(f"LevelTables: table {k}'s soff must be "
                                 f"contiguous 1-D int32 on {device}")
            base = int(base)
            if k == 0 and base != 0:
                raise ValueError("LevelTables: the first table's base must "
                                 "be 0")
            if base < last:
                raise ValueError("LevelTables: the tables' bases must ascend")
            last = base
            entries += (frows.data_ptr(), rrows.data_ptr(), soff.data_ptr(),
                        base)
        self.tables = tables
        self.device = device
        self.packed = array.array("q", entries)
        self.ptr = self.packed.buffer_info()[0]


def _table_list(tables) -> list:
    return tables.tables if isinstance(tables, LevelTables) else tables


def _views(out: dict) -> dict:
    out["nactive"] = out["sums"][..., 0]
    out["child_counts"] = out["sums"][..., 1:]
    return out


def _columns(tables, S: int):
    """(table, first column, end column) of each table with columns."""
    bases = [int(t[3]) for t in tables] + [S]
    return [(t, bases[k], bases[k + 1]) for k, t in enumerate(tables)
            if bases[k + 1] > bases[k]]


def expand_level_plain(tables, lo: torch.Tensor, hi: torch.Tensor,
                       rlo: torch.Tensor, valid: torch.Tensor,
                       fmin: int) -> dict:
    """Plain PyTorch version of the expand (any device): dsm_tpu's
    expand_core and leftchar_codes, a table at a time."""
    R, CAP, S = lo.shape
    device = lo.device
    pa = (hi > lo) & valid[..., None]                       # (R, CAP, S)
    freq = hi - lo
    shape4 = (R, CAP, 4, S)
    clo = torch.zeros(shape4, dtype=torch.int32, device=device)
    chi = torch.zeros_like(clo)
    crlo = torch.zeros_like(clo)
    lc = torch.zeros((R, CAP, S), dtype=torch.int8, device=device)
    for (frows, rrows, soff, _b), c0, c1 in _columns(_table_list(tables),
                                                     S):
        n = c1 - c0
        sl = (slice(None), slice(None), slice(c0, c1))
        so = soff.to(torch.int64)[None, None, :].expand(R, CAP, n).reshape(-1)
        lo_k, hi_k = lo[sl].reshape(-1), hi[sl].reshape(-1)
        rlo_k, fr_k = rlo[sl].reshape(-1), freq[sl].reshape(-1)
        olo = occ_cum8_plain(frows, lo_k, so).reshape(8, R, CAP, n)
        ohi = occ_cum8_plain(frows, hi_k, so).reshape(8, R, CAP, n)
        a = pa[sl][:, :, None, :]                           # (R, CAP, 1, n)
        clo[..., c0:c1] = torch.where(a, olo[:4].permute(1, 2, 0, 3), 0)
        chi[..., c0:c1] = torch.where(a, ohi[:4].permute(1, 2, 0, 3), 0)
        cr = _wrap32(rlo[sl].to(torch.int64)[:, :, None, :]
                     + (ohi[4:] - olo[4:]).permute(1, 2, 0, 3)
                     .to(torch.int64))
        crlo[..., c0:c1] = torch.where(a, cr, 0)
        # leftChar: right-extension counts at rlo and rlo + freq
        rl = occ_cum8_plain(rrows, rlo_k, so)
        rh = occ_cum8_plain(rrows, _wrap32(rlo_k.to(torch.int64)
                                           + fr_k.to(torch.int64)), so)
        rcnt = rh[:4] - rl[:4]                                # (4, K)
        is_full = (rcnt == fr_k[None, :]) & (fr_k[None, :] > 0)
        code = torch.where(
            is_full.any(dim=0), is_full.to(torch.int8).argmax(dim=0) + 2,
            torch.where((rcnt > 0).any(dim=0), LC_N, LC_ZERO))
        lc[sl] = torch.where(fr_k > 0, code, LC_ZERO).to(
            torch.int8).reshape(R, CAP, n)
    cact = pa[:, :, None, :] & (chi - clo >= fmin)
    sums = torch.cat([pa.sum(dim=2, dtype=torch.int32)[..., None],
                      cact.sum(dim=3, dtype=torch.int32)], dim=2)
    return _views(dict(clo=clo, chi=chi, crlo=crlo, cactive=cact, freq=freq,
                       lc=lc, sums=sums.contiguous()))


def _check_state(who: str, lo, hi, rlo, valid) -> None:
    if lo.dim() != 3:
        raise ValueError(f"{who}: the state must be (R, CAP, S)")
    for name, t in (("lo", lo), ("hi", hi), ("rlo", rlo)):
        if (t.dtype != torch.int32 or t.shape != lo.shape
                or not t.is_contiguous() or t.device != lo.device):
            raise ValueError(f"{who}: {name} must be contiguous (R, CAP, S) "
                             f"int32 on {lo.device}")
    if (valid.dtype != torch.bool or valid.shape != lo.shape[:2]
            or not valid.is_contiguous() or valid.device != lo.device):
        raise ValueError(f"{who}: valid must be contiguous (R, CAP) bool")


def expand_level(tables, lo: torch.Tensor, hi: torch.Tensor,
                 rlo: torch.Tensor, valid: torch.Tensor, fmin: int) -> dict:
    """The expand of a dense level (see the module's docstring) in one
    launch of K12.  tables: a LevelTables, or a list that is prepared here.
    CPU tensors take the plain version; CUDA tensors launch the kernel: the
    state contiguous, on the tables' device."""
    if not isinstance(tables, LevelTables) and lo.device.type != "cpu":
        tables = LevelTables(tables)
    if isinstance(tables, LevelTables) and tables.device != lo.device:
        raise ValueError(f"expand_level: the tables are on {tables.device}, "
                         f"the state on {lo.device}")
    if lo.device.type == "cpu":
        return expand_level_plain(tables, lo, hi, rlo, valid, fmin)
    device = lo.device
    if device.type != "cuda":
        raise ValueError(f"expand_level: unsupported device {device}")
    _check_state("expand_level", lo, hi, rlo, valid)
    R, CAP, S = lo.shape
    if R * CAP * S >= 2**31:
        raise ValueError(f"expand_level: {R} x {CAP} x {S} cells is past "
                         "the 2^31 the kernel counts in its tiles")
    shape4 = (R, CAP, 4, S)
    clo = torch.empty(shape4, dtype=torch.int32, device=device)
    chi = torch.empty_like(clo)
    crlo = torch.empty_like(clo)
    cact = torch.empty(shape4, dtype=torch.bool, device=device)
    freq = torch.empty((R, CAP, S), dtype=torch.int32, device=device)
    lc = torch.empty((R, CAP, S), dtype=torch.int8, device=device)
    sums = torch.empty((R, CAP, SUM_COLS), dtype=torch.int32, device=device)
    _build.launch("dsm_level_expand", "level_expand", device, tables.ptr,
                  len(tables.tables), lo.data_ptr(), hi.data_ptr(),
                  rlo.data_ptr(), valid.data_ptr(), R * CAP, S, int(fmin),
                  clo.data_ptr(), chi.data_ptr(), crlo.data_ptr(),
                  cact.data_ptr(), freq.data_ptr(), lc.data_ptr(),
                  sums.data_ptr())
    return _views(dict(clo=clo, chi=chi, crlo=crlo, cactive=cact, freq=freq,
                       lc=lc, sums=sums))


def compact_level_plain(core: dict, sums: torch.Tensor,
                        sym_mask: torch.Tensor) -> dict:
    """Plain PyTorch version of the analyse-and-compact (any device):
    dsm_tpu's analyze_children and compact_children, a stable argsort a
    row."""
    R, CAP, _4, S = core["clo"].shape
    device = sums.device
    cc, na = sums[..., 1:], sums[..., 0]
    union = (cc > 0) & sym_mask[:, None, :]                 # (R, CAP, 4)
    first = union.to(torch.int8).argmax(dim=2)
    single_full = (union.sum(dim=2) == 1) & (
        cc.gather(2, first[..., None])[..., 0] == na)
    flat = union.reshape(R, CAP * 4)
    perm = torch.argsort((~flat).to(torch.int8), dim=1, stable=True)
    child_count = flat.sum(dim=1, dtype=torch.int32)
    sel = perm[:, :CAP]
    valid = (torch.arange(CAP, device=device)[None, :]
             < child_count[:, None])
    rows = torch.arange(R, device=device)[:, None]

    def take(name):
        return core[name].reshape(R, CAP * 4, S)[rows, sel]  # (R, CAP, S)

    keep = take("cactive") & valid[..., None]
    return dict(lo=torch.where(keep, take("clo"), 0),
                hi=torch.where(keep, take("chi"), 0),
                rlo=torch.where(keep, take("crlo"), 0),
                valid=valid, parent_row=(sel // 4).to(torch.int32),
                sym=(sel % 4).to(torch.int32), child_count=child_count,
                single_full=single_full)


def _compact_state(device, tiles: int):
    """K13's (status words and ticket, flag words) on the current stream
    of `device`, with room for `tiles` tiles."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    status, bits = _COMPACT_STATES.get(key, (None, None))
    if status is None or status.shape[0] < tiles + 1:
        status = torch.zeros(1 << tiles.bit_length(), dtype=torch.int64,
                             device=device)
    if bits is None or bits.shape[0] < tiles * TILE_THREADS:
        bits = torch.empty((1 << max(tiles - 1, 1).bit_length())
                           * TILE_THREADS, dtype=torch.int16, device=device)
    _COMPACT_STATES[key] = status, bits
    return status, bits


def compact_level(core: dict, sums: torch.Tensor,
                  sym_mask: torch.Tensor) -> dict:
    """The analyse-and-compact of a dense level (see the module's
    docstring) in one launch of K13.  core: expand_level's output (its
    clo, chi, crlo and cactive); sums: its (R, CAP, 5) sums, or their sum
    over every process of a group.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, a cooperative launch of the card's
    resident blocks (a launch the card refuses raises)."""
    if sums.device.type == "cpu":
        return compact_level_plain(core, sums, sym_mask)
    device = sums.device
    if device.type != "cuda":
        raise ValueError(f"compact_level: unsupported device {device}")
    R, CAP, _4, S = core["clo"].shape
    for name in ("clo", "chi", "crlo", "cactive"):
        t = core[name]
        dtype = torch.bool if name == "cactive" else torch.int32
        if (t.dtype != dtype or t.shape != (R, CAP, 4, S)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"compact_level: {name} must be contiguous "
                             f"(R, CAP, 4, S) {dtype} on {device}")
    if (sums.dtype != torch.int32 or sums.shape != (R, CAP, SUM_COLS)
            or not sums.is_contiguous()):
        raise ValueError(f"compact_level: sums must be contiguous "
                         f"(R, CAP, {SUM_COLS}) int32")
    if (sym_mask.dtype != torch.bool or sym_mask.shape != (R, 4)
            or not sym_mask.is_contiguous() or sym_mask.device != device):
        raise ValueError(f"compact_level: sym_mask must be contiguous (R, 4) "
                         f"bool on {device}")
    if not 1 <= R <= MAX_ROWS or CAP < 1:
        raise ValueError(f"compact_level: takes 1 to {MAX_ROWS} rows of at "
                         f"least one node (got {R} x {CAP})")
    if 4 * CAP >= 2**31:
        raise ValueError(f"compact_level: {CAP} nodes a row is past the "
                         "32-bit flag counts")
    if R * CAP * S >= 2**31:
        raise ValueError(f"compact_level: {R} x {CAP} x {S} cells is past "
                         "the 2^31 the kernel counts in")
    lo = torch.empty((R, CAP, S), dtype=torch.int32, device=device)
    hi = torch.empty_like(lo)
    rlo = torch.empty_like(lo)
    valid = torch.empty((R, CAP), dtype=torch.bool, device=device)
    parent_row = torch.empty((R, CAP), dtype=torch.int32, device=device)
    sym = torch.empty_like(parent_row)
    child_count = torch.empty(R, dtype=torch.int32, device=device)
    single_full = torch.empty((R, CAP), dtype=torch.bool, device=device)
    status, bits = _compact_state(device, R * -(-4 * CAP // TILE_FLAGS))
    _build.launch("dsm_level_compact", "level_compact", device,
                  sums.data_ptr(), sym_mask.data_ptr(),
                  core["clo"].data_ptr(), core["chi"].data_ptr(),
                  core["crlo"].data_ptr(), core["cactive"].data_ptr(), R, CAP,
                  S, lo.data_ptr(), hi.data_ptr(), rlo.data_ptr(),
                  valid.data_ptr(), parent_row.data_ptr(), sym.data_ptr(),
                  child_count.data_ptr(), single_full.data_ptr(),
                  status.data_ptr(), bits.data_ptr())
    return dict(lo=lo, hi=hi, rlo=rlo, valid=valid, parent_row=parent_row,
                sym=sym, child_count=child_count, single_full=single_full)
