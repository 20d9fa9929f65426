"""The port's children step (dsm_tpu_torch/ops/children.py, K3) against a
numpy statement of dsm_tpu's hv-keyed sort (engine_device._level_single,
lines 789-846).

The kept (pair, symbol) lanes are ordered by node, then symbol, then
ascending pair; child ids number the (node, symbol) groups in that order;
nb_next holds each child's first row and then the pair count; the history
entries are node*4 + symbol.  Random node layouts on CPU tensors (the
kernel's plain version), among them nodes that keep nothing, a node of
512 pairs (MAX_SAMPLES), no pairs at all, a level that keeps nothing and
a restricted symbol mask, and nodes of up to 64 and up to 273 pairs (the
sample counts of wider collections) with nodes that hold no pair at all.
Exact.  The outside-ids form (`children_ids`, one shard of a sharded
level) is held against the same statement with the ids taken from a
global numbering in which other shards keep lanes too.
tests/test_torch_level.py holds the whole level, children included,
against `_level_single`.
"""

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops.children import (PC_NID, PC_RLO, PC_SID, PC_SOFF,
                                        children, children_ids)
from dsm_tpu_torch.ops.segstats import EXISTS_SHIFT

# node sizes, kept share, symbol mask, share of nodes that keep nothing
CASES = {
    "mixed": ("1-5", 0.3, 0b1111, 0.0),
    "empty_nodes": ("1-5", 0.5, 0b1111, 0.4),
    "node_512": ("512", 0.3, 0b1111, 0.0),
    "no_pairs": ("none", 0.3, 0b1111, 0.0),
    "nothing_kept": ("1-5", 0.0, 0b1111, 0.0),
    "restricted_mask": ("1-5", 0.6, 0b0100, 0.0),
    "all_kept": ("1-5", 1.0, 0b1111, 0.0),
    "d64": ("1-64", 0.3, 0b1111, 0.1),
    "d273": ("1-273", 0.3, 0b1111, 0.1),
    "d64_no_pair_nodes": ("0-64", 0.4, 0b1111, 0.0),
    "d273_no_pair_nodes": ("0-273", 0.4, 0b1111, 0.0),
    "d273_nothing_kept": ("0-273", 0.0, 0b1111, 0.0),
    "long_run_without_pairs": ("gap", 0.5, 0b1111, 0.0),
}


def _layout(rng, case):
    sizes_kind, frac, sym_mask, empty = CASES[case]
    if sizes_kind == "none":
        sizes = np.zeros(0, dtype=np.int64)
    elif sizes_kind == "512":
        sizes = rng.integers(1, 6, size=300)
        sizes[137] = 512
    elif sizes_kind == "gap":
        sizes = np.concatenate([[3], np.zeros(1500, np.int64), [2, 0, 0]])
    elif sizes_kind.startswith("0-"):     # a third of the nodes hold no pair
        sizes = rng.integers(1, int(sizes_kind[2:]) + 1, size=120)
        sizes[rng.random(120) < 0.33] = 0
    else:
        lo, hi = map(int, sizes_kind.split("-"))
        sizes = rng.integers(lo, hi + 1, size=2000 if hi <= 5 else 120)
    U = sizes.size
    nb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(nb[-1])
    node = np.repeat(np.arange(U), sizes)
    pairs = rng.integers(-2**31, 2**31, size=(P, 6)).astype(np.int32)
    pairs[:, PC_NID] = node
    olo = rng.integers(-2**31, 2**31 - 5000, size=(8, P))
    ohi = olo + rng.integers(0, 5000, size=(8, P))
    keep = rng.random((4, P)) < frac
    keep &= (((sym_mask >> np.arange(4)) & 1) > 0)[:, None]
    keep[:, (rng.random(U) < empty)[node]] = False
    return nb, pairs, olo.astype(np.int32), ohi.astype(np.int32), keep


def _children_np(pairs, olo, ohi, keep):
    """The JAX sort order, stated directly."""
    node = pairs[:, PC_NID].astype(np.int64)
    c, p = np.nonzero(keep)
    order = np.lexsort((p, c, node[p]))
    c, p = c[order], p[order]
    hv = node[p] * 4 + c
    bdry = np.ones(hv.size, dtype=bool)
    bdry[1:] = hv[1:] != hv[:-1]
    crlo = (pairs[p, PC_RLO].astype(np.int64) + ohi[4 + c, p]
            - olo[4 + c, p])
    rows = np.stack([olo[c, p], ohi[c, p],
                     ((crlo + 2**31) % 2**32 - 2**31), pairs[p, PC_SID],
                     pairs[p, PC_SOFF], np.cumsum(bdry) - 1],
                    axis=1).astype(np.int32)
    nb_next = np.append(np.flatnonzero(bdry), hv.size).astype(np.int32)
    return rows, nb_next, hv[bdry].astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_children_matches_sort_order(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    nb, pairs, olo, ohi, keep = _layout(rng, case)
    want_rows, want_nb, want_hist = _children_np(pairs, olo, ohi, keep)
    pair_count, child_total = want_rows.shape[0], want_hist.size
    hist = torch.full((child_total + 7,), -9, dtype=torch.int32)
    got_rows, got_nb = children(
        torch.from_numpy(nb), torch.from_numpy(pairs), torch.from_numpy(olo),
        torch.from_numpy(ohi), torch.from_numpy(keep), pair_count,
        child_total, hist)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    np.testing.assert_array_equal(got_nb.numpy(), want_nb)
    np.testing.assert_array_equal(hist[:child_total].numpy(), want_hist)
    assert (hist[child_total:] == -9).all()


@pytest.mark.parametrize("case", [c for c in CASES if c != "no_pairs"])
def test_children_ids_matches_sort_order(case):
    """One shard of a sharded level: the ids come from a numbering in
    which symbols that only other shards keep exist too, so such a child
    gets an empty segment here; rows and segments follow the same (node,
    symbol, pair) order."""
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    nb, pairs, olo, ohi, keep = _layout(rng, case)
    U = nb.size - 1
    node = pairs[:, PC_NID].astype(np.int64)
    exists = rng.random((U, 4)) < 0.25            # kept by another shard
    c, p = np.nonzero(keep)
    exists[node[p], c] = True
    nchild = exists.sum(1)
    kid0 = (np.cumsum(nchild) - nchild).astype(np.int32)
    child_total = int(nchild.sum())
    flags = (((exists << np.arange(4)).sum(1) << EXISTS_SHIFT) | 5).astype(
        np.int32)

    order = np.lexsort((p, c, node[p]))
    c, p = c[order], p[order]
    kid_of = kid0[:, None] + np.cumsum(exists, 1) - exists      # (U, 4)
    crlo = (pairs[p, PC_RLO].astype(np.int64) + ohi[4 + c, p]
            - olo[4 + c, p])
    want_rows = np.stack([olo[c, p], ohi[c, p],
                          ((crlo + 2**31) % 2**32 - 2**31), pairs[p, PC_SID],
                          pairs[p, PC_SOFF], kid_of[node[p], c]],
                         axis=1).astype(np.int32).reshape(-1, 6)
    lanes = np.bincount(kid_of[node[p], c], minlength=child_total)
    want_nb = np.concatenate([[0], np.cumsum(lanes)]).astype(np.int32)

    got_rows, got_nb = children_ids(
        torch.from_numpy(nb), torch.from_numpy(pairs), torch.from_numpy(olo),
        torch.from_numpy(ohi), torch.from_numpy(keep),
        torch.from_numpy(flags), torch.from_numpy(kid0), int(keep.sum()),
        child_total)
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    np.testing.assert_array_equal(got_nb.numpy(), want_nb)
