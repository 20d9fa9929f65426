"""The port's children step (dsm_tpu_torch/ops/children.py, K3) against a
numpy statement of dsm_tpu's hv-keyed sort (engine_device._level_single,
lines 789-846).

The kept (pair, symbol) lanes are ordered by node, then symbol, then
ascending pair; child ids number the (node, symbol) groups in that order;
nb_next holds each child's first row and then the pair count; the history
entries are node*4 + symbol.  Random node layouts on CPU tensors (the
kernel's plain version), among them nodes that keep nothing, a node of
512 pairs (MAX_SAMPLES), no pairs at all, a level that keeps nothing and
a restricted symbol mask.  Exact.  tests/test_torch_level.py holds the
whole level, children included, against `_level_single`.
"""

import numpy as np
import pytest
import torch

from dsm_tpu_torch.ops.children import (PC_NID, PC_RLO, PC_SID, PC_SOFF,
                                        children)

# node sizes, kept share, symbol mask, share of nodes that keep nothing
CASES = {
    "mixed": ("1-5", 0.3, 0b1111, 0.0),
    "empty_nodes": ("1-5", 0.5, 0b1111, 0.4),
    "node_512": ("512", 0.3, 0b1111, 0.0),
    "no_pairs": ("none", 0.3, 0b1111, 0.0),
    "nothing_kept": ("1-5", 0.0, 0b1111, 0.0),
    "restricted_mask": ("1-5", 0.6, 0b0100, 0.0),
    "all_kept": ("1-5", 1.0, 0b1111, 0.0),
}


def _layout(rng, case):
    sizes_kind, frac, sym_mask, empty = CASES[case]
    if sizes_kind == "none":
        sizes = np.zeros(0, dtype=np.int64)
    elif sizes_kind == "512":
        sizes = rng.integers(1, 6, size=300)
        sizes[137] = 512
    else:
        sizes = rng.integers(1, 6, size=2000)
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
