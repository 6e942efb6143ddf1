"""Fixed-size masked index selection and a tie-stable top-k.

Counterpart of gl_slam_tpu/ops/select.py. `lax.top_k` breaks ties toward
the LOWER index; `torch.topk` promises no order among equal values, and the
map's priority keys are integers full of ties (and suppressed heatmaps are
full of zeros), so every top-k of the port goes through `topk_stable`: a
stable descending sort, which keeps equal keys in index order.
"""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along `dim`, ties to the
    lower index — the `lax.top_k` contract."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def select_lowest_ids(mask: torch.Tensor, M: int):
    """Up to M set positions of `mask` (..., n), LOWEST index first.
    Returns (ids (..., M) int32 with -1 padding, valid (..., M) bool);
    overflow drops the highest indices."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)
    top, _ = topk_stable(torch.where(mask, n - ar, -1), M)
    ids = torch.where(top >= 0, n - top, -1).to(torch.int32)
    return ids, ids >= 0


def select_newest_ids(mask: torch.Tensor, M: int):
    """Up to M set positions of `mask` (..., n), HIGHEST index first (map
    tables allocate point ids in creation order). Returns (ids (..., M)
    int32 with -1 padding, valid (..., M) bool)."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)
    prio = torch.where(mask, ar, -1)
    top, _ = topk_stable(prio, M)
    return top, top >= 0


# The JAX package's alternative formulations of the two selections (cumsum
# rank + scatter, and searchsorted over the prefix counts), with the same
# contract on a 1-D mask: (ids (M,) int32 with -1 padding, valid (M,)).

def _rank_to_ids(pos: torch.Tensor, mask: torch.Tensor, M: int):
    n = mask.shape[-1]
    pos = torch.where(mask, pos, M).clamp(0, M).long()
    ids = torch.full((M + 1,), -1, dtype=torch.int32, device=mask.device)
    ids = ids.scatter(0, pos, torch.arange(n, dtype=torch.int32,
                                           device=mask.device))[:M]
    return ids, ids >= 0


def select_lowest_ids_cumsum(mask: torch.Tensor, M: int):
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1       # rank among set
    return _rank_to_ids(pos, mask, M)


def select_newest_ids_cumsum(mask: torch.Tensor, M: int):
    # rank 0 = last set element: count set entries strictly after i
    pos = torch.cumsum(mask.flip(0).to(torch.int32), 0).flip(0) - 1
    return _rank_to_ids(pos, mask, M)


def select_newest_ids_ss(mask: torch.Tensor, M: int):
    """Rank -> index by binary search over the (monotone) suffix counts."""
    c = torch.cumsum(mask.flip(0).to(torch.int32), 0)
    j = torch.arange(M, dtype=torch.int32, device=mask.device)
    rpos = torch.searchsorted(c, j + 1, side="left").to(torch.int32)
    valid = j < c[-1]
    ids = mask.shape[0] - 1 - rpos
    return torch.where(valid, ids, -1).to(torch.int32), valid


def select_lowest_ids_ss(mask: torch.Tensor, M: int):
    c = torch.cumsum(mask.to(torch.int32), 0)
    j = torch.arange(M, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(c, j + 1, side="left").to(torch.int32)
    valid = j < c[-1]
    return torch.where(valid, pos, -1).to(torch.int32), valid
