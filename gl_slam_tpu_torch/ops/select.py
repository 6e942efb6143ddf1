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


def select_newest_ids(mask: torch.Tensor, M: int):
    """Up to M set positions of `mask`, HIGHEST index first (map tables
    allocate point ids in creation order). Returns (ids (M,) int32 with -1
    padding, valid (M,) bool)."""
    n = mask.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=mask.device)
    prio = torch.where(mask, ar, -1)
    top, _ = topk_stable(prio, M)
    return top, top >= 0
