"""Descriptor matching ops — masked, fixed-shape.

Counterpart of gl_slam_tpu/ops/match.py: `matches0[i]` is the index in set 1
matched to keypoint i of set 0, -1 = unmatched, plus a per-match score.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    matches0: torch.Tensor  # (N,) int32 index into set 1, -1 = none
    mscores0: torch.Tensor  # (N,) float32 match confidence


def mutual_nn_match(desc0, valid0, desc1, valid1,
                    min_score: float = 0.0) -> MatchResult:
    """Mutual nearest-neighbour matching on unit-norm descriptors; scores
    are cosine similarities remapped to [0, 1]."""
    sim = desc0.float() @ desc1.float().T
    sim = torch.where(valid0[:, None] & valid1[None, :], sim, -1e9)
    nn0 = torch.argmax(sim, dim=1)
    nn1 = torch.argmax(sim, dim=0)
    best0 = sim.amax(dim=1)
    mutual = nn1[nn0] == torch.arange(sim.shape[0], device=sim.device)
    score01 = 0.5 * (best0 + 1.0)
    ok = mutual & valid0 & (score01 > min_score) & (best0 > -1e8)
    return MatchResult(matches0=torch.where(ok, nn0, -1).to(torch.int32),
                       mscores0=torch.where(ok, score01, 0.0))


def score_filter(matches0, mscores0, threshold: float) -> torch.Tensor:
    """`lightglue_score_filter` semantics: valid match AND score > thr."""
    return (matches0 >= 0) & (mscores0 > threshold)


def gather_matched(kpts0, kpts1, matches0, pair_mask):
    """Aligned correspondences: row i is (kpt0[i], kpt1[matches0[i]]),
    garbage where ~pair_mask. Leading batch dimensions are allowed."""
    idx = matches0.long().clamp(0, kpts1.shape[-2] - 1)
    idx = idx[..., None].expand(*idx.shape, kpts1.shape[-1])
    return kpts0, torch.gather(kpts1, -2, idx), pair_mask
