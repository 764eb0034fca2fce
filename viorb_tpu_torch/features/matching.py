"""Descriptor matching: Hamming distance as a matmul, and the gates of the
Search* family as boolean masks (port of viorb_tpu/features/matching.py).

For descriptors recoded to {-1,+1}^256, <a, b> = 256 - 2*Hamming(a,b), so
one f32 matmul gives the whole N x M distance matrix. Every product and
partial sum is a small integer, so with TF32 off the result is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import math
from typing import Optional, Union

import torch

N_BITS = 256
TH_LOW = 50.0
HISTO_BINS = 30
BIG = 1e9


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """desc_{a,b}: (N,256)/(M,256) in {-1,+1} -> (N,M) f32 Hamming
    distances. Invalid (all-zero) rows give 128; mask them separately."""
    sim = desc_a.to(torch.float32) @ desc_b.to(torch.float32).T
    return 0.5 * (N_BITS - sim)


class MatchResult(NamedTuple):
    """idx: (N,) best column per row (-1 if no match); dist: (N,) distance."""

    idx: torch.Tensor
    dist: torch.Tensor


def match_with_mask(
    dist: torch.Tensor,
    allowed: torch.Tensor,
    max_dist: float = TH_LOW,
    ratio: float = 1.0,
    mutual: bool = True,
) -> MatchResult:
    """Row-wise best match under a boolean gate matrix: distance threshold,
    best/second-best ratio test, and mutual best.

    The reference takes the two smallest per row with `jax.lax.top_k`,
    which breaks ties to the lowest index. `torch.topk` promises no tie
    order, so the best is `argmin` (the first minimum) and the second is
    the minimum of the row with that one column excluded: the same values
    and the same best index."""
    big = torch.full((), BIG, dtype=dist.dtype, device=dist.device)
    d = torch.where(allowed, dist, big)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == best_idx[:, None], torch.inf, d).amin(dim=1)
    ok = (best <= max_dist) & (best <= ratio * second)
    if mutual:
        col_best = torch.argmin(d, dim=0)  # (M,)
        ok &= col_best[best_idx] == torch.arange(d.shape[0], device=d.device)
    minus_one = torch.full_like(best_idx, -1)
    return MatchResult(torch.where(ok, best_idx, minus_one), torch.where(ok, best, big))


def rotation_consistency_mask(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    idx: torch.Tensor,
    n_bins: int = HISTO_BINS,
    keep_bins: int = 3,
) -> torch.Tensor:
    """The rotation-histogram filter: histogram the per-match angle
    deltas, keep only matches in the `keep_bins` most popular bins; a lower
    bin only counts if it holds >= 10 % of the best bin. Returns (N,) bool.
    Equal counts rank by lowest bin, as `jax.lax.top_k` ranks them."""
    valid = idx >= 0
    da = torch.remainder(angle_a - angle_b[idx.clamp(min=0)], 2 * math.pi)
    bins = (da * (n_bins / (2 * math.pi))).to(torch.int64).clamp(0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, bins, valid.to(torch.int64))
    order = torch.sort(counts, descending=True, stable=True)
    top_counts, top_bins = order.values[:keep_bins], order.indices[:keep_bins]
    keep = top_counts >= (0.1 * top_counts[0]).to(torch.int64).clamp(min=1)
    in_top = ((bins[:, None] == top_bins[None, :]) & keep[None, :]).any(dim=1)
    return valid & in_top


def window_gate(
    xy_a: torch.Tensor,
    xy_b: torch.Tensor,
    radius: Union[torch.Tensor, float],
    level_a: Optional[torch.Tensor] = None,
    level_b: Optional[torch.Tensor] = None,
    max_level_diff: int = 1,
) -> torch.Tensor:
    """(N,2),(M,2) -> (N,M) bool: |xy_a - xy_b| within radius (a number or
    a per-row (N,) tensor) and, given both levels, pyramid-level agreement:
    the projection-window gate."""
    d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
    if isinstance(radius, torch.Tensor) and radius.dim() == 1:
        r2 = (radius**2)[:, None]
    else:
        r2 = radius**2
    gate = d2 <= r2
    if level_a is not None and level_b is not None:
        gate &= (level_a[:, None] - level_b[None, :]).abs() <= max_level_diff
    return gate


def valid_gate(valid_a: torch.Tensor, valid_b: torch.Tensor) -> torch.Tensor:
    return valid_a[:, None] & valid_b[None, :]
