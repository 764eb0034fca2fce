"""Descriptor matching: Hamming distance as a matmul (port of
viorb_tpu/features/matching.py: the part the tracking step uses).

For descriptors recoded to {-1,+1}^256, <a, b> = 256 - 2*Hamming(a,b), so
one f32 matmul gives the whole N x M distance matrix. Every product and
partial sum is a small integer, so with TF32 off the result is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_BITS = 256
TH_LOW = 50.0
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


def valid_gate(valid_a: torch.Tensor, valid_b: torch.Tensor) -> torch.Tensor:
    return valid_a[:, None] & valid_b[None, :]
