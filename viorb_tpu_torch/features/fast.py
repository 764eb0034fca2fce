"""FAST corner detection over the whole image plane, and the per-cell
top-K keypoint selection.

Port of viorb_tpu/features/fast.py. `fast_score_map` sends a CUDA tensor
to the hand-written kernel (features/fast_cuda.py) and a CPU tensor to
`_fast_score_map_torch`, the plain version: the same rolled min/max tree
as the reference's `_fast_score_map_jnp`, bit for bit.

The reference's `grid_topk_keypoints` is two halves here. The first masks
the border and takes each cell's maximum and argmax; for a whole pyramid
it is `fast_cells_pyramid`, which on the card is one launch of the same
kernel for all levels, with no score map written, and on the CPU the
plain `_fast_cells_pyramid_torch`. The second, `topk_from_cells`, ranks a
level's cells and turns them into keypoints.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock —
# standard FAST-16 geometry.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # contiguous run length for FAST-9/16


def fast_score_map(image: torch.Tensor) -> torch.Tensor:
    """(H,W) f32 -> (H,W) f32 corner score (0 where not a corner at t=0),
    3 px border zeroed. CUDA tensors run the K1 kernel; CPU tensors the
    plain version."""
    if image.is_cuda:
        from viorb_tpu_torch.features.fast_cuda import fast_score_map_cuda

        return fast_score_map_cuda(image)
    if image.device.type != "cpu":
        raise ValueError(f"fast_score_map: unsupported device {image.device}")
    return _fast_score_map_torch(image)


def _fast_score_map_torch(image: torch.Tensor) -> torch.Tensor:
    c = image
    neigh = torch.stack(
        [torch.roll(image, (-dy, -dx), dims=(0, 1)) for dy, dx in CIRCLE_OFFSETS]
    )  # (16,H,W)
    bright = neigh - c[None]  # p_i - c
    dark = -bright

    def arc_strength(d):
        # max over 16 circular windows of the min over ARC_LEN = 8 + 1
        # entries: m8 by log-step rolled mins, then min(m8, roll 8)
        m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        m9 = torch.minimum(m8, torch.roll(d, -8, dims=0))
        return m9.amax(dim=0)

    score = torch.maximum(arc_strength(bright), arc_strength(dark))
    score = score.clamp(min=0.0)
    # zero the 3 px border (rolled values wrap around there)
    score[:3, :] = 0.0
    score[-3:, :] = 0.0
    score[:, :3] = 0.0
    score[:, -3:] = 0.0
    return score


def cell_offsets(shapes: Sequence[Tuple[int, int]], cell: int) -> List[int]:
    """Offsets of each level's cells in the flat outputs of
    `fast_cells_pyramid`: level l, of shape (h, w), holds
    (h // cell) * (w // cell) cells row-major at [offsets[l], offsets[l+1])."""
    offsets = [0]
    for h, w in shapes:
        offsets.append(offsets[-1] + (h // cell) * (w // cell))
    return offsets


def fast_cells_pyramid(pyramid: Sequence[torch.Tensor], cell: int = 16, border: int = 19):
    """FAST score, border mask and per-cell maximum of every level at once.

    pyramid: (H_l, W_l) f32 images on one device. Returns (cell_best f32,
    cell_arg int64, offsets): flat over the levels (see `cell_offsets`),
    per `cell` x `cell` block the best score inside
    [border, H-border) x [border, W-border) and the in-cell flat index
    row * cell + col of its first occurrence (0 in an all-zero cell). CUDA
    tensors run the fused kernel in one launch; CPU tensors the plain
    version."""
    dev = pyramid[0].device
    if dev.type == "cuda":
        from viorb_tpu_torch.features.fast_cuda import fast_cells_cuda

        return fast_cells_cuda(pyramid, cell, border)
    if dev.type != "cpu":
        raise ValueError(f"fast_cells_pyramid: unsupported device {dev}")
    return _fast_cells_pyramid_torch(pyramid, cell, border)


def _fast_cells_pyramid_torch(pyramid: Sequence[torch.Tensor], cell: int = 16, border: int = 19):
    cells = [_cells_from_score(_fast_score_map_torch(img), cell, border) for img in pyramid]
    return (
        torch.cat([best for best, _ in cells]),
        torch.cat([arg for _, arg in cells]),
        cell_offsets([img.shape for img in pyramid], cell),
    )


def _cells_from_score(score: torch.Tensor, cell: int, border: int):
    """Zero the score outside [border, h-border) x [border, w-border), then
    per `cell` x `cell` block its maximum and the in-cell flat index of the
    first maximum: two flat (hc * wc,) tensors, row-major."""
    h, w = score.shape
    dev = score.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    inside = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    score = torch.where(inside, score, torch.zeros((), dtype=score.dtype, device=dev))
    hc, wc = h // cell, w // cell
    s = score[: hc * cell, : wc * cell].reshape(hc, cell, wc, cell)
    s = s.permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    return s.amax(dim=-1), torch.argmax(s, dim=-1)


def topk_from_cells(
    cell_best: torch.Tensor,
    cell_arg: torch.Tensor,
    wc: int,
    n_target: int,
    cell: int = 16,
    min_score: float = 7.0,
):
    """The top-`n_target` cells of one level by score, as keypoints.

    cell_best, cell_arg: that level's flat (hc * wc,) cell maxima and
    in-cell indices. Returns (ys, xs, scores, valid), each (n_target,);
    ys/xs are int64. Ties go to the lowest cell index, as `jax.lax.top_k`
    breaks them in the reference: the ranking is a stable descending
    sort."""
    k = min(n_target, cell_best.shape[0])
    order = torch.sort(cell_best, descending=True, stable=True)
    top_scores = order.values[:k]
    top_cells = order.indices[:k]
    cy = top_cells // wc
    cx = top_cells % wc
    inner = cell_arg[top_cells]
    ys = cy * cell + inner // cell
    xs = cx * cell + inner % cell
    valid = top_scores > min_score
    if k < n_target:  # pad
        pad = n_target - k
        ys = torch.cat([ys, ys.new_zeros(pad)])
        xs = torch.cat([xs, xs.new_zeros(pad)])
        top_scores = torch.cat([top_scores, top_scores.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return ys, xs, top_scores, valid


def grid_topk_keypoints(
    score: torch.Tensor,
    n_target: int,
    cell: int = 16,
    min_score: float = 7.0,
    border: int = 19,
):
    """Best corner per `cell` x `cell` block, then the top-`n_target`
    cells by score. Returns (ys, xs, scores, valid), each (n_target,);
    ys/xs are int64. Ties go to the lowest index, as `jax.lax.top_k` and
    `argmax` break them in the reference."""
    cell_best, cell_arg = _cells_from_score(score, cell, border)
    return topk_from_cells(
        cell_best, cell_arg, score.shape[1] // cell, n_target, cell, min_score
    )
