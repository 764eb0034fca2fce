"""Image pyramid (port of viorb_tpu/features/pyramid.py).

The reference resizes with `jax.image.resize(method="linear",
antialias=False)`, which builds one dense (in, out) triangle-weight matrix
per axis (jax/_src/image/scale.py::compute_weight_mat) and applies both in
one einsum. The port builds the same matrices with the same f32 arithmetic
and applies them as two matmuls, in the order opt_einsum picks for that
einsum (the cheaper contraction first). `F.interpolate` computes its
weights differently and disagrees on 20-56 % of pixels, so it is not used.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    # Python's round: half to even, as in the reference
    return [
        (int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)
    ]


def linear_weight_mat(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) f32 linear-interpolation weights, op for op as
    jax's compute_weight_mat(n_in, n_out, n_out / n_in, 0., triangle,
    antialias=False)."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))  # jax's weak-typed f32
    centers = torch.arange(n_out, dtype=torch.float32) + 0.5
    if n_in * n_out >= 10_000:
        # compiled by XLA:CPU, which contracts `(j + 0.5) * inv_scale - 0.5`
        # into one fused multiply-add; in f64 the product and difference
        # are exact, so one rounding to f32 reproduces it bit for bit
        sample_f = (centers.double() * inv_scale - 0.5).float()
    else:
        # small matrices are constant-folded by XLA, without the fusion
        # (the 10k-element boundary is where the two were measured to part)
        sample_f = centers * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


_WEIGHT_CACHE: dict = {}


def _weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    key = (n_in, n_out, str(device))
    w = _WEIGHT_CACHE.get(key)
    if w is None:
        w = _WEIGHT_CACHE[key] = linear_weight_mat(n_in, n_out, device)
    return w


def resize_linear(image: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(H,W) f32 -> `shape`, as jax.image.resize(linear, antialias=False)."""
    h, w = image.shape
    ho, wo = shape
    if (ho, wo) == (h, w):
        return image
    if ho == h:
        return image @ _weights(w, wo, image.device)
    if wo == w:
        return _weights(h, ho, image.device).T @ image
    wh = _weights(h, ho, image.device)
    ww = _weights(w, wo, image.device)
    # opt_einsum's choice for "HW,Hh,Ww->hw": the path with fewer flops
    if h * w * ho + ho * w * wo <= h * w * wo + h * wo * ho:
        return (wh.T @ image) @ ww
    return wh.T @ (image @ ww)


def build_pyramid(
    image: torch.Tensor, n_levels: int = 8, scale: float = 1.2
) -> List[torch.Tensor]:
    """image: (H,W) f32. Returns a list of (Hl,Wl) f32, level 0 first; each
    level is resized from the previous one, as in the reference."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale)
    out = [image]
    for l in range(1, n_levels):
        out.append(resize_linear(out[-1], shapes[l]))
    return out


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)
