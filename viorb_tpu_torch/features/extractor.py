"""The full ORB extractor: pyramid -> FAST -> distribute -> orient ->
describe (port of viorb_tpu/features/extractor.py).

All shapes are static, as in the reference: each level contributes a
fixed quota of keypoint slots (validity-masked), totalling `capacity`,
and every level's keypoints take their patches from one edge-padded
pyramid atlas in a single batched pass.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from viorb_tpu_torch.device import default_device
from viorb_tpu_torch.features.fast import fast_cells_pyramid, topk_from_cells
from viorb_tpu_torch.features.orb import (
    EDGE_MARGIN,
    PATCH_HALF,
    blur_patches,
    gather_patches,
    patch_descriptors,
    patch_moments,
)
from viorb_tpu_torch.features.pyramid import build_pyramid


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set.

    xy: (N,2) f32 keypoint positions in level-0 pixel coords (x, y);
    response: (N,) FAST arc score; angle: (N,) radians; level: (N,) int64;
    desc01: (N,256) uint8 {0,1}; valid: (N,) bool.
    """

    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    level: torch.Tensor
    desc01: torch.Tensor
    valid: torch.Tensor

    def descriptors_pm1(self, dtype=torch.float32) -> torch.Tensor:
        """{0,1} -> {-1,+1} recode for Hamming matching by matmul; invalid
        rows are all zero. (The reference's default is bf16; f32 holds
        +-1 exactly too, and f32 matmuls run without TF32 here.)"""
        return (self.desc01.to(dtype) * 2.0 - 1.0) * self.valid[:, None].to(dtype)


class OrbExtractor:
    """n_features, n_levels=8, scale=1.2, FAST thresholds 20/7, as the
    reference configures it."""

    def __init__(
        self,
        n_features: int = 1000,
        n_levels: int = 8,
        scale_factor: float = 1.2,
        fast_threshold: float = 20.0,
        fast_min_threshold: float = 7.0,
        cell: int = 16,
    ):
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_threshold = fast_threshold
        self.fast_min_threshold = fast_min_threshold
        self.cell = cell
        # per-level quotas ~ geometric decay
        inv = 1.0 / scale_factor
        weights = np.array([inv**l for l in range(n_levels)])
        quota = np.floor(n_features * weights / weights.sum()).astype(int)
        quota[0] += n_features - quota.sum()
        self.level_quota = [int(q) for q in quota]
        self.capacity = int(sum(self.level_quota))
        self.scales = [scale_factor**l for l in range(n_levels)]

    def config_key(self) -> tuple:
        """Extraction is pure configuration: two extractors with the same
        key compute the same function, so the tracking cores built for one
        (and their captured CUDA graphs) serve the other."""
        return (
            self.n_features, self.n_levels, self.scale_factor,
            self.fast_threshold, self.fast_min_threshold, self.cell,
        )

    def level_sigma2(self) -> np.ndarray:
        return np.array([s * s for s in self.scales], np.float32)

    def _extract(self, image: torch.Tensor) -> FrameFeatures:
        """Pyramid, FAST + per-cell maxima of all levels at once (one kernel
        launch on the card), per-level top-K, then ONE batched patch gather
        / orientation / descriptor pass for all levels' keypoints. The image
        may be uint8 (converted on its device) or f32."""
        image = image.to(torch.float32)
        dev = image.device
        pyramid = build_pyramid(image, self.n_levels, self.scale_factor)
        pad = PATCH_HALF
        h0, w0 = pyramid[0].shape
        atlas_w = w0 + 2 * pad
        # static row offsets of each padded level inside the atlas
        offs = []
        total = 0
        for img in pyramid:
            offs.append(total)
            total += img.shape[0] + 2 * pad
        atlas = torch.zeros((total, atlas_w), dtype=image.dtype, device=dev)
        for off, img in zip(offs, pyramid):
            padded = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
            atlas[off : off + padded.shape[0], : padded.shape[1]] = padded

        ys_all, xs_all, out_xy, resp_all, lvl_all, valid_all = (
            [], [], [], [], [], []
        )
        cell_best, cell_arg, cell_offs = fast_cells_pyramid(
            pyramid, cell=self.cell, border=EDGE_MARGIN
        )
        for l, img in enumerate(pyramid):
            quota = self.level_quota[l]
            if quota == 0:
                continue
            ys, xs, resp, valid = topk_from_cells(
                cell_best[cell_offs[l] : cell_offs[l + 1]],
                cell_arg[cell_offs[l] : cell_offs[l + 1]],
                img.shape[1] // self.cell,
                quota,
                cell=self.cell,
                min_score=self.fast_min_threshold,
            )
            s = self.scales[l]
            out_xy.append(
                torch.stack([xs.to(torch.float32) * s, ys.to(torch.float32) * s], -1)
            )
            ys_all.append(ys + offs[l])
            xs_all.append(xs)
            resp_all.append(resp)
            lvl_all.append(torch.full((quota,), l, dtype=torch.int64, device=dev))
            valid_all.append(valid)

        patches = gather_patches(atlas, torch.cat(ys_all), torch.cat(xs_all))
        ang = patch_moments(patches)
        desc = patch_descriptors(blur_patches(patches), ang)
        return FrameFeatures(
            xy=torch.cat(out_xy),
            response=torch.cat(resp_all),
            angle=ang,
            level=torch.cat(lvl_all),
            desc01=desc,
            valid=torch.cat(valid_all),
        )

    def extract(self, image, device=None) -> FrameFeatures:
        """image: (H,W) u8/f32 tensor or array (0..255). `device` says where
        to run. Left out, a tensor already on an accelerator stays there,
        and an array or a CPU tensor, which carries no request, goes to the
        card (`viorb_tpu_torch.default_device()`); `device="cpu"` runs on
        the CPU."""
        image = torch.as_tensor(image)
        if device is None:
            device = default_device() if image.device.type == "cpu" else image.device
        return self._extract(image.to(device))
