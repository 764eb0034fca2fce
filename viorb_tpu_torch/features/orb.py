"""Oriented BRIEF descriptors: IC-angle orientation + rotated binary tests
(port of viorb_tpu/features/orb.py: the per-keypoint patch path).

The test pattern, the 35x35 patch geometry, the 7x7 blur and the 32
orientation banks are the reference's. What changes is how a bank's 512
test endpoints are sampled: the TPU runs one (K, 841) x (841, 32*512)
bf16 one-hot selector matmul against a 48 MB matrix; here a (32, 512)
table of flat window offsets, built by the same arithmetic, drives one
index gather. A one-hot product selects exactly one pixel, so the gather
is exact; the sampled values are still rounded to bf16 before the a < b
tests, as the selector matmul rounds them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15
EDGE_MARGIN = 19
N_TESTS = 256
_PATTERN_SEED = 20260816
_PATTERN_RADIUS = 13.0  # keep rotated samples inside the 31x31 patch


def make_test_pattern() -> np.ndarray:
    """(256, 2, 2) int: test i compares points pattern[i,0] vs pattern[i,1],
    each (dx, dy), Gaussian-distributed (BRIEF) and radius-clamped."""
    rng = np.random.default_rng(_PATTERN_SEED)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(N_TESTS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, _PATTERN_RADIUS / np.maximum(norm, 1e-9))
    pts = np.round(pts * scale).astype(np.int32)
    return pts


TEST_PATTERN = make_test_pattern()  # (256,2,2) (dx,dy)


def _circular_moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    r = HALF_PATCH
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (xs**2 + ys**2) <= r**2
    kx = (xs * mask).astype(np.float32)
    ky = (ys * mask).astype(np.float32)
    return kx, ky


_KX, _KY = _circular_moment_kernels()

# Patch geometry: HALF_PATCH=15 for moments; rotated radius-13 samples stay
# within +-14 after rounding (SAMPLE_HALF), and the 7x7 blur needs 3 px of
# context: 17 = max(15, 14 + 3) covers everything in a 35x35 patch.
PATCH_HALF = 17
PATCH_SIZE = 2 * PATCH_HALF + 1  # 35
SAMPLE_HALF = 14
SAMPLE_SIZE = 2 * SAMPLE_HALF + 1  # 29

# Rotation is quantized to N_BANKS discrete angles (step 11.25 deg).
N_BANKS = 32


def build_bank_offsets() -> np.ndarray:
    """(N_BANKS, 512) int64: entry [b, i] is the flat offset, in the
    SAMPLE_SIZE x SAMPLE_SIZE window, of the pixel that test endpoint i
    samples when the orientation falls in bank b. Same arithmetic as the
    reference's _build_bank_selector, whose column b*512+i is one-hot at
    exactly this offset."""
    n_pts = 2 * N_TESTS  # 512 endpoints
    pts = TEST_PATTERN.reshape(n_pts, 2).astype(np.float64)  # (512,2) (dx,dy)
    table = np.zeros((N_BANKS, n_pts), np.int64)
    for b in range(N_BANKS):
        ang = 2.0 * np.pi * b / N_BANKS
        ca, sa = np.cos(ang), np.sin(ang)
        rx = np.round(ca * pts[:, 0] - sa * pts[:, 1]).astype(np.int64)
        ry = np.round(sa * pts[:, 0] + ca * pts[:, 1]).astype(np.int64)
        px = np.clip(SAMPLE_HALF + rx, 0, SAMPLE_SIZE - 1)
        py = np.clip(SAMPLE_HALF + ry, 0, SAMPLE_SIZE - 1)
        table[b] = py * SAMPLE_SIZE + px
    return table


BANK_OFFSETS = build_bank_offsets()

_CONSTS = {
    "kx": _KX.reshape(-1),
    "ky": _KY.reshape(-1),
    "bank_offsets": BANK_OFFSETS,
    # the reference divides by the weak-typed f32 of 2*pi/N_BANKS
    "bank_step": np.array(2.0 * np.pi / N_BANKS, np.float32),
}
# per-device copies of the constant tables: uploaded once, not per frame
_DEVICE_CONSTS: dict = {}


def _const(name: str, device: torch.device) -> torch.Tensor:
    key = (name, str(device))
    t = _DEVICE_CONSTS.get(key)
    if t is None:
        if name not in _CONSTS:  # "blur<size>_<sigma>"
            from viorb_tpu_torch.features.pyramid import _gaussian_kernel1d

            size, sigma = name[4:].split("_")
            _CONSTS[name] = _gaussian_kernel1d(int(size), float(sigma))
        t = _DEVICE_CONSTS[key] = torch.from_numpy(_CONSTS[name]).to(device)
    return t


def gather_patches(padded: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(K,35,35) patches from an ALREADY-PADDED image: the patch for
    keypoint (y, x) in original coords starts at (y, x) in padded coords
    (the PATCH_HALF border shift cancels the centering). Start indices are
    clamped so the patch fits, as jax.lax.dynamic_slice clamps them."""
    hp, wp = padded.shape
    y0 = ys.clamp(0, hp - PATCH_SIZE)
    x0 = xs.clamp(0, wp - PATCH_SIZE)
    r = torch.arange(PATCH_SIZE, device=padded.device)
    rows = (y0[:, None] + r[None, :])[:, :, None]  # (K,35,1)
    cols = (x0[:, None] + r[None, :])[:, None, :]  # (K,1,35)
    return padded.reshape(-1)[rows * wp + cols]


def patch_moments(patches: torch.Tensor) -> torch.Tensor:
    """IC angle from the 31x31 circular moments at the patch center.
    patches: (K,35,35) -> (K,) radians."""
    r = HALF_PATCH
    c = PATCH_HALF
    k = patches.shape[0]
    center = patches[:, c - r : c + r + 1, c - r : c + r + 1].reshape(k, -1)
    m10 = center @ _const("kx", patches.device)
    m01 = center @ _const("ky", patches.device)
    return torch.atan2(m01, m10)


def blur_patches(patches: torch.Tensor, size: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur over the patch batch, with edge padding,
    rows then columns: (K,35,35) -> (K,35,35)."""
    kern = _const(f"blur{size}_{sigma}", patches.device)
    pad = size // 2
    p = F.pad(patches[:, None], (0, 0, pad, pad), mode="replicate")
    p = F.conv2d(p, kern.view(1, 1, -1, 1))
    p = F.pad(p, (pad, pad, 0, 0), mode="replicate")
    p = F.conv2d(p, kern.view(1, 1, 1, -1))
    return p[:, 0]


def patch_descriptors(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated 256-pair tests: quantize each orientation to its bank, gather
    that bank's 512 endpoints from the keypoint's 29x29 sample window, round
    to bf16, compare pairs. Returns (K,256) uint8 {0,1}."""
    k = patches.shape[0]
    c = PATCH_HALF
    win = patches[
        :, c - SAMPLE_HALF : c + SAMPLE_HALF + 1, c - SAMPLE_HALF : c + SAMPLE_HALF + 1
    ].reshape(k, SAMPLE_SIZE * SAMPLE_SIZE)
    # divide by a tensor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which can move a bank boundary
    step = _const("bank_step", angles.device)
    # jnp.mod is floored, as torch.remainder is (torch.fmod is truncated)
    bank = torch.remainder(torch.round(angles / step).to(torch.int64), N_BANKS)
    offs = _const("bank_offsets", patches.device)[bank]  # (K,512)
    vals = torch.gather(win, 1, offs).to(torch.bfloat16).to(torch.float32)
    a = vals[:, 0::2]
    b = vals[:, 1::2]
    return (a < b).to(torch.uint8)
