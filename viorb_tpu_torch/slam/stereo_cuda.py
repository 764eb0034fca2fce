"""Stereo sub-pixel refinement through the hand-written CUDA kernel K9
(`viorb_tpu_torch/csrc/stereo_sad.cu`), the counterpart of the reference's
`viorb_tpu/slam/kernels.py::refine_stereo_subpixel`. The plain version is
`slam/kernels.py::refine_stereo_subpixel`; the two agree bit for bit (the
source's header says why and what bounds the kernel on the H100).

`refine_stereo_subpixel_cuda` launches K9; `slam/stereo.py::
refine_subpixel` sends CUDA tensors here and CPU tensors to the plain
version (this module is imported only on the card, so the CPU path
registers no counter). The wrapper checks its inputs and raises on
anything the kernel does not take. It never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from viorb_tpu_torch import launch_counts
from viorb_tpu_torch.cuda_build import load_library

LIB_NAME = "stereo_sad"

# Launches made through refine_stereo_subpixel_cuda; a run sets it to 0 before
# driving a path and reads back how often K9 ran (`launch_counts`).
LAUNCHES_K9 = 0
launch_counts.register(__name__, "LAUNCHES_K9")

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library(LIB_NAME).viorb_stereo_sad
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p, p, i, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def refine_stereo_subpixel_cuda(img_l, img_r, xy_l, ur0, matched) -> torch.Tensor:
    """(H,W) f32 left and right images, (N,2) f32 left keypoints, (N,) f32
    right u of their descriptor matches and (N,) bool flags on one card ->
    (N,) f32 sub-pixel right u, -1 where unmatched: ONE launch of K9 on
    PyTorch's current stream (none for N = 0), no host sync."""
    if not img_l.is_cuda:
        raise ValueError(f"refine_stereo_subpixel_cuda needs CUDA tensors, got {img_l.device}")
    dev = img_l.device
    n = xy_l.shape[0]
    for name, t in (("img_r", img_r), ("xy_l", xy_l), ("ur0", ur0), ("matched", matched)):
        if t.device != dev:
            raise ValueError(f"refine_stereo_subpixel_cuda: {name} is on {t.device}, not {dev}")
    if img_l.dtype != torch.float32 or img_l.dim() != 2 or img_r.shape != img_l.shape or img_r.dtype != torch.float32:
        raise ValueError(f"refine_stereo_subpixel_cuda needs two (H,W) f32 images, got {img_l.dtype} "
                         f"{tuple(img_l.shape)} and {img_r.dtype} {tuple(img_r.shape)}")
    if xy_l.shape != (n, 2) or xy_l.dtype != torch.float32 or ur0.shape != (n,) or ur0.dtype != torch.float32:
        raise ValueError("refine_stereo_subpixel_cuda needs (N,2) f32 keypoints and (N,) f32 ur0")
    if matched.shape != (n,) or matched.dtype not in (torch.bool, torch.uint8):
        raise ValueError("refine_stereo_subpixel_cuda needs (N,) bool or uint8 flags")
    img_l, img_r, xy_l, ur0 = (t.contiguous() for t in (img_l, img_r, xy_l, ur0))
    flags = matched.contiguous().view(torch.uint8)  # bool and uint8 share their bytes
    ur = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return ur
    h, w = img_l.shape
    with torch.cuda.device(dev):
        rc = _kernel()(img_l.data_ptr(), img_r.data_ptr(), h, w, xy_l.data_ptr(), ur0.data_ptr(), flags.data_ptr(),
                       n, ur.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stereo_sad kernel launch failed: cudaError {rc}")
    launch_counts.count("LAUNCHES_K9")
    return ur
