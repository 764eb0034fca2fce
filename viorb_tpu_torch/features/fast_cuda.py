"""FAST score map through the hand-written CUDA kernel K1
(`viorb_tpu_torch/csrc/fast_score.cu`).

Replaces the TPU kernel `viorb_tpu/features/fast_pallas.py::_fast_kernel`
(wrapper `fast_score_map_pallas`). On the H100 the kernel is bound by
memory, not arithmetic: 4 B read and 4 B written per pixel plus a 3 px
halo per 32x32 tile, against ~60 exact min/max/sub ops. Its design answers
that by staging each tile and halo in shared memory once and writing the
score map once, with the 3 px border zeroed in the kernel. The plain
version beside it is `features/fast.py::_fast_score_map_torch`; the two are
bit-equal.

The wrapper checks its input and raises on anything the kernel does not
take. It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from viorb_tpu_torch.cuda_build import load_library

LIB_NAME = "fast_score"

# Number of kernel launches made through fast_score_map_cuda. A run that
# resets it to 0 before driving the tracking step can read back how many
# levels went through the kernel.
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library(LIB_NAME).viorb_fast_score_map
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fast_score_map_cuda(image: torch.Tensor) -> torch.Tensor:
    """(H,W) f32 CUDA tensor -> (H,W) f32 FAST arc-strength map, 3 px
    border zeroed. Launches on PyTorch's current stream."""
    global LAUNCHES
    if not image.is_cuda:
        raise ValueError(f"fast_score_map_cuda needs a CUDA tensor, got {image.device}")
    if image.dtype != torch.float32:
        raise ValueError(f"fast_score_map_cuda needs float32, got {image.dtype}")
    if image.dim() != 2:
        raise ValueError(f"fast_score_map_cuda needs a 2-D image, got {tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError("fast_score_map_cuda needs a contiguous image")
    h, w = image.shape
    out = torch.empty_like(image)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    with torch.cuda.device(image.device):
        rc = _kernel()(image.data_ptr(), out.data_ptr(), h, w, stream)
    if rc != 0:
        raise RuntimeError(f"fast_score kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
