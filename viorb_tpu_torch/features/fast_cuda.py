"""FAST through the hand-written CUDA kernel K1
(`viorb_tpu_torch/csrc/fast_score.cu`): two wrappers over one library.

`fast_score_map_cuda` is the counterpart of the TPU kernel
`viorb_tpu/features/fast_pallas.py::_fast_kernel` (wrapper
`fast_score_map_pallas`): one image to its score map. `fast_cells_cuda` is
what the extractor runs: every level of a pyramid in ONE launch, with the
border mask and the per-cell maximum / argmax of `grid_topk_keypoints`
fused in, so no score map is written to device memory and read back. The
source's header says what bounds the kernel on the H100 and what its
design does about it. The plain versions are
`features/fast.py::_fast_score_map_torch` and `_fast_cells_pyramid_torch`;
kernel and plain agree value for value.

The wrappers check their inputs and raise on anything the kernel does not
take. They never fall back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from viorb_tpu_torch import launch_counts
from viorb_tpu_torch.cuda_build import load_library
from viorb_tpu_torch.features.fast import cell_offsets

LIB_NAME = "fast_score"

# what the kernel is compiled for (csrc/fast_score.cu)
KERNEL_CELL = 16
KERNEL_MAX_LEVELS = 8
KERNEL_MIN_BORDER = 3

# Kernel launches made through fast_score_map_cuda (LAUNCHES) and through
# fast_cells_cuda (CELL_LAUNCHES). A run that sets them to 0 before driving
# the tracking step reads back how often each entry was launched. A launch
# recorded into a CUDA graph is counted by the graph, not here
# (`launch_counts`, `cuda_graph`).
LAUNCHES = 0
CELL_LAUNCHES = 0
launch_counts.register(__name__, "LAUNCHES", "CELL_LAUNCHES")

_fns: dict = {}


def _kernel(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library(LIB_NAME), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_image(image: torch.Tensor, who: str) -> None:
    if image.dtype != torch.float32:
        raise ValueError(f"{who} needs float32, got {image.dtype}")
    if image.dim() != 2:
        raise ValueError(f"{who} needs a 2-D image, got {tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError(f"{who} needs a contiguous image")
    if not image.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor, got {image.device}")


def fast_score_map_cuda(image: torch.Tensor) -> torch.Tensor:
    """(H,W) f32 CUDA tensor -> (H,W) f32 FAST arc-strength map, 3 px
    border zeroed. Launches on PyTorch's current stream."""
    _check_image(image, "fast_score_map_cuda")
    h, w = image.shape
    out = torch.empty_like(image)
    fn = _kernel(
        "viorb_fast_score_map",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(image.device).cuda_stream
    with torch.cuda.device(image.device):
        rc = fn(image.data_ptr(), out.data_ptr(), h, w, stream)
    if rc != 0:
        raise RuntimeError(f"fast_score kernel launch failed: cudaError {rc}")
    if h > 0 and w > 0:
        launch_counts.count("LAUNCHES")
    return out


def fast_cells_cuda(pyramid: Sequence[torch.Tensor], cell: int = 16, border: int = 19):
    """All levels of a pyramid of (H_l, W_l) f32 CUDA tensors, in one
    launch on PyTorch's current stream -> (cell_best f32, cell_arg int64,
    offsets) as `features/fast.py::fast_cells_pyramid` describes them."""
    n = len(pyramid)
    if not 1 <= n <= KERNEL_MAX_LEVELS:
        raise ValueError(f"fast_cells_cuda takes 1..{KERNEL_MAX_LEVELS} levels, got {n}")
    if cell != KERNEL_CELL:
        raise ValueError(f"fast_cells_cuda is built for {KERNEL_CELL} px cells, got {cell}")
    if border < KERNEL_MIN_BORDER:
        raise ValueError(f"fast_cells_cuda needs border >= {KERNEL_MIN_BORDER}, got {border}")
    dev = pyramid[0].device
    for lvl, img in enumerate(pyramid):
        _check_image(img, f"fast_cells_cuda (level {lvl})")
        if img.device != dev:
            raise ValueError(f"fast_cells_cuda: level {lvl} is on {img.device}, level 0 on {dev}")
    offsets = cell_offsets([img.shape for img in pyramid], cell)
    cell_best = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    cell_arg = torch.empty(offsets[-1], dtype=torch.int64, device=dev)
    if offsets[-1] == 0:  # every level smaller than a cell: nothing to launch
        return cell_best, cell_arg, offsets
    # host arrays the C entry copies into the kernel's parameter struct
    ints = ctypes.c_int * n
    ptrs = (ctypes.c_void_p * n)(*[img.data_ptr() for img in pyramid])
    hs = ints(*[img.shape[0] for img in pyramid])
    ws = ints(*[img.shape[1] for img in pyramid])
    offs = ints(*offsets[:-1])
    int_p = ctypes.POINTER(ctypes.c_int)
    fn = _kernel(
        "viorb_fast_cells",
        [ctypes.POINTER(ctypes.c_void_p), int_p, int_p, int_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(ptrs, hs, ws, offs, n, border, cell_best.data_ptr(), cell_arg.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fast_cells kernel launch failed: cudaError {rc}")
    launch_counts.count("CELL_LAUNCHES")
    return cell_best, cell_arg, offsets
