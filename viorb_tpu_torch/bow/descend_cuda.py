"""The BoW vocabulary-tree descent through the hand-written CUDA kernel K8
(`viorb_tpu_torch/csrc/bow_descend.cu`), the counterpart of the
reference's `viorb_tpu/bow/vocabulary.py::_descend_device`. The plain
version is `bow/vocabulary.py::_descend_torch`; the two agree word for
word, and the weights within float rounding (the kernel multiplies exact
integer counts by idf, the twin adds idf once a descriptor).

The wrapper checks its inputs and raises on anything the kernel does not
take. It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from viorb_tpu_torch import launch_counts
from viorb_tpu_torch.cuda_build import load_library

LIB_NAME = "bow_descend"
KERNEL_MAX_CHILDREN = 32  # one lane a child slot

# Launches made through bow_descend_cuda; a run sets it to 0 before driving
# a path and reads back how often K8 ran (`launch_counts`).
LAUNCHES_K8 = 0
launch_counts.register(__name__, "LAUNCHES_K8")

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load_library(LIB_NAME).viorb_bow_descend
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, p, i, i, p, i, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def bow_descend_cuda(dv, desc01: torch.Tensor, valid: torch.Tensor):
    """(N,256) uint8 {0,1} and (N,) bool CUDA tensors, and the tree on the
    same card (`vocabulary.DeviceVocabulary`) -> (words (N,) int32, weights
    (n_words,) f32), launched on PyTorch's current stream, no host sync."""
    if not desc01.is_cuda:
        raise ValueError(f"bow_descend_cuda needs CUDA tensors, got {desc01.device}")
    if desc01.dtype != torch.uint8 or desc01.dim() != 2 or desc01.shape[1] != 256:
        raise ValueError(f"bow_descend_cuda needs (N,256) uint8 descriptors, got {desc01.dtype} {tuple(desc01.shape)}")
    if valid.shape != desc01.shape[:1] or valid.device != desc01.device:
        raise ValueError("bow_descend_cuda: valid must be (N,) on the descriptors' device")
    for name, t in dv._asdict().items():
        if t is not None and t.device != desc01.device:
            raise ValueError(f"bow_descend_cuda: the vocabulary's {name} is on {t.device}, not {desc01.device}")
    n_nodes, k = dv.children.shape
    if not 1 <= k <= KERNEL_MAX_CHILDREN:
        raise ValueError(f"bow_descend_cuda takes 1..{KERNEL_MAX_CHILDREN} children a node, got {k}")
    desc01 = desc01.contiguous()  # rows of 256 bytes: 8-byte aligned on an aligned base
    if desc01.data_ptr() % 8:
        raise ValueError("bow_descend_cuda needs 8-byte aligned descriptor rows")
    valid_u8 = valid.to(torch.uint8).contiguous()
    n, n_words = desc01.shape[0], dv.idf.shape[0]
    words = torch.empty(n, dtype=torch.int32, device=desc01.device)
    counts = torch.zeros(n_words, dtype=torch.int32, device=desc01.device)
    weights = torch.empty(n_words, dtype=torch.float32, device=desc01.device)
    stream = torch.cuda.current_stream(desc01.device).cuda_stream
    with torch.cuda.device(desc01.device):
        rc = _kernel()(
            desc01.data_ptr(), valid_u8.data_ptr(), n, dv.centers_packed.data_ptr(), dv.children.data_ptr(),
            dv.is_leaf.data_ptr(), dv.word_id.data_ptr(), n_nodes, k, dv.idf.data_ptr(), n_words,
            words.data_ptr(), counts.data_ptr(), weights.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bow_descend kernel launch failed: cudaError {rc}")
    launch_counts.count("LAUNCHES_K8")
    return words, weights
