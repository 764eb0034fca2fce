"""The BoW vocabulary-tree descent through the hand-written CUDA kernel K8
(`viorb_tpu_torch/csrc/bow_descend.cu`), the counterpart of the
reference's `viorb_tpu/bow/vocabulary.py::_descend_device`. The plain
version is `bow/vocabulary.py::_descend_torch`; the two agree word for
word, and the weights within float rounding (the kernel multiplies exact
integer counts by idf, the twin adds idf once a descriptor).

One call is ONE kernel launch of one thread-block cluster, by one of two
paths that compute the same function:
  * "shared": the word histogram in the cluster leader's shared memory
    (a tree whose words fit: the stock tree's 1000 do), counter
    `LAUNCHES_K8`;
  * "global": the histogram in a scratch tensor of the call's own, for a
    tree whose words do not fit, counter `LAUNCHES_K8_GLOBAL`.
`path=None` picks by the tree's size; a caller may name a path to hold the
two to each other.

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
# CTAs of the one cluster a call launches: 16, Hopper's largest (a
# non-portable size; 8 is the portable one); 1024 threads each
CLUSTER_CTAS = 16

# Launches made through bow_descend_cuda, by path; a run sets them to 0
# before driving a path and reads back how often K8 ran (`launch_counts`).
LAUNCHES_K8 = 0
LAUNCHES_K8_GLOBAL = 0
launch_counts.register(__name__, "LAUNCHES_K8", "LAUNCHES_K8_GLOBAL")

_fn = None
_shared_max_words: dict = {}  # device index -> the shared path's largest histogram


def _lib():
    global _fn
    if _fn is None:
        lib = load_library(LIB_NAME)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.viorb_bow_descend.argtypes = [p, p, i, p, p, p, p, i, i, p, i, p, p, p, i, p]
        lib.viorb_bow_descend.restype = ctypes.c_int
        lib.viorb_bow_shared_hist_max_words.argtypes = []
        lib.viorb_bow_shared_hist_max_words.restype = ctypes.c_int
        _fn = lib
    return _fn


def shared_hist_max_words(device: torch.device) -> int:
    """The most words the shared path's histogram holds on this card."""
    idx = torch.device(device).index or 0
    if idx not in _shared_max_words:
        with torch.cuda.device(idx):
            n = _lib().viorb_bow_shared_hist_max_words()
        if n < 0:
            raise RuntimeError("bow_descend: querying the card's shared memory failed")
        _shared_max_words[idx] = n
    return _shared_max_words[idx]


def bow_descend_cuda(dv, desc01: torch.Tensor, valid: torch.Tensor, path: str | None = None):
    """(N,256) uint8 {0,1} and (N,) bool CUDA tensors, and the tree on the
    same card (`vocabulary.DeviceVocabulary`) -> (words (N,) int32, weights
    (n_words,) f32), ONE kernel launched on PyTorch's current stream, no
    host sync. `path`: "shared", "global" or None (the shared path when the
    histogram fits)."""
    if not desc01.is_cuda:
        raise ValueError(f"bow_descend_cuda needs CUDA tensors, got {desc01.device}")
    if desc01.dtype != torch.uint8 or desc01.dim() != 2 or desc01.shape[1] != 256:
        raise ValueError(f"bow_descend_cuda needs (N,256) uint8 descriptors, got {desc01.dtype} {tuple(desc01.shape)}")
    if valid.shape != desc01.shape[:1] or valid.device != desc01.device or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError("bow_descend_cuda: valid must be (N,) bool or uint8 on the descriptors' device")
    for name, t in dv._asdict().items():
        if t is not None and t.device != desc01.device:
            raise ValueError(f"bow_descend_cuda: the vocabulary's {name} is on {t.device}, not {desc01.device}")
    n_nodes, k = dv.children.shape
    if not 1 <= k <= KERNEL_MAX_CHILDREN:
        raise ValueError(f"bow_descend_cuda takes 1..{KERNEL_MAX_CHILDREN} children a node, got {k}")
    if dv.centers_packed.data_ptr() % 16:
        raise ValueError("bow_descend_cuda needs 16-byte aligned packed centers")
    n, n_words = desc01.shape[0], dv.idf.shape[0]
    if n_words < 1:
        raise ValueError("bow_descend_cuda needs a vocabulary with words")
    fits = n_words <= shared_hist_max_words(desc01.device)
    if path is None:
        path = "shared" if fits else "global"
    if path not in ("shared", "global") or (path == "shared" and not fits):
        raise ValueError(f"bow_descend_cuda: path {path!r} for {n_words} words "
                         f"(the shared path holds {shared_hist_max_words(desc01.device)})")
    # contiguous rows (a keyframe's payload already is: no copy) of 256
    # bytes are 16-byte aligned on an aligned base; bool and uint8 share
    # their bytes, so the flags need no cast kernel either
    desc01 = desc01.contiguous()
    if desc01.data_ptr() % 16:
        raise ValueError("bow_descend_cuda needs 16-byte aligned descriptor rows")
    valid_u8 = valid.contiguous().view(torch.uint8)
    words = torch.empty(n, dtype=torch.int32, device=desc01.device)
    weights = torch.empty(n_words, dtype=torch.float32, device=desc01.device)
    scratch = torch.empty(n_words, dtype=torch.int32, device=desc01.device) if path == "global" else None
    stream = torch.cuda.current_stream(desc01.device).cuda_stream
    with torch.cuda.device(desc01.device):
        rc = _lib().viorb_bow_descend(
            desc01.data_ptr(), valid_u8.data_ptr(), n, dv.centers_packed.data_ptr(), dv.children.data_ptr(),
            dv.is_leaf.data_ptr(), dv.word_id.data_ptr(), n_nodes, k, dv.idf.data_ptr(), n_words,
            words.data_ptr(), weights.data_ptr(), None if scratch is None else scratch.data_ptr(),
            CLUSTER_CTAS, stream,
        )
    if rc != 0:
        raise RuntimeError(f"bow_descend kernel launch failed: cudaError {rc}")
    launch_counts.count("LAUNCHES_K8" if path == "shared" else "LAUNCHES_K8_GLOBAL")
    return words, weights
