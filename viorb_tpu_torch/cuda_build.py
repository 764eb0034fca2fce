"""Build a CUDA C++ source of `viorb_tpu_torch/csrc/` into a shared library
with a plain C interface, and load it with ctypes.

nvcc compiles for `sm_90a` (Hopper) at first use, into
`<repo>/build/viorb_tpu_torch/` (git-ignored), and again whenever the
source is newer than the library. A plain C interface keeps the build to
seconds: nothing includes PyTorch's headers. Wrappers pass tensor pointers
and PyTorch's current stream as `ctypes.c_void_p`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build",
    "viorb_tpu_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# name -> (ctypes.CDLL, seconds spent building in this process, nvcc output)
_LOADED: dict = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual place."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if stale) and load `csrc/<name>.cu` as `lib<name>.so`."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = os.path.join(CSRC_DIR, name + ".cu")
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(lib_path)
    _LOADED[name] = (lib, seconds, log)
    return lib


def build_info(name: str) -> tuple[float, str]:
    """(build seconds in this process, nvcc's -Xptxas -v output) of a
    loaded library; (0.0, "") when it was already built."""
    _, seconds, log = _LOADED[name]
    return seconds, log
