"""Build a CUDA C++ source of `viorb_tpu_torch/csrc/` into a shared library
with a plain C interface, and load it with ctypes.

nvcc compiles for `sm_90a` (Hopper) at first use, into
`<repo>/build/viorb_tpu_torch/` (git-ignored), and again whenever the
source is newer than the library. A plain C interface keeps the build to
seconds: nothing includes PyTorch's headers. Wrappers pass tensor pointers
and PyTorch's current stream as `ctypes.c_void_p`.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
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
_LOCK = threading.Lock()  # a worker thread may reach its first kernel beside the caller's
# nvcc builds and library loads, by the name of the thread that made them:
# a pipeline builds and loads on the thread that constructs it, never on a
# worker (a build inside a mapping job stalls the job by seconds)
BUILDS_BY_THREAD: "collections.Counter[str]" = collections.Counter()
LOADS_BY_THREAD: "collections.Counter[str]" = collections.Counter()


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


def _paths(name: str):
    return os.path.join(CSRC_DIR, name + ".cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib_path = _paths(name)
    return not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src)


def _start_build(name: str):
    """(nvcc process writing a temporary library, its path, start time)."""
    src, lib_path = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish_build(name: str, build) -> tuple[float, str]:
    proc, tmp, t0 = build
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_paths(name)[0]}:\n{log}")
    os.replace(tmp, _paths(name)[1])  # atomic: concurrent builders never see half a file
    return seconds, log


def load_libraries(names) -> None:
    """Build every stale library of `names` at once (one nvcc each, all
    started together), then load them all."""
    thread = threading.current_thread().name
    with _LOCK:
        builds = {n: _start_build(n) for n in names if n not in _LOADED and _stale(n)}
        done = {n: _finish_build(n, b) for n, b in builds.items()}
        BUILDS_BY_THREAD[thread] += len(done)
        for n in names:
            if n not in _LOADED:
                _LOADED[n] = (ctypes.CDLL(_paths(n)[1]), *done.get(n, (0.0, "")))
                LOADS_BY_THREAD[thread] += 1


def load_library(name: str) -> ctypes.CDLL:
    """Build (if stale) and load `csrc/<name>.cu` as `lib<name>.so`."""
    load_libraries([name])
    return _LOADED[name][0]


def build_info(name: str) -> tuple[float, str]:
    """(build seconds in this process, nvcc's -Xptxas -v output) of a
    loaded library; (0.0, "") when it was already built."""
    _, seconds, log = _LOADED[name]
    return seconds, log
