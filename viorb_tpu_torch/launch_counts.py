"""The launch counters of the hand-written kernels' wrappers, in one place.

A wrapper module keeps its counters as plain integer attributes
(`features/fast_cuda.py::LAUNCHES`, `CELL_LAUNCHES`), names them here once
with `register`, and calls `count(name)` where it launches its kernel, and
nowhere else. A caller sets an attribute to 0, drives a path, and reads back
how often that kernel was launched.

`cuda_graph` knows this registry and no kernel module. While it captures, a
launch is recorded into the graph and does not run: inside `recording()` the
launches THIS thread makes are counted into the yielded dict and the
counters stay as they are, so launches another thread makes meanwhile are
counted as ever. Counting takes a lock: two threads may launch at once.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

_LOCK = threading.Lock()
_MODULE_OF: Dict[str, str] = {}  # counter name -> name of the module that holds it
_THREAD = threading.local()  # .recording: the dict of a capture in progress on this thread


def register(module_name: str, *names: str) -> None:
    """Name the counters `names`, integer attributes of module `module_name`."""
    for name in names:
        if _MODULE_OF.setdefault(name, module_name) != module_name:
            raise ValueError(f"launch counter {name} is already registered by {_MODULE_OF[name]}")


def names() -> Tuple[str, ...]:
    return tuple(_MODULE_OF)


def count(name: str) -> None:
    """One launch of the kernel behind counter `name`."""
    recording = getattr(_THREAD, "recording", None)
    if recording is not None:
        recording[name] = recording.get(name, 0) + 1
        return
    module = sys.modules[_MODULE_OF[name]]
    with _LOCK:
        setattr(module, name, getattr(module, name) + 1)


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Yields {counter name: launches this thread made inside the block},
    every registered name present; those launches are not added to the
    counters."""
    if getattr(_THREAD, "recording", None) is not None:
        raise RuntimeError("launch_counts.recording() does not nest")
    held: Dict[str, int] = {}
    _THREAD.recording = held
    try:
        yield held
    finally:
        _THREAD.recording = None
        for name in _MODULE_OF:
            held.setdefault(name, 0)
