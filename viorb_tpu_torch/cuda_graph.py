"""A function of tensors as one CUDA graph: the port's counterpart of
`jax.jit` around a whole per-frame core.

Run eagerly, a tracking core is a few thousand small kernels whose launch
cost on the host is several times their time on the device. `GraphedFunction`
captures one call into a `torch.cuda.CUDAGraph` per set of input shapes and
from then on replays it: one launch on the host, no host sync.

Rules a wrapped function must keep, because a capture records device work
and nothing else:
  * no host sync and no host-to-device copy of pageable memory inside it.
    Constant tables are uploaded at first use; that first use is the
    warm-up, which runs the function eagerly on a side stream before the
    capture. So does the build and load of a kernel library.
  * every tensor it allocates comes from the graph's private pool, so
    device pointers a hand-written kernel receives by value stay valid for
    every replay.
  * its outputs are static tensors that the next replay overwrites. The
    wrapper hands out CLONES made on the same stream right after the
    replay, so a caller may keep many frames' outputs, and may pass an
    output (a carry) straight back in as the next call's input.

On CPU tensors the wrapper is the eager function. A capture that fails
raises; nothing falls back to eager on the card. `.eager` is the wrapped
function itself, for holding a replay to it: the same kernels in the same
order, so the same bits, provided the arguments are contiguous as the
graph's static inputs are (a transposed 3x3 sends cuBLAS down another
kernel, one ulp away).

Kernel launches: a replay does not pass through the Python wrappers that
count launches (`launch_counts`; `features/fast_cuda.py::LAUNCHES`,
`CELL_LAUNCHES`). The capture runs inside `launch_counts.recording()`, which
counts the launches the capturing thread records, per counter, without
adding them to the counters (a recorded launch did not run), and the wrapper
counts its replays, so launches = `launches()` of the graphs + the eager
counters. `captured()` gives the launches in each capture.

Threads: one call at a time per `GraphedFunction` (its static tensors are
shared state; a replay on one stream waits, on the device, for the last
replay's clones on another), one capture at a time in the process, and
every capture counted by the name of the thread that made it
(`CAPTURES_BY_THREAD`): the port captures on the thread that builds a
pipeline or starts its threads, never on a worker. A capture is made in
`capture_error_mode="thread_local"`, on a stream of its own: what other
threads do on the card meanwhile (allocations and eager kernel launches on
streams of their own: `chip_smoke.py` captures beside such a thread)
neither fails the capture nor is recorded into it, and their launches are
counted as ever. One thing they must not do while a capture runs: draw
from the card's DEFAULT random generator, which PyTorch hands to the
capture (the draw raises in their thread); a `torch.Generator` of their
own is fine.

What is NOT tried is a capture beside a thread that frees cached memory or
replays another graph, and a threaded `MonoSlam` has two such threads (the
mapping worker, the streaming collector). So the rule is: capture first,
then start the threads. A caller declares each thread that works on the
card with `register_thread()` before starting it and `unregister_thread()`
after joining it; while any is declared, a capture raises RuntimeError.
`MonoSlam` captures the cores its mode replays at the first frame's shapes
(`GraphedFunction.prepare`), then starts its threads; at a frame of another
shape or dtype it stops them (quiescent: nothing in flight, nothing queued),
captures at the new key and starts them again.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Tuple

import torch

from viorb_tpu_torch import launch_counts

WARMUP_CALLS = 2
_CAPTURE_LOCK = threading.Lock()  # one stream capture at a time in the process
_THREADS_LOCK = threading.Lock()
_card_threads = 0  # threads declared by register_thread() and not yet unregistered
CAPTURES_BY_THREAD: "collections.Counter[str]" = collections.Counter()  # thread name -> captures made


def register_thread() -> None:
    """Declare one more thread that works on the card beside the captures'
    (see the module docstring): until `unregister_thread`, a capture
    raises."""
    global _card_threads
    with _THREADS_LOCK:
        _card_threads += 1


def unregister_thread() -> None:
    global _card_threads
    with _THREADS_LOCK:
        if _card_threads <= 0:
            raise RuntimeError("cuda_graph.unregister_thread without register_thread")
        _card_threads -= 1


def card_threads() -> int:
    """Threads declared by `register_thread` and not yet unregistered."""
    return _card_threads


def _flatten(obj: Any, leaves: List[torch.Tensor]):
    """Tensors of a nest of tuples / NamedTuples, appended to `leaves`;
    returns the spec `_unflatten` rebuilds the nest from."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return None
    if isinstance(obj, tuple):
        return (type(obj), [_flatten(x, leaves) for x in obj])
    raise TypeError(f"GraphedFunction takes tensors and (named) tuples of them, got {type(obj)}")


def _unflatten(spec, leaves):
    """`leaves` is an iterator over the tensors in `_flatten`'s order."""
    if spec is None:
        return next(leaves)
    kind, children = spec
    items = [_unflatten(c, leaves) for c in children]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


class _Capture:
    """One captured graph: its static inputs and outputs."""

    def __init__(self, fn: Callable, in_spec, flat_args: List[torch.Tensor]):
        if card_threads():
            raise RuntimeError(
                f"a CUDA graph capture with {card_threads()} thread(s) working on the card beside it: "
                "capture before starting them (cuda_graph.py's docstring)"
            )
        dev = flat_args[0].device
        # contiguous whatever the first caller's strides were: a library
        # call (cuBLAS) picks its kernel by layout, and with it its rounding
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in flat_args]
        for s, a in zip(self.inputs, flat_args):
            s.copy_(a)
        static_args = _unflatten(in_spec, iter(self.inputs))
        # Warm up on a side stream: uploads constant tables, builds and
        # loads the kernel library, creates the cuBLAS / cuDNN / cuSOLVER
        # handles and workspaces. None of that may happen while capturing.
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*static_args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, launch_counts.recording() as self.captured:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                out = fn(*static_args)
            CAPTURES_BY_THREAD[threading.current_thread().name] += 1
        self.outputs: List[torch.Tensor] = []
        self.out_spec = _flatten(out, self.outputs)
        self.replays = 0
        self.done = torch.cuda.Event()  # behind the last replay's clones
        self.done.record()

    def replay(self, flat_args: List[torch.Tensor]):
        # a replay on another stream than the last must not overwrite the
        # static tensors before that one's graph and clones have run
        torch.cuda.current_stream().wait_event(self.done)
        for s, a in zip(self.inputs, flat_args):
            s.copy_(a, non_blocking=True)  # device to device, on the current stream
        self.graph.replay()
        self.replays += 1
        out = _unflatten(self.out_spec, iter([o.clone() for o in self.outputs]))
        self.done.record()
        return out


class GraphedFunction:
    """fn(*args) over tensors and (named) tuples of tensors, as a CUDA graph
    on the card and as `fn` itself on the CPU. See the module docstring."""

    def __init__(self, fn: Callable):
        self.eager = fn
        self._captures: Dict[Tuple, _Capture] = {}
        # static inputs and outputs are shared state: one call at a time
        self._lock = threading.Lock()

    def __call__(self, *args):
        flat: List[torch.Tensor] = []
        in_spec = _flatten(args, flat)
        dev = self._device(flat)
        if dev.type == "cpu":
            return self.eager(*args)
        with self._lock, torch.cuda.device(dev):
            return self._capture(dev, in_spec, flat).replay(flat)

    def prepare(self, *args) -> None:
        """Capture the graph for these arguments' shapes and dtypes now, if
        it is not captured yet, without replaying it (a no-op on the CPU)."""
        flat: List[torch.Tensor] = []
        in_spec = _flatten(args, flat)
        dev = self._device(flat)
        if dev.type == "cpu":
            return
        with self._lock, torch.cuda.device(dev):
            self._capture(dev, in_spec, flat)

    @staticmethod
    def _device(flat: List[torch.Tensor]) -> torch.device:
        devices = {t.device for t in flat}
        if len(devices) != 1:
            raise ValueError(f"GraphedFunction: arguments on several devices: {sorted(map(str, devices))}")
        dev = flat[0].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"GraphedFunction: unsupported device {dev}")
        return dev

    def _capture(self, dev, in_spec, flat) -> _Capture:
        """The capture for these arguments' shapes and dtypes, made now if
        there is none yet."""
        key = (dev, tuple((tuple(t.shape), t.dtype) for t in flat))
        cap = self._captures.get(key)
        if cap is None:
            cap = self._captures[key] = _Capture(self.eager, in_spec, flat)
        return cap

    @property
    def replays(self) -> int:
        return sum(c.replays for c in self._captures.values())

    def launches(self) -> Dict[str, int]:
        """Kernel launches made through replays so far, by counter name:
        launches in the capture x replays, summed over the captures."""
        total = {name: 0 for name in launch_counts.names()}
        for c in self._captures.values():
            for name, n in c.captured.items():
                total[name] += n * c.replays
        return total

    def captured(self) -> List[Dict[str, int]]:
        """Kernel launches recorded in each capture, by counter name."""
        return [dict(c.captured) for c in self._captures.values()]

    def reset_counts(self) -> None:
        for c in self._captures.values():
            c.replays = 0
