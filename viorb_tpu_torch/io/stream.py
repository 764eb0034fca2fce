"""Live-stream ingestion: image/IMU synchronization + realtime runner (port
of viorb_tpu/io/stream.py).

Counterpart of the reference's ROS front end (MsgSynchronizer
Examples/ROS/ORB_VIO/src/MsgSync/MsgSynchronizer.{h,cpp} — discontinuity
check, wait-for-IMU-to-catch-up, emit one image + all IMU msgs <= stamp
with a configured image-to-IMU delay; ros_vio.cc:125-320 lock-step replay;
ros_vio_realtime.cc drop-when-behind live mode). There is no ROS here:
producers push into thread-safe queues from any source (dataset replay,
sockets, capture hardware) and the runner drives the SLAM pipeline.

One difference from the JAX package: `RealtimeRunner.run()` loops on the
CALLING thread. The port captures its CUDA graphs and builds and loads its
kernels only on the thread that builds a pipeline (`cuda_graph.py`), and a
SLAM object's first frame does both, so the runner that calls
`process_frame` runs on that thread and the producer on another.
`start()` / `join()` keep the JAX package's runner thread for a pipeline
that needs neither (a CPU one, a callback that does not touch the card);
they must not drive a pipeline on the card.

A second difference: `wait_for_room()`, the back-pressure a lock-step
producer applies so that the queue's `max_images` bound never drops a
frame. The JAX package's replay pushes every frame at once, and so loses
all but the last `max_images` of a long sequence whenever the pipeline is
slower than the reader (ROADMAP, "Known faults in the reference").
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np


class MsgSynchronizer:
    """Aligns an image stream with a higher-rate IMU stream.

    An image is released only once IMU data has caught up past
    ``img_ts + image_delay`` (the reference waits in getRecentMsgs);
    released bundles carry every IMU sample in ``(prev_img_ts, img_ts] +
    image_delay``. A timestamp jump larger than ``discontinuity_s`` in
    either stream clears both queues (reference's 3 s discontinuity
    check)."""

    def __init__(self, image_delay: float = 0.0, discontinuity_s: float = 3.0,
                 max_images: int = 64, with_imu: bool = True):
        # with_imu=False: images-only stream (the reference's vision-only
        # ROS nodes) — frames release immediately, no IMU catch-up wait
        self.with_imu = with_imu
        self.image_delay = image_delay
        self.discontinuity_s = discontinuity_s
        self.max_images = max_images
        self._images: deque = deque()
        self._imu: deque = deque()
        self._lock = threading.Condition()
        self._last_img_ts: Optional[float] = None
        self._last_imu_ts: Optional[float] = None
        self.n_discontinuities = 0
        self.n_dropped_images = 0
        self._closed = False

    def _reset_locked(self):
        """Drop queued data and forget stream positions: the triggering
        message begins a new epoch, and the OTHER stream's next message
        must not re-trigger on the same jump."""
        self._images.clear()
        self._imu.clear()
        self._last_img_ts = None
        self._last_imu_ts = None
        self.n_discontinuities += 1

    def add_image(self, ts: float, image):
        with self._lock:
            if self._last_img_ts is not None and abs(ts - self._last_img_ts) > self.discontinuity_s:
                self._reset_locked()
            self._last_img_ts = ts
            self._images.append((ts, image))
            while len(self._images) > self.max_images:
                self._images.popleft()
                self.n_dropped_images += 1
            self._lock.notify_all()

    def wait_for_room(self, stop: Optional[threading.Event] = None, poll_s: float = 0.05) -> None:
        """Block while `max_images` images are queued: a lock-step
        producer calls this before `add_image`, so the bound drops no
        frame. Returns once there is room, the stream is closed, or `stop`
        is set (checked every `poll_s`)."""
        with self._lock:
            while len(self._images) >= self.max_images and not self._closed:
                if stop is not None and stop.is_set():
                    return
                self._lock.wait(timeout=poll_s)

    def add_imu(self, ts: float, gyro: np.ndarray, acc: np.ndarray):
        with self._lock:
            if self._last_imu_ts is not None and abs(ts - self._last_imu_ts) > self.discontinuity_s:
                self._reset_locked()
            self._last_imu_ts = ts
            self._imu.append((ts, np.asarray(gyro), np.asarray(acc)))
            self._lock.notify_all()

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def _ready_locked(self) -> bool:
        return bool(self._images) and self._ready_for(self._images[0][0])

    def _ready_for(self, img_ts: float) -> bool:
        if not self.with_imu:
            return True
        return self._last_imu_ts is not None and self._last_imu_ts >= img_ts + self.image_delay

    def get_synced(
        self, timeout: Optional[float] = None, latest_only: bool = False
    ) -> Optional[Tuple[float, np.ndarray, List[tuple]]]:
        """Blocks until an image with complete IMU coverage is available
        (or the stream closes). latest_only drops all but the newest ready
        image first (realtime mode: process the freshest frame when
        behind; the skipped frames' IMU samples stay queued so
        preintegration still covers the gap)."""
        with self._lock:
            while not self._ready_locked():
                if self._closed:
                    return None
                if not self._lock.wait(timeout=timeout):
                    return None
            if latest_only:
                while len(self._images) > 1 and self._ready_for(self._images[1][0]):
                    self._images.popleft()
                    self.n_dropped_images += 1
            img_ts, image = self._images.popleft()
            self._lock.notify_all()  # room for a producer in wait_for_room
            cutoff = img_ts + self.image_delay
            samples = []
            while self._imu and self._imu[0][0] <= cutoff:
                samples.append(self._imu.popleft())
            return img_ts, image, samples


class RealtimeRunner:
    """Drives a SLAM pipeline from a MsgSynchronizer.

    mode="lockstep": process every frame in order (the reference's
    bLocalMapAcceptKF wait loop, ros_vio.cc:263-276).
    mode="realtime": always process the freshest frame, dropping stale
    ones when the pipeline falls behind (ros_vio_realtime.cc /
    RUN_REALTIME).

    process_fn(ts, image, imu_samples) -> info dict; for vision-only
    pipelines pass a wrapper ignoring the samples. `run()` loops on the
    calling thread until the stream closes (module docstring); `start()`
    runs the same loop on a thread of its own, `join()` waits for it:
    never for a pipeline on the card, whose first frames build, load and
    capture on the thread that calls `process_fn`."""

    def __init__(
        self,
        sync: MsgSynchronizer,
        process_fn: Callable[[float, np.ndarray, List[tuple]], dict],
        mode: str = "lockstep",
        on_result: Optional[Callable[[float, dict], None]] = None,
    ):
        if mode not in ("lockstep", "realtime"):
            raise ValueError(f"RealtimeRunner mode {mode!r}: 'lockstep' or 'realtime'")
        self.sync = sync
        self.process_fn = process_fn
        self.mode = mode
        self.on_result = on_result
        self.n_processed = 0
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run_caught, daemon=True)

    def run(self) -> int:
        """Process frames on this thread until the stream closes (or no
        frame comes for 5 s); returns the frames processed."""
        while True:
            out = self.sync.get_synced(timeout=5.0, latest_only=(self.mode == "realtime"))
            if out is None:
                return self.n_processed
            ts, image, samples = out
            info = self.process_fn(ts, image, samples)
            self.n_processed += 1
            if self.on_result is not None:
                self.on_result(ts, info)

    def start(self):
        self._thread.start()
        return self

    def _run_caught(self):
        try:
            self.run()
        except Exception as e:  # surfaced via join()
            self.error = e

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout=timeout)
        if self.error is not None:
            raise RuntimeError("realtime runner died") from self.error
        return self.n_processed
