"""Monocular vision-only SLAM (port of viorb_tpu/slam/mono.py: `MonoSlam`
in its three modes).

Host orchestration of the port's device functions, playing the reference
ORB-SLAM's Tracking and LocalMapping threads:

  * lock-step (default): each frame is tracked, and a keyframe insertion
    runs the mapping job (the reference's LocalMapping step) before the
    next frame;
  * async (`async_mapping=True`): the mapping job runs on a worker thread,
    so tracking never blocks on keyframe insertion. The worker takes jobs
    from a queue, runs every device function of a job on a CUDA stream of
    its own, and defers each local BA's write-back to the next job (or to
    `wait_mapping_idle`): keyframes made after the solve's snapshot ride
    the correction through the newest solved keyframe (the spanning-tree
    pass). While two jobs are unfinished, only a twice-blown interval cap
    may insert a keyframe. Every job runs its local BA (the reference skips
    it while a newer keyframe waits; below);
  * streaming (`streaming=True`, implies async): the caller's thread only
    DISPATCHES the graphed streaming core with a pose carry on the card and
    starts non-blocking copies of the frame's bookkeeping fields into
    pinned memory behind one event; a collector thread waits once per batch
    of in-flight frames, on the last frame's event, and runs the host
    bookkeeping (map counters, keyframe decision, trajectory) with a lag
    bounded by `streaming_depth`. When mapping publishes an update the
    carry is re-anchored to its keyframe's new pose on the card.

The map lives in MapStore on the host (numpy) under `map_lock` (an RLock):
the threads take it for snapshots and write-backs, never across an upload,
a dispatch or a pull, except loop closing (below). Per-frame compute runs on the device: a steady frame
is ONE replay of a graphed core (`tracking_loop.make_pipeline_track_core`,
or `make_streaming_track_core` when streaming: extraction, projection
matching with the wide-radius retry, pose LM) and ONE pull of its
bookkeeping fields (none on the caller's thread when streaming); the
frame's descriptor bits stay on the device unless it becomes a keyframe.
The padded local map is uploaded once per map epoch (`map.version`, the
reference keyframe) and cached. Frames before initialization and the
fallback chain (reference-keyframe matching, then relocalization without a
vocabulary, then LOST) run eagerly; so does the mapping job
(triangulation, fusion, point statistics, culling), but for its local BA.

Uploads go through pinned host memory and never wait for the device; each
pull copies into pinned memory and waits once, on the calling thread's
stream. Tensors a tracked frame made and the worker reads (a keyframe's
feature payload) carry the event recorded after them: the worker's stream
waits on it and records its use, so the caching allocator cannot hand the
memory out again before the worker is done. On the card the cores a mode
replays are captured at the first frame's shapes BEFORE the threads start
(`cuda_graph.py`: no capture beside them). The two RANSAC solvers draw from
one `torch.Generator` seeded with `seed`, where the reference splits
`jax.random` keys: the port picks other hypotheses than the reference, so
the two are held to each other by outcome, not bit for bit.

With a vocabulary, place recognition runs at the end of every mapping job
(`slam/loop_closing.py::LoopCloser`: the keyframe's BoW through K8 into the
database, then, with `enable_loop_closing`, detection, Sim3 verification,
the essential-graph correction, seam fusion and the post-loop global BA),
and relocalization takes its candidates from the database.

Loop closing holds the map lock from the keyframe's BoW to the end of the
closure (detection, Sim3 verification, the essential graph, seam fusion,
the post-loop global BA), as the reference's mapping job holds it across
the correction: a tracker thread waits for the closure. The post-loop
global BA runs in the loop job in every mode; the reference runs it on a
thread of its own in its threaded modes, which left frames tracked against
the corrected map before its write-back 0.4-1.5 m off on the card, and let
a local BA solved on that map undo part of it when written back after it.
Not copied from the reference (its faults): the unlocked swap
of the pending BA (`_ba_lock`: a solve is applied exactly once), the
deferred-descriptor race (the handle is read once, the write-back only
fills a missing block, both under `map_lock`), a deferred write-back onto
a point slot culled and reused meanwhile (`MapStore.pt_gen`, compared with
the solve's snapshot), `map_lock` held across fusion's uploads and
dispatch, the async BA skip (below), and the post-loop global BA on a
thread beside the tracker (above).

The reference's async mapping skips a job's local BA while a newer
keyframe waits (its stand-in for ORB-SLAM's BA abort, at most twice in a
row). The port never skips it: with loop closing, the rejected Sim3
verifications of the circuit's revisit hold the worker for 0.2-0.4 s a
job, the keyframes of the turn queue up behind them, and their skipped BAs
left the turn unrefined until tracking drifted 0.4-0.9 m and no
verification passed (up to a third of the paced async loop runs on an
H100; none of 12 without the skip); on a young map it starved the two-view
map the same way. The local BA is one graph replay (13.5-15 ms on an
H100), so the skip saved little.

The local BAs pad their pose block to the reference's buckets
(`optim/ba.py::pose_bucket`) and replay one CUDA graph a bucket on the
card, captured with the cores before the threads start (lock-step: at
first use); the post-loop global BA runs eagerly. Every kernel library the
configuration launches is built and loaded by the constructor.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from viorb_tpu_torch import cuda_build, cuda_graph
from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features import fast_cuda
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.features.matching import (
    hamming_matrix,
    match_with_mask,
    rotation_consistency_mask,
    valid_gate,
    window_gate,
)
from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from viorb_tpu_torch.geometry.so3 import matrix_to_quat
from viorb_tpu_torch.mapping.map import MAX_OBS_PER_POINT, KeyFrameData, MapStore
from viorb_tpu_torch.optim.ba import GRAPHED_MAX_POSES, VisionBAState, make_local_vision_ba, pose_bucket
from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
from viorb_tpu_torch.slam.kernels import (
    fuse_match_gathered,
    match_by_projection,
    triangulate_between,
    unpack_local_map,
)
from viorb_tpu_torch.slam.loop_closing import LoopCloser
from viorb_tpu_torch.slam.tracking_loop import TrackCarry, make_pipeline_track_core, make_streaming_track_core
from viorb_tpu_torch.solvers.pnp import pnp_ransac
from viorb_tpu_torch.solvers.two_view import two_view_init

_PAYLOAD = ("xy", "level", "valid", "desc01", "desc_pm1")  # a keyframe's device payload


@dataclass
class FrameRecord:
    timestamp: float
    xy: np.ndarray  # undistorted (N,2)
    level: np.ndarray  # (N,) int32
    angle: np.ndarray
    desc01: Optional[np.ndarray]  # (N,256) uint8; None until host_desc01()
    valid: np.ndarray
    desc_pm1: torch.Tensor  # device (N,256) f32 {-1,+1}, 0 on invalid rows
    r_cw: Optional[np.ndarray] = None
    t_cw: Optional[np.ndarray] = None
    point_idx: Optional[np.ndarray] = None  # (N,) map point per feature
    # device-resident descriptor bits: a steady frame keeps the 256 KB
    # desc01 block OUT of its pull (it is only needed when the frame
    # becomes a keyframe or relocalizes)
    desc01_dev: Optional[torch.Tensor] = None
    # device tensors of the immutable per-frame payload (kept so a frame
    # promoted to keyframe seeds the device payload cache with no upload)
    xy_dev: Optional[torch.Tensor] = None
    level_dev: Optional[torch.Tensor] = None
    valid_dev: Optional[torch.Tensor] = None
    # recorded on the producing stream after the device tensors above (async
    # mode on the card): another thread's stream waits on it before reading them
    ready: Optional[torch.cuda.Event] = None
    # (reference keyframe id, r_rel, t_rel, map version) as the trajectory
    # recorded the frame: async mode re-bases the frame on its keyframe's
    # later pose (MonoSlam._rebase_last_frame)
    ref: Optional[Tuple[int, np.ndarray, np.ndarray, int]] = None
    ur: Optional[np.ndarray] = None  # (N,) stereo right u (-1 none)
    depth: Optional[np.ndarray] = None  # (N,) stereo or RGB-D depth (-1 none)

    def host_desc01(self) -> np.ndarray:
        if self.desc01 is None:
            self.desc01 = self.desc01_dev.cpu().numpy()
        return self.desc01


class MonoSlam:
    """Vision-only monocular SLAM (the reference's System facade for
    TrackMonocular), lock-step, async or streaming (module docstring).
    `device=None` is the card (`viorb_tpu_torch.default_device()`, which
    raises without one); `device="cpu"` runs every device function's plain
    version eagerly, with the same threads. Call `shutdown()` after a
    threaded run. A threaded run captures its cores before its threads
    start, at the first frame's shape and dtype; a frame of another shape or
    dtype stops the threads, captures again and restarts them
    (`recaptures` counts it)."""

    # a monocular map's scale is free; the stereo and RGB-D pipelines pin
    # the loop closer's Sim3 scale (the reference Sim3Solver's bFixScale)
    loop_fix_scale = False
    # fx * baseline of a stereo pipeline: its BAs add the right-u residual
    bf: Optional[float] = None

    def __init__(
        self,
        cam: PinholeCamera,
        n_features: int = 1000,
        local_window: int = 10,
        max_local_points: int = 4096,
        max_ba_landmarks: int = 2048,
        kf_max_interval: int = 10,
        seed: int = 0,
        vocabulary=None,
        enable_loop_closing: bool = False,
        async_mapping: bool = False,
        streaming: bool = False,
        streaming_depth: int = 2,
        device=None,
    ):
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        self.cam = cam
        self.extractor = OrbExtractor(n_features=n_features)
        self.map = MapStore()
        # guards the map for snapshots and write-backs (threaded modes)
        self.map_lock = threading.RLock()
        self.state = "NOT_INITIALIZED"
        self.local_window = local_window
        self.max_local_points = max_local_points
        self.max_ba_landmarks = max_ba_landmarks
        self.kf_max_interval = kf_max_interval
        # ratio-trigger floor (reference mnMinFrames, 0 by default)
        self.kf_min_interval = 0
        self.ref_frame: Optional[FrameRecord] = None
        self.last_frame: Optional[FrameRecord] = None
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # frame poses stored RELATIVE to their reference keyframe and
        # composed with the keyframe's CURRENT pose at export time, so BA
        # refinements propagate to the whole trajectory (reference:
        # mlRelativeFramePoses, src/System.cc SaveTrajectoryTUM)
        self.traj_entries: List[Tuple[float, int, np.ndarray, np.ndarray]] = []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.n_tracked = 0
        self.sigma2 = self.extractor.level_sigma2()
        self._sigma2_dev = self._up(self.sigma2)
        # the graphed tracking cores (built lazily) + the device copy of the
        # padded local map, cached per map epoch
        self._track_core = None
        self._stream_core = None
        self._lm_cache = None
        # the local BA, one CUDA graph a pose bucket (4, 20) on the card;
        # local BAs by how they ran ("local": a window and its anchors,
        # "gba": the post-loop global BA, always eager): replays, eager calls
        self._ba_graph = make_local_vision_ba(cam, self.bf)
        self.ba_replays: Dict[str, int] = {}
        self.ba_eager_calls: Dict[str, int] = {}
        self._ba_count_lock = threading.Lock()
        # kf_id -> device payload (immutable per-KF feature tensors)
        self._kf_dev: dict = {}
        # localization-only: track against the existing map, never insert
        # keyframes or modify the map (reference
        # System::ActivateLocalizationMode -> Tracking::mbOnlyTracking)
        self.localization_only = False
        # no keyframe insertion (a VI relocalization's bias re-solve sets it)
        self.suppress_keyframes = False
        # host-clock ms of each mapping job's phases, in order of the jobs
        # (on the worker's clock when async)
        self.job_times: List[Dict[str, float]] = []
        # place recognition (the reference's KeyFrameDatabase + LoopClosing):
        # a LoopCloser whenever a vocabulary is given
        self.vocabulary = vocabulary
        self.enable_loop_closing = enable_loop_closing
        self.loop_closer: Optional[LoopCloser] = None
        self._new_loop_closer()

        # async mapping (the reference's LocalMapping thread)
        self.async_mapping = async_mapping or streaming
        self.ba_skipped = 0  # BAs skipped in all (only the VI flavour skips one)
        self.kfs_carried = 0  # keyframes made during a solve that followed its write-back
        self._mapping_queue: "queue.Queue[Optional[int]]" = queue.Queue()
        # the deferred local-BA write-back: (its arrays, the solve's device
        # tensors, their event); swapped out and applied under _ba_lock, so a
        # solve is applied exactly once and a flush returns only after a
        # write-back in progress has finished
        self._pending_ba = None
        self._ba_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._worker_stream: Optional[torch.cuda.Stream] = None
        self._threads_registered = 0  # cuda_graph.register_thread() calls to undo at shutdown
        # streaming: the caller's thread dispatches, a collector thread
        # keeps the books (module docstring)
        self.streaming = streaming
        # streaming dispatch blocks while this many mapping jobs are
        # unfinished (2: one job runs while the next waits, and the map stays
        # at most one keyframe interval behind)
        self.mapping_backlog_limit = 2
        # (anchor kf id, r_cw, t_cw, map version) the carry is aligned to
        self._carry_anchor = None
        # re-anchors applied: (|d_t|, max |d_R - I|)
        self.carry_deltas: List[Tuple[float, float]] = []
        # frames in flight at most: bounds device memory and the bookkeeping
        # lag (a keyframe decision arrives at most this many frames late)
        self.streaming_depth = streaming_depth
        self._dev_carry: Optional[TrackCarry] = None
        self._stream_q: list = []  # in flight: (ts, core outputs, point ids, host fields, event)
        self._stream_cv = threading.Condition()
        self._stream_stop = False
        self._stream_fail_count = 0
        self._stream_weak_count = 0
        self._stream_failed = False
        # the frame the last synchronous streaming call tracked (None after a dispatch)
        self._sync_frame: Optional[FrameRecord] = None
        self._collector: Optional[threading.Thread] = None
        self._collector_error: Optional[BaseException] = None
        self.collector_waits = 0  # the collector's host waits: one per batch of frames
        # host ms each dispatched frame spent blocked in the backlog and depth gates
        self.gate_ms: List[float] = []
        # frames of a new shape or dtype taken by a threaded run: each stops
        # the threads, captures the cores at the new key and restarts them
        self.recaptures = 0
        self._threads_key: Optional[tuple] = None
        self._last_info = {"state": self.state, "n_tracked": 0, "n_kfs": 0, "n_points": 0}
        if self._on_card:
            # every kernel library this configuration launches is built and
            # loaded here, on the constructing thread, never inside a mapping
            # job on a worker (a cold nvcc build there stalled a stream's start)
            cuda_build.load_libraries(self._kernel_libraries())
            if vocabulary is not None:
                from viorb_tpu_torch.bow import descend_cuda

                descend_cuda.shared_hist_max_words(self.device)  # loads K8's module into the context

    def _kernel_libraries(self) -> List[str]:
        """The kernel libraries this configuration launches (subclasses add
        theirs: the stereo pipeline's K9)."""
        if self.vocabulary is None:
            return [fast_cuda.LIB_NAME]
        from viorb_tpu_torch.bow import descend_cuda

        return [fast_cuda.LIB_NAME, descend_cuda.LIB_NAME]

    def _new_loop_closer(self):
        """A fresh LoopCloser on the current map (with a vocabulary), wired
        to this pipeline's seam fusion and post-loop GBA, its Sim3 scale
        pinned where the map is metric (`loop_fix_scale`)."""
        if self.vocabulary is None:
            return
        self.loop_closer = LoopCloser(self.map, self.vocabulary, cam=self.cam, device=self.device, lock=self.map_lock,
                                      fix_scale=self.loop_fix_scale)
        self.loop_closer.gba_fn = self._post_loop_gba
        self.loop_closer.fuse_fn = self._fuse_points_into_kf

    # -- host <-> device ---------------------------------------------------

    def _up(self, a, dtype=None) -> torch.Tensor:
        """A numpy array (or number) on the device, C order, on the calling
        thread's stream. On the card the copy goes through pinned memory and
        does not wait for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if not self._on_card:
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _image(self, image) -> torch.Tensor:
        image = torch.as_tensor(image)
        if image.device == self.device:
            return image
        if self._on_card and image.device.type == "cpu":
            return image.contiguous().pin_memory().to(self.device, non_blocking=True)
        return image.to(self.device)

    def _pull_start(self, tensors) -> Tuple[List[np.ndarray], Optional[torch.cuda.Event]]:
        """Start copying the tensors into pinned host memory without
        waiting: (numpy views that hold the bytes once the event has
        completed, that event). On the CPU: copies, and no event."""
        if not self._on_card:
            return [t.detach().numpy().copy() for t in tensors], None
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for o, t in zip(outs, tensors):
            o.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return [o.numpy() for o in outs], done

    def _pull(self, *tensors: torch.Tensor, after: Optional[torch.cuda.Event] = None) -> List[np.ndarray]:
        """The tensors as numpy arrays with ONE wait: each is copied into
        pinned memory without blocking, then the calling thread's stream is
        synchronized once. `after`: an event of another stream the tensors
        were made on, which the copies wait for."""
        if self._on_card and after is not None:
            torch.cuda.current_stream(self.device).wait_event(after)
        host, _ = self._pull_start(tensors)
        if self._on_card:
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _record_ready(self) -> Optional[torch.cuda.Event]:
        """An event behind the work queued so far on the calling thread's
        stream, for another thread's stream to wait on (async mode on the
        card; None otherwise)."""
        if not (self._on_card and self.async_mapping):
            return None
        ready = torch.cuda.Event()
        ready.record()
        return ready

    # -- frames ------------------------------------------------------------

    def _make_frame(self, image, ts) -> FrameRecord:
        feats = self.extractor.extract(self._image(image), device=self.device)
        xy_und = undistort_points(self.cam, feats.xy)
        xy, level, angle, desc01, valid = self._pull(
            xy_und, feats.level, feats.angle, feats.desc01, feats.valid
        )
        return FrameRecord(
            timestamp=ts,
            xy=xy,
            level=level.astype(np.int32),
            angle=angle,
            desc01=desc01,
            valid=valid,
            desc_pm1=feats.descriptors_pm1(),
            point_idx=np.full(feats.xy.shape[0], -1, np.int32),
            desc01_dev=feats.desc01,
            xy_dev=xy_und,
            level_dev=feats.level,
            valid_dev=feats.valid,
            ready=self._record_ready(),
        )

    def process_frame(self, image, ts: float) -> dict:
        """Track one frame (an (H,W) uint8 or f32 image: array or tensor)
        and, when it becomes a keyframe, run the mapping job (lock-step) or
        queue it (async). Returns the state, the tracked-point count and the
        map's keyframe and point counts; when streaming, the counts as the
        collector last left them, and `queued`, the frames in flight."""
        if self.async_mapping:
            self._ensure_threads(image)
        if self.streaming:
            return self._process_frame_streaming(image, ts)
        return self._process_frame_once(image, ts)

    def _info(self) -> dict:
        with self.map_lock:
            return {
                "state": self.state,
                "n_tracked": self.n_tracked,
                "n_kfs": len(self.map.kf_ids()),
                "n_points": len(self.map.active_point_ids()),
            }

    def _process_frame_once(self, image, ts: float) -> dict:
        if self.async_mapping:
            self._rebase_last_frame()
        if (
            self.state != "NOT_INITIALIZED"
            and self.last_frame is not None
            and self.last_frame.r_cw is not None
        ):
            # steady state: one graph replay + one pull per frame
            fr = self._track_fused(image, ts)
        else:
            fr = self._make_frame(image, ts)
            if self.state == "NOT_INITIALIZED":
                self._try_initialize(fr)
            elif not self._relocalize(fr):
                # no motion-model anchor (e.g. resumed from a loaded map):
                # relocalize into the existing map first
                self.state = "LOST"
                self.n_tracked = 0
        if fr.ref is None:  # the motion-model path books its frame itself
            self._record_trajectory(fr, ts)
        self.last_frame = fr
        return self._info()

    def _rebase_last_frame(self):
        """ORB-SLAM's Tracking::UpdateLastFrame: after a BA write-back moved
        the last frame's reference keyframe, the frame's pose becomes its
        recorded pose relative to that keyframe composed with the
        keyframe's current pose, so the motion model predicts in the
        corrected map. Lock-step mode needs none (the job finishes before
        the next frame and the keyframe frame takes its refined pose); the
        reference's async mode has none, its streaming mode re-anchors its
        carry the same way (`_reanchor_carry`)."""
        last = self.last_frame
        if last is None or last.ref is None:
            return
        kf_id, r_rel, t_rel, version = last.ref
        with self.map_lock:
            kf = self.map.keyframes.get(kf_id)
            if kf is None or self.map.version == version:
                return
            last.r_cw = normalize_np(r_rel @ kf.r_cw)
            last.t_cw = (r_rel @ kf.t_cw + t_rel).astype(np.float32)
            last.ref = (kf_id, r_rel, t_rel, self.map.version)

    # -- threads -------------------------------------------------------------

    @staticmethod
    def _frame_key(image) -> tuple:
        """The shape and dtype of a frame: a graph captured for one serves
        frames of the same key."""
        image = torch.as_tensor(image)
        return tuple(image.shape), image.dtype

    def _ensure_threads(self, image):
        """Threaded modes: start the threads at the first frame, and start
        them anew (with the graphs captured at the new key) at a frame of
        another shape or dtype."""
        if self._worker is None:
            self._start_threads(image)
        elif self._frame_key(image) != self._threads_key:
            self._recapture(image)

    def _recapture(self, image):
        """A frame of a new shape or dtype in a threaded run (the reference
        recompiles for it): bring the threads to a quiescent point (the
        collector collects the frames in flight, the worker finishes its
        queue and writes its BA back, both stop and are unregistered), then
        start them again, which captures the cores this mode replays at the
        new key first. No capture runs beside a working thread."""
        self.shutdown()
        self._stream_stop = False
        self.recaptures += 1
        self._start_threads(image)

    def _start_threads(self, image):
        """Start the mapping worker (and the collector when streaming). On
        the card, first capture the cores this mode replays at the shapes of
        `image` and of the padded local map: no capture may run beside the
        threads (cuda_graph.py)."""
        self._threads_key = self._frame_key(image)
        if self._on_card:
            packed, bits, valid = self._point_payload(np.zeros(0, np.int64))
            self._capture_before_threads(
                self._image(image), unpack_local_map(self._up(packed), self._up(bits), self._up(valid)))
            # the worker's stream starts after what this thread queued so far
            # (the level variances, the first frame's uploads)
            self._worker_stream = torch.cuda.Stream(self.device)
            self._worker_stream.wait_stream(torch.cuda.current_stream(self.device))
        threads = [threading.Thread(target=self._mapping_worker, name="viorb-mapping", daemon=True)]
        if self.streaming:
            threads.append(threading.Thread(target=self._collector_loop, name="viorb-collector", daemon=True))
        for t in threads:
            if self._on_card:
                cuda_graph.register_thread()
                self._threads_registered += 1
            t.start()
        self._worker = threads[0]
        self._collector = threads[1] if self.streaming else None

    def _capture_before_threads(self, img: torch.Tensor, dmap):
        """Capture every graph the threads replay, at the frame `img`'s and
        the padded local map `dmap`'s shapes (`_start_threads`, on the
        card): the cores this mode tracks with, and the local BA at both
        pose buckets a window can take (their shapes do not depend on the
        frame: a recapture keeps them). Subclasses add theirs (VI)."""
        eye = self._up(np.eye(3, dtype=np.float32))
        zero = self._up(np.zeros(3, np.float32))
        if self._track_core is None:
            self._track_core = make_pipeline_track_core(self.cam, self.extractor)
        self._track_core.prepare(img, eye, zero, *dmap)
        if self.streaming:
            if self._stream_core is None:
                self._stream_core = make_streaming_track_core(self.cam, self.extractor)
            self._stream_core.prepare(TrackCarry(eye, zero, eye, zero), img, *dmap)
        for k in sorted({pose_bucket(4), GRAPHED_MAX_POSES}):
            self._ba_graph.prepare(*self._placeholder_ba(k))

    def _placeholder_ba(self, k: int):
        """A well-posed local-BA problem of k poses at the local BA's shapes
        (M = max_ba_landmarks, R = MAX_OBS_PER_POINT) to capture its graph
        with: identity poses, every observation slot invalid, the points in
        front of the camera, every pose fixed."""
        m, r = self.max_ba_landmarks, MAX_OBS_PER_POINT
        points = np.zeros((m, 3), np.float32)
        points[:, 2] = 5.0
        state = VisionBAState(self._up(np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3))),
                              self._up(np.zeros((k, 3), np.float32)), self._up(points))
        uv = np.broadcast_to(np.array([self.cam.cx, self.cam.cy], np.float32), (m, r, 2))
        return self._ba_args(state, np.zeros((m, r), np.int64), uv, np.ones((m, r), np.float32),
                             np.zeros((m, r), bool), np.ones(k, bool),
                             (np.full((m, r), -1.0, np.float32), np.zeros((m, r), bool)))

    def _ba_args(self, state, kf_idx, uv, inv_s2, valid, fixed_mask, stereo=None) -> tuple:
        """The local BA graph's arguments on the device: the observation
        grid, then, in a stereo pipeline, `stereo` = (ur, ur_valid), then
        the fixed mask."""
        extra = (self._up(stereo[0]), self._up(stereo[1])) if self.bf is not None else ()
        return (state, self._up(kf_idx, np.int64), self._up(uv), self._up(inv_s2), self._up(valid), *extra,
                self._up(fixed_mask))

    def _count_ba(self, kind: str, replayed: bool):
        counts = self.ba_replays if replayed else self.ba_eager_calls
        with self._ba_count_lock:
            counts[kind] = counts.get(kind, 0) + 1

    def shutdown(self):
        """Stop the collector and the mapping worker (reference
        System::Shutdown); in-flight frames are collected first. Leaves
        `_worker` and `_collector` None."""
        if self._collector is not None:
            with self._stream_cv:
                self._stream_stop = True
                self._stream_cv.notify_all()
            self._join(self._collector)
            self._collector = None
        if self._worker is not None:
            self._mapping_queue.put(None)
            self._join(self._worker)
            self._worker = None
        for _ in range(self._threads_registered):
            cuda_graph.unregister_thread()
        self._threads_registered = 0

    @staticmethod
    def _join(thread: threading.Thread, timeout: float = 60.0):
        thread.join(timeout=timeout)
        if thread.is_alive():
            raise RuntimeError(f"{thread.name} did not stop within {timeout:.0f} s")

    def wait_mapping_idle(self):
        """Block until the stream and the mapping queue drain and the last
        deferred BA is written back (a no-op in lock-step mode). The
        reference's bLocalMapAcceptKF lock-step wait."""
        self.flush_stream()
        if self.async_mapping:
            self._mapping_queue.join()
            self._flush_pending_ba()
            if self._worker_error is not None:
                raise RuntimeError("mapping worker died") from self._worker_error

    def _mapping_worker(self):
        """The worker thread: one mapping job at a time from the queue, every
        device function of it on the worker's own stream."""
        on_stream = torch.cuda.stream(self._worker_stream) if self._worker_stream is not None else nullcontext()
        with on_stream:
            while True:
                kf_id = self._mapping_queue.get()
                try:
                    if kf_id is None:
                        return
                    self._mapping_job(kf_id)
                except Exception as e:  # surfaced by the next insertion or wait
                    self._worker_error = e
                finally:
                    self._mapping_queue.task_done()
                # write the job's deferred BA back right away, AFTER
                # task_done: the backlog gate releases at the job boundary
                # while the BA drains in the worker's idle gap
                try:
                    self._flush_pending_ba()
                except Exception as e:
                    self._worker_error = e

    # -- streaming -------------------------------------------------------------

    def _process_frame_streaming(self, image, ts: float) -> dict:
        """Dispatch-only frame entry: the streaming core runs with the pose
        carry on the card; host bookkeeping happens on the collector thread.
        Initialization, relocalization and a failed stream go through the
        synchronous path, with the stream flushed first."""
        if self._collector_error is not None:
            raise RuntimeError("collector died") from self._collector_error
        steady = self.state != "NOT_INITIALIZED" and not self._stream_failed and self._dev_carry is not None
        if not steady:
            self.flush_stream()
            if self._stream_failed:
                # frames failed in flight: the last good frame is several
                # frames old, so the per-frame velocity no longer applies
                self.velocity = None
                self._dev_carry = None
            self._stream_failed = False
            self._stream_fail_count = 0
            self._stream_weak_count = 0
            prev = self.last_frame
            info = self._process_frame_once(image, ts)
            # The stream resumes only with a velocity measured between this
            # frame and the frame tracked synchronously just before it. A
            # carry seeded without one (after initialization or relocalization)
            # or with one measured across frames lost in flight mispredicts
            # the next two frames on a fast camera; they fail in flight, and
            # the stream cycles through failure and resynchronization (the
            # reference reseeds at once)
            one_step = prev is not None and prev is self._sync_frame
            self._sync_frame = self.last_frame if self.state == "OK" else None
            if (one_step and self.state == "OK" and self.velocity is not None and self.last_frame is not None
                    and self.last_frame.r_cw is not None):
                self._seed_stream_carry()
            self._last_info = info
            return info
        self._sync_frame = None
        if self._stream_core is None:
            self._stream_core = make_streaming_track_core(self.cam, self.extractor)
        # overload guard: while the worker is `mapping_backlog_limit` jobs
        # behind, block (degrade toward lock-step) rather than race ahead of
        # the map
        t_gate = time.perf_counter()
        deadline = time.monotonic() + 30.0
        while (
            self._mapping_queue.unfinished_tasks >= self.mapping_backlog_limit
            and self._worker_error is None
            and time.monotonic() < deadline
        ):
            time.sleep(0.002)
        gate_s = time.perf_counter() - t_gate
        pts, dmap = self._device_local_map()
        anchor = self._reanchor_carry()
        carry, outs = self._stream_core(self._dev_carry, self._image(image), *dmap)
        self._dev_carry = carry
        feats = outs[0]
        # the copies of the ten bookkeeping fields start NOW, behind one
        # event (the counterpart of the reference's copy_to_host_async)
        host, ready = self._pull_start(
            (outs[1], feats.level, feats.angle, feats.valid, outs[3], outs[4], outs[5], outs[6], outs[7], outs[8])
        )
        # adaptive depth: at low confidence every lagged frame costs
        # accuracy, so run at depth 1 until tracking is solid again
        depth = self.streaming_depth if self.n_tracked >= 24 else 1
        t_gate = time.perf_counter()
        with self._stream_cv:
            while len(self._stream_q) >= depth and self._collector_error is None:
                self._stream_cv.wait(timeout=1.0)
            self.gate_ms.append((gate_s + time.perf_counter() - t_gate) * 1e3)
            self._stream_q.append((ts, outs, pts, host, ready, anchor))
            self._stream_cv.notify_all()
            queued = len(self._stream_q)
        return dict(self._last_info, queued=queued)

    def _reanchor_carry(self):
        """Keep the carry's pose RELATIVE to its keyframe across a published
        map update (BA moves the keyframe): T_f' = T_f o (T_kf_old^-1 o
        T_kf_new), applied on the card from the host delta, no sync. The
        streaming counterpart of the lock-step post-BA frame resync.
        Returns the anchor the carry is now relative to: (keyframe id, its
        pose, map version)."""
        delta = None
        with self.map_lock:
            anchor, ver = self._carry_anchor, self.map.version
            if anchor is not None and anchor[3] != ver:
                akf = self.map.keyframes.get(anchor[0])
                if akf is not None:
                    r_old, t_old = anchor[1], anchor[2]
                    d_r = r_old.T @ akf.r_cw
                    d_t = r_old.T @ (akf.t_cw - t_old)
                    if np.abs(d_t).max() > 1e-7 or np.abs(d_r - np.eye(3)).max() > 1e-7:
                        delta = d_r, d_t
                        self.carry_deltas.append((float(np.linalg.norm(d_t)), float(np.abs(d_r - np.eye(3)).max())))
                        del self.carry_deltas[:-256]
            kf = self.map.keyframes.get(self.last_kf_id)
            if kf is not None:
                self._carry_anchor = (self.last_kf_id, kf.r_cw.copy(), kf.t_cw.copy(), ver)
            anchor = self._carry_anchor
        if delta is not None:
            c = self._dev_carry
            d_r, d_t = self._up(delta[0], np.float32), self._up(delta[1], np.float32)
            self._dev_carry = TrackCarry(c.r_cw @ d_r, c.r_cw @ d_t + c.t_cw, c.vel_r, c.vel_t)
        return anchor

    def _seed_stream_carry(self):
        last = self.last_frame
        if self.velocity is not None:
            vr, vt = self.velocity
        else:
            vr, vt = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self._dev_carry = TrackCarry(
            self._up(last.r_cw, np.float32), self._up(last.t_cw, np.float32),
            self._up(vr, np.float32), self._up(vt, np.float32),
        )
        with self.map_lock:
            kf = self.map.keyframes.get(self.last_kf_id)
            self._carry_anchor = (
                None if kf is None else (self.last_kf_id, kf.r_cw.copy(), kf.t_cw.copy(), self.map.version)
            )

    def flush_stream(self):
        """Block until every in-flight streamed frame has been collected (a
        no-op outside streaming mode)."""
        if self._collector is None:
            return
        with self._stream_cv:
            while self._stream_q and self._collector_error is None:
                self._stream_cv.wait(timeout=1.0)
        if self._collector_error is not None:
            raise RuntimeError("collector died") from self._collector_error

    def _collector_loop(self):
        while True:
            with self._stream_cv:
                while not self._stream_q and not self._stream_stop:
                    self._stream_cv.wait()
                if self._stream_stop and not self._stream_q:
                    return
                batch = list(self._stream_q)
            try:
                self._collect_batch(batch)
            except Exception as e:  # surfaced by the next dispatch or flush
                self._collector_error = e
            with self._stream_cv:
                del self._stream_q[: len(batch)]
                self._stream_cv.notify_all()
            if self._collector_error is not None:
                return

    def _collect_batch(self, batch):
        """ONE wait for a batch of in-flight frames, on the last one's event
        (the frames were queued in order on one stream), then the same
        per-frame host logic as the synchronous path."""
        last_ready = batch[-1][4]
        if last_ready is not None:
            last_ready.synchronize()
            self.collector_waits += 1
        for ts, outs, pts, host, ready, anchor in batch:
            feats, xy_d, fdesc = outs[0], outs[1], outs[2]
            xy, level, angle, fvalid, pf, r_new, t_new, inl, visible, ok = host
            fr = FrameRecord(
                timestamp=ts,
                xy=xy,
                level=level.astype(np.int32),
                angle=angle,
                desc01=None,
                valid=fvalid,
                desc_pm1=fdesc,
                point_idx=np.full(xy.shape[0], -1, np.int32),
                desc01_dev=feats.desc01,
                xy_dev=xy_d,
                level_dev=feats.level,
                valid_dev=feats.valid,
                ready=ready,
            )
            if not bool(ok):
                # the device carry froze at the last good pose, so a
                # one-frame dropout heals itself; a second failure in a row
                # hands control back to the synchronous fallback chain
                self._stream_fail_count += 1
                if self._stream_fail_count >= 2:
                    self._stream_failed = True
                    self.state = "LOST"
                self._last_info = dict(self._last_info, state=self.state)
                continue
            self._stream_fail_count = 0
            self.n_tracked = int(inl.sum())
            # weak streak: 3 accepted frames in a row under 20 inliers mean
            # the carry is sliding off the map: fall back before it derails
            if self.n_tracked < 20:
                self._stream_weak_count += 1
                if self._stream_weak_count >= 3:
                    self._stream_failed = True
            else:
                self._stream_weak_count = 0
            self.state = "OK"
            with self.map_lock:
                # the frame was tracked in the map as its dispatch saw it: a
                # write-back since (a BA, a loop correction) that moved its
                # anchor keyframe moves the frame along, as the next
                # dispatch re-anchors the carry
                fr.r_cw, fr.t_cw = r_new, t_new
                akf = None if anchor is None else self.map.keyframes.get(anchor[0])
                if akf is not None and _moved(akf, anchor):
                    fr.r_cw, fr.t_cw = _moved_with(r_new, t_new, anchor[1], anchor[2], akf.r_cw, akf.t_cw)
                self._count_tracked(fr, pts, pf, inl, visible)
                self.frames_since_kf += 1
                if self._need_new_keyframe(ts):
                    self._insert_keyframe(fr)
                    self.frames_since_kf = 0
                    # anchor the carry to the NEW keyframe at its insertion
                    # pose: when its job publishes, the next dispatch
                    # re-anchors the carry by exactly the insertion -> BA
                    # delta. If the carry has yet to take its anchor's move,
                    # the new anchor is the keyframe's pose in the carry's
                    # frame, so the carry takes that move through it.
                    ca = self._carry_anchor
                    ckf = None if ca is None else self.map.keyframes.get(ca[0])
                    if ckf is not None and _moved(ckf, ca):
                        r_a, t_a = _moved_with(fr.r_cw, fr.t_cw, ckf.r_cw, ckf.t_cw, ca[1], ca[2])
                        self._carry_anchor = (self.last_kf_id, r_a, t_a, ca[3])
                    else:
                        self._carry_anchor = (self.last_kf_id, fr.r_cw.copy(), fr.t_cw.copy(), self.map.version)
                self._record_trajectory(fr, ts)
            self.last_frame = fr
            self._last_info = self._info()

    # -- initialization ----------------------------------------------------

    def _try_initialize(self, fr: FrameRecord):
        if self.ref_frame is None or fr.timestamp - self.ref_frame.timestamp > 1.0:
            if fr.valid.sum() > 100:
                self.ref_frame = fr
            return
        ref = self.ref_frame
        # wide-window matching ref <-> cur (reference SearchForInitialization)
        d = hamming_matrix(ref.desc_pm1, fr.desc_pm1)
        gate = valid_gate(ref.valid_dev, fr.valid_dev) & window_gate(ref.xy_dev, fr.xy_dev, 100.0)
        res = match_with_mask(d, gate, max_dist=50.0, ratio=0.9, mutual=True)
        rot_ok = rotation_consistency_mask(self._up(ref.angle), self._up(fr.angle), res.idx)
        (idx,) = self._pull(torch.where(rot_ok, res.idx, -1))
        matched = np.nonzero(idx >= 0)[0]
        if len(matched) < 100:
            if fr.valid.sum() > 100:
                self.ref_frame = fr
            return
        n = ref.xy.shape[0]
        x1 = np.zeros((n, 2), np.float32)
        x2 = np.zeros((n, 2), np.float32)
        valid = np.zeros(n, bool)
        x1[matched] = ref.xy[matched]
        x2[matched] = fr.xy[idx[matched]]
        valid[matched] = True
        result = two_view_init(self._up(x1), self._up(x2), self._up(valid), self.cam, self.generator)
        success, R2, t2, X, inl = self._pull(
            result.success, result.r_cw2, result.t_cw2, result.points, result.is_inlier
        )
        if not bool(success):
            return
        # build initial map (reference CreateInitialMapMonocular)
        med_depth = float(np.median(X[inl, 2]))
        if med_depth <= 0:
            return
        scale = 1.0 / med_depth
        X = X * scale
        t2 = t2 * scale

        ref.r_cw = np.eye(3, dtype=np.float32)
        ref.t_cw = np.zeros(3, np.float32)
        fr.r_cw, fr.t_cw = R2.astype(np.float32), t2.astype(np.float32)

        id0 = self.map.add_keyframe(self._kf_from_frame(ref))
        kf1 = self._kf_from_frame(fr)
        id1 = self.map.add_keyframe(kf1)
        kf1.parent_kf = id0  # spanning-tree root edge
        for i in matched:
            if not inl[i]:
                continue
            j = idx[i]
            p = self.map.add_point(X[i], ref.desc01[i], id0, int(i))
            self.map.add_observation(p, id1, int(j))
            fr.point_idx[j] = p
        self.map.update_point_stats(self.map.active_point_ids())
        # full BA on the initial two-KF map
        self._local_ba([id0, id1], fixed=[id0])
        kf1_ = self.map.keyframes[id1]
        fr.r_cw, fr.t_cw = kf1_.r_cw.copy(), kf1_.t_cw.copy()
        self.last_kf_id = id1
        self.frames_since_kf = 0
        self.velocity = None
        self.state = "OK"
        self.n_tracked = int(inl.sum())

    def _kf_from_frame(self, fr: FrameRecord) -> KeyFrameData:
        # a steady frame's descriptors live on the device: DEFER the 256 KB
        # pull to the mapping job's batched pull (KeyFrameData.ensure_desc01)
        defer = fr.desc01 is None and fr.desc01_dev is not None
        return KeyFrameData(
            kf_id=-1,
            timestamp=fr.timestamp,
            r_cw=fr.r_cw.copy(),
            t_cw=fr.t_cw.copy(),
            xy=fr.xy.copy(),
            level=fr.level.copy(),
            angle=fr.angle.copy(),
            desc01=None if defer else fr.host_desc01().copy(),
            valid=fr.valid.copy(),
            point_idx=np.full(fr.xy.shape[0], -1, np.int32),
            ur=None if fr.ur is None else fr.ur.copy(),
            desc01_dev=fr.desc01_dev if defer else None,
        )

    # -- tracking ------------------------------------------------------------

    def _predict_pose(self) -> Tuple[np.ndarray, np.ndarray]:
        """The constant-velocity prediction from the last frame."""
        last = self.last_frame
        if self.velocity is not None and last.r_cw is not None:
            Rv, tv = self.velocity
            return normalize_np(Rv @ last.r_cw), (Rv @ last.t_cw + tv).astype(np.float32)
        return last.r_cw.copy(), last.t_cw.copy()

    def _local_kf_ids(self) -> List[int]:
        if self.last_kf_id < 0:
            return []
        cov = self.map.covisibility_weights(self.last_kf_id)
        ids = sorted(cov, key=cov.get, reverse=True)[: self.local_window * 2]
        return [self.last_kf_id] + ids

    def _gather_local_points_packed(self, kf_ids: List[int]):
        """Local-map payload gathered into ONE packed float block + the
        descriptor bits + validity, padded to `max_local_points`."""
        pts = self.map.local_map_points(kf_ids)[: self.max_local_points]
        packed, bits, valid = self._point_payload(pts)
        valid[: len(pts)] = True
        return pts, packed, bits, valid

    def _point_payload(self, pt_ids: np.ndarray):
        """(packed (cap,8) f32 xyz | normal | dmin | dmax, bits (cap,32)
        uint8, valid (cap,) bool all False) of the first `max_local_points`
        of `pt_ids`; padded rows read dmax 1e9."""
        cap = self.max_local_points
        m = len(pt_ids)
        packed = np.zeros((cap, 8), np.float32)
        bits = np.zeros((cap, 32), np.uint8)
        packed[:m, 0:3] = self.map.pt_xyz[pt_ids]
        packed[:m, 3:6] = self.map.pt_normal[pt_ids]
        packed[:m, 6] = self.map.pt_min_dist[pt_ids]
        packed[m:, 7] = 1e9
        packed[:m, 7] = self.map.pt_max_dist[pt_ids]
        bits[:m] = np.packbits(self.map.pt_desc01[pt_ids], axis=1, bitorder="little")
        return packed, bits, np.zeros(cap, bool)

    def _device_local_map(self):
        """(point ids, the tracking core's map arguments on the device),
        re-gathered only when mapping publishes an update (map.version) or
        the reference keyframe changes, so a steady frame uploads nothing
        but the image and the predicted pose."""
        with self.map_lock:
            key = (id(self.map), self.map.version, self.last_kf_id)
            cache = self._lm_cache
            if cache is not None and cache[0] == key:
                return cache[1], cache[2]
            pts, packed, bits, valid = self._gather_local_points_packed(self._local_kf_ids())
        dev = unpack_local_map(self._up(packed), self._up(bits), self._up(valid))
        self._lm_cache = (key, pts, dev)
        return pts, dev

    # -- per-keyframe device payload cache ---------------------------------

    _KF_DEV_CAP = 64  # payload entries kept resident (~1.3 MB each at 1000 features)

    def _seed_kf_payload(self, kf_id: int, fr: FrameRecord):
        """Register the (immutable) feature payload of a new keyframe with
        the device tensors the tracked frame already owns, and the frame's
        event: triangulation and fusion then upload nothing of it."""
        if fr.xy_dev is None or fr.level_dev is None or fr.valid_dev is None:
            return
        desc01 = fr.desc01_dev if fr.desc01_dev is not None else self._up(fr.host_desc01())
        ent = dict(xy=fr.xy_dev, level=fr.level_dev, valid=fr.valid_dev, desc01=desc01, desc_pm1=fr.desc_pm1,
                   ready=fr.ready)
        with self.map_lock:
            self._kf_dev[kf_id] = ent
            self._trim_kf_payloads()

    def _kf_payload(self, kf_id: int) -> dict:
        """Device payload of a keyframe (xy, level, valid, desc01 u8,
        desc_pm1 f32), uploaded once and cached. A payload another stream
        made is first ordered after it on the calling thread's stream, and
        its tensors are recorded as used there, so the allocator keeps them
        until that stream's work on them is done."""
        with self.map_lock:
            ent = self._kf_dev.get(kf_id)
            kf = self.map.keyframes[kf_id] if ent is None else None
        if ent is None:
            desc01 = self._up(kf.ensure_desc01())
            valid = self._up(kf.valid)
            ent = dict(
                xy=self._up(kf.xy),
                level=self._up(kf.level, np.int64),
                valid=valid,
                desc01=desc01,
                desc_pm1=(desc01.to(torch.float32) * 2 - 1) * valid.to(torch.float32)[:, None],
            )
            with self.map_lock:
                ent = self._kf_dev.setdefault(kf_id, ent)
                self._trim_kf_payloads()
        ready = ent.pop("ready", None)  # the first reader orders its stream; later reads follow it
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for name in _PAYLOAD:
                ent[name].record_stream(stream)
        return ent

    def _trim_kf_payloads(self):
        while len(self._kf_dev) > self._KF_DEV_CAP:
            # dict order is insertion order: drop the oldest entry (old
            # keyframes leave the triangulation/fusion neighborhood)
            self._kf_dev.pop(next(iter(self._kf_dev)))

    def _track_fused(self, image, ts: float) -> FrameRecord:
        """Steady-state tracking as ONE graph replay + ONE pull: extraction,
        projection matching (wide-radius retry on the device) and the pose
        LM run in the graphed pipeline core; the host reads the bookkeeping
        fields once for the map counters and the keyframe decision. `_track`
        stays the fallback for the rare low-match / low-inlier frames
        (reference-KF matching -> relocalization -> LOST)."""
        if self._track_core is None:
            self._track_core = make_pipeline_track_core(self.cam, self.extractor)
        with self.map_lock:
            # the prediction, the local map and the reference keyframe's pose
            # from one map state: a write-back (a BA, a loop correction) that
            # lands while the frame is tracked moves the frame along with its
            # reference keyframe before it is booked, as a streamed frame is
            if self.async_mapping:
                self._rebase_last_frame()
            r_pred, t_pred = self._predict_pose()
            pts, dev = self._device_local_map()
            kf = self.map.keyframes.get(self.last_kf_id)
            anchor = None if kf is None else (self.last_kf_id, kf.r_cw.copy(), kf.t_cw.copy())
        feats, xy_d, fdesc, pf_d, r_d, t_d, inl_d, vis_d, _n = self._track_core(
            self._image(image), self._up(r_pred), self._up(t_pred), *dev
        )
        ready = self._record_ready()
        xy, level, angle, fvalid, pf, r_new, t_new, inl, visible = self._pull(
            xy_d, feats.level, feats.angle, feats.valid, pf_d, r_d, t_d, inl_d, vis_d
        )
        fr = FrameRecord(
            timestamp=ts,
            xy=xy,
            level=level.astype(np.int32),
            angle=angle,
            desc01=None,
            valid=fvalid,
            desc_pm1=fdesc,
            point_idx=np.full(xy.shape[0], -1, np.int32),
            desc01_dev=feats.desc01,
            xy_dev=xy_d,
            level_dev=feats.level,
            valid_dev=feats.valid,
            ready=ready,
        )
        fr.r_cw, fr.t_cw = r_pred, t_pred
        n_inl = int(inl.sum())
        if int((pf >= 0).sum()) < 10 or n_inl < 10:
            self._track(fr)  # rare: the host-stepped fallback chain
            return fr
        with self.map_lock:
            fr.r_cw, fr.t_cw = r_new, t_new
            akf = None if anchor is None else self.map.keyframes.get(anchor[0])
            if akf is not None and _moved(akf, anchor):
                fr.r_cw, fr.t_cw = _moved_with(r_new, t_new, anchor[1], anchor[2], akf.r_cw, akf.t_cw)
                # the last frame into the same map state: the velocity spans one frame
                self._rebase_last_frame()
            self.n_tracked = n_inl
            self.state = "OK"
            self._count_tracked(fr, pts, pf, inl, visible)
            self._track_epilogue(fr)
            self._record_trajectory(fr, ts)
        return fr

    def _count_tracked(self, fr: FrameRecord, pts, pf, inl, visible):
        """Bind the frame's inlier features to their points and bump the
        points' visible / found counters."""
        ok_feats = np.nonzero((pf >= 0) & inl)[0]
        fr.point_idx[ok_feats] = pts[pf[ok_feats]]
        if not len(pts):
            return
        with self.map_lock:
            vis = visible[: len(pts)]
            alive = self.map.pt_active[pts]
            self.map.pt_visible[pts[vis & alive[: len(vis)]]] += 1
            ok_alive = ok_feats[self.map.pt_active[fr.point_idx[ok_feats]]]
            self.map.pt_found[fr.point_idx[ok_alive]] += 1

    def _track(self, fr: FrameRecord):
        r_pred, t_pred = self._predict_pose()
        fr.r_cw, fr.t_cw = r_pred, t_pred
        pts, dmap = self._device_local_map()

        def run_match(radius):
            pf, _res, n, visible = match_by_projection(
                *dmap, self._up(fr.r_cw), self._up(fr.t_cw), fr.xy_dev, fr.desc_pm1, fr.valid_dev,
                self.cam, radius,
            )
            return pf, n, visible

        pf_d, n, visible = run_match(15.0)
        if int(n) < 20:
            pf_d, n, visible = run_match(30.0)
        n_matched = int((pf_d >= 0).sum())
        if n_matched < 10:
            # motion-model projection failed: fall back to descriptor
            # matching against the reference keyframe (reference
            # Tracking::TrackReferenceKeyFrame), then relocalization. On
            # fallback success the corrected pose re-seeds the local-map
            # projection and tracking falls THROUGH to the normal pose-opt
            # + keyframe decision (an early return starves the map of
            # keyframes and decays into permanent fallback).
            recovered = self._track_reference_keyframe(fr)
            if recovered:
                pf_d, n, visible = run_match(15.0)
                n_matched = int((pf_d >= 0).sum())
            if n_matched < 10:
                if recovered:
                    # keep the fallback's reference-KF matches
                    self._track_epilogue(fr)
                    return
                if self._relocalize(fr):
                    return
                self.state = "LOST"
                self.n_tracked = 0
                return

        # pose-only optimization over the matches
        obs = PoseObs(
            points=dmap[0][pf_d.clamp(min=0)], uv=fr.xy_dev,
            inv_sigma2=1.0 / self._sigma2_dev[fr.level_dev], valid=pf_d >= 0,
        )
        r_opt, t_opt, inlier = pose_optimization_tcw(self._up(fr.r_cw), self._up(fr.t_cw), obs, self.cam)
        fr.r_cw, fr.t_cw, inl, pf, vis = self._pull(r_opt, t_opt, inlier, pf_d, visible)
        self.n_tracked = int(inl.sum())
        if self.n_tracked < 10:
            if self._track_reference_keyframe(fr):
                self._track_epilogue(fr)
                return
            if self._relocalize(fr):
                return
            self.state = "LOST"
            return
        self.state = "OK"
        fr.point_idx = np.full(fr.xy.shape[0], -1, np.int32)
        self._count_tracked(fr, pts, pf, inl, vis)
        self._track_epilogue(fr)

    def _track_epilogue(self, fr: FrameRecord):
        """Velocity-model update + keyframe decision; shared by the
        motion-model path and the reference-keyframe fallback."""
        last = self.last_frame
        if last is not None and last.r_cw is not None:
            Rl_inv = last.r_cw.T
            tl_inv = -Rl_inv @ last.t_cw
            self.velocity = (normalize_np(fr.r_cw @ Rl_inv), fr.r_cw @ tl_inv + fr.t_cw)
        # keyframe decision (NeedNewKeyFrame, reference
        # src/Tracking.cc:1711-1814): interval cap, ratio trigger gated by a
        # min-frames floor
        self.frames_since_kf += 1
        if self._need_new_keyframe(fr.timestamp):
            self._insert_keyframe(fr)
            self.frames_since_kf = 0

    def _need_new_keyframe(self, ts: float) -> bool:
        """The vision rules (`ts`, the frame's time, is for subclasses: the
        VI time-gap rule); none while keyframes are suppressed (a VI
        relocalization's bias re-solve) or in localization-only mode."""
        if self.suppress_keyframes or self.localization_only or self.n_tracked <= 15:
            return False
        with self.map_lock:
            ref_tracked = int((self.map.keyframes[self.last_kf_id].point_idx >= 0).sum())
        interval_hit = self.frames_since_kf >= self.kf_max_interval
        ratio_hit = (
            self.frames_since_kf >= self.kf_min_interval
            and self.n_tracked < 0.6 * max(ref_tracked, 1)
        )
        if not (interval_hit or ratio_hit):
            return False
        if self.async_mapping and self._mapping_queue.unfinished_tasks >= 2:
            # mapping saturated (2 jobs queued or running): only a twice
            # blown interval cap inserts, so keyframe production cannot
            # outrun the worker (the reference gates on AcceptKeyFrames())
            return self.frames_since_kf >= 2 * self.kf_max_interval
        return True

    def _match_keyframe(self, kf: KeyFrameData, fr: FrameRecord, has: np.ndarray):
        """Mutual descriptor matching of the keyframe's features `has` (with
        a map point) against the frame's (ratio 0.85): the (N_kf,) device
        result, best frame feature or -1."""
        d_k = self._up(kf.ensure_desc01(), np.float32) * 2 - 1
        dist = hamming_matrix(d_k, fr.desc_pm1)
        gate = valid_gate(self._up(has), fr.valid_dev)
        return match_with_mask(dist, gate, max_dist=50.0, ratio=0.85, mutual=True)

    def _track_reference_keyframe(self, fr: FrameRecord) -> bool:
        """Wide descriptor matching against the reference keyframe's
        map-point features, then pose-only optimization seeded from the last
        frame's pose (reference Tracking::TrackReferenceKeyFrame; raw
        descriptor matching in place of BoW buckets)."""
        if self.last_kf_id < 0:
            return False
        with self.map_lock:  # a snapshot: the worker may bind and move points meanwhile
            kf = self.map.keyframes.get(self.last_kf_id)
            if kf is None:
                return False
            pt_ids = kf.point_idx.copy()
            pt_xyz = self.map.pt_xyz[np.maximum(pt_ids, 0)]
        has = (pt_ids >= 0) & kf.valid
        if has.sum() < 15:
            return False
        res = self._match_keyframe(kf, fr, has)
        rot_ok = rotation_consistency_mask(self._up(kf.angle), self._up(fr.angle), res.idx)
        (idx,) = self._pull(torch.where(rot_ok, res.idx, -1))
        mk = np.nonzero(idx >= 0)[0]
        if len(mk) < 15:
            return False
        mf = idx[mk]
        nf = fr.xy.shape[0]
        pts = np.zeros((nf, 3), np.float32)
        valid = np.zeros(nf, bool)
        pts[mf] = pt_xyz[mk]
        valid[mf] = True
        obs = PoseObs(
            points=self._up(pts), uv=fr.xy_dev,
            inv_sigma2=1.0 / self._sigma2_dev[fr.level_dev], valid=self._up(valid),
        )
        # seed from the last successfully tracked pose, not the (possibly
        # corrupted) motion-model prediction (reference seeds with
        # mLastFrame.mTcw)
        last = self.last_frame
        if last is not None and last.r_cw is not None:
            r_seed, t_seed = last.r_cw, last.t_cw
        else:
            r_seed, t_seed = kf.r_cw, kf.t_cw
        r_opt, t_opt, inlier = pose_optimization_tcw(self._up(r_seed), self._up(t_seed), obs, self.cam)
        r_opt, t_opt, inl = self._pull(r_opt, t_opt, inlier)
        if int(inl.sum()) < 10:
            return False
        fr.r_cw, fr.t_cw = r_opt, t_opt
        feat_to_pt = np.full(nf, -1, np.int32)
        feat_to_pt[mf] = pt_ids[mk]
        fr.point_idx = np.where(inl & (feat_to_pt >= 0), feat_to_pt, -1).astype(np.int32)
        self.n_tracked = int(inl.sum())
        self.state = "OK"
        return True

    def _relocalize(self, fr: FrameRecord) -> bool:
        """Candidate keyframes -> descriptor matching to their map points ->
        PnP RANSAC -> pose-only refinement (reference
        Tracking::Relocalization, src/Tracking.cc:2127-2291). With a
        vocabulary the candidates are the keyframe database's 5 best for the
        frame's BoW (the host transform, as in the reference); without one,
        the 5 keyframes with the most mutual descriptor matches, one batched
        Hamming matmul per keyframe."""
        if self.loop_closer is not None:
            _, qbow = self.vocabulary.transform(fr.host_desc01(), fr.valid)
        with self.map_lock:  # a snapshot: the worker may cull keyframes meanwhile
            snap = {kid: (kf, kf.point_idx.copy()) for kid, kf in self.map.keyframes.items()}
            if self.loop_closer is not None:
                cands = self.loop_closer.db.query(qbow, max_results=5)
        if self.loop_closer is None:
            scored = []
            for kid, (kf_c, pt_ids) in snap.items():
                has_c = (pt_ids >= 0) & kf_c.valid
                if has_c.sum() < 15:
                    continue
                res_c = self._match_keyframe(kf_c, fr, has_c)
                scored.append((kid, int((res_c.idx >= 0).sum())))
            cands = sorted(scored, key=lambda x: -x[1])[:5]
        for cand_id, _score in cands:
            if cand_id not in snap:
                continue
            kf, pt_ids = snap[cand_id]
            has = (pt_ids >= 0) & kf.valid
            (idx,) = self._pull(self._match_keyframe(kf, fr, has).idx)
            mk = np.nonzero(idx >= 0)[0]
            if len(mk) < 15:
                continue
            mf = idx[mk]
            nf = fr.xy.shape[0]
            pts = np.zeros((nf, 3), np.float32)
            valid = np.zeros(nf, bool)
            with self.map_lock:
                pts[mf] = self.map.pt_xyz[pt_ids[mk]]
            valid[mf] = True
            pts_d = self._up(pts)
            out = pnp_ransac(pts_d, fr.xy_dev, self._up(valid), self.cam, self.generator)
            if not bool(out.success):
                continue
            obs = PoseObs(points=pts_d, uv=fr.xy_dev, inv_sigma2=torch.ones_like(pts_d[:, 0]), valid=out.inliers)
            r_ref, t_ref, inl = pose_optimization_tcw(out.r_cw, out.t_cw, obs, self.cam)
            r_ref, t_ref, inl = self._pull(r_ref, t_ref, inl)
            if int(inl.sum()) < 15:
                continue
            fr.r_cw, fr.t_cw = r_ref, t_ref
            self.state = "OK"
            self.velocity = None
            self.n_tracked = int(inl.sum())
            return True
        return False

    # -- mapping -------------------------------------------------------------

    def _insert_keyframe(self, fr: FrameRecord):
        """Create the keyframe and register its tracked observations, then
        either run the mapping job and resync the frame to the keyframe's
        refined pose (lock-step) or hand the job to the worker (async)."""
        kf = self._kf_from_frame(fr)
        with self.map_lock:
            kf_id = self.map.add_keyframe(kf)
            for f in np.nonzero(fr.point_idx >= 0)[0]:
                p = int(fr.point_idx[f])
                if self.map.pt_active[p]:
                    self.map.add_observation(p, kf_id, int(f))
        self._seed_kf_payload(kf_id, fr)
        self.last_kf_id = kf_id
        # subclass hook (VI: the IMU segment, chain links and NavState) runs
        # BEFORE the job can start: the worker reads what it attaches
        self._on_keyframe_created(fr, kf_id)
        if self.async_mapping:
            if self._worker_error is not None:
                raise RuntimeError("mapping worker died") from self._worker_error
            self._mapping_queue.put(kf_id)
            return
        self._mapping_job(kf_id)
        with self.map_lock:
            kf_ = self.map.keyframes[kf_id]
            fr.r_cw, fr.t_cw = kf_.r_cw.copy(), kf_.t_cw.copy()

    def _on_keyframe_created(self, fr: FrameRecord, kf_id: int):
        """Hook between keyframe creation and the mapping job's dispatch."""

    def _mapping_job(self, kf_id: int):
        """The LocalMapping step for one keyframe: the previous job's
        deferred BA written back, triangulation + fusion (dispatched
        together, drained with ONE pull), point statistics, windowed BA
        (deferred when async), culling. Appends its phases' host-clock ms to
        `job_times` (a dispatch returns before the device finishes; the
        pull waits for what is left)."""
        self._flush_pending_ba()
        times = {}
        t0 = tick = time.perf_counter()

        def lap(name):
            nonlocal tick
            now = time.perf_counter()
            times[name] = (now - tick) * 1e3
            tick = now

        with self.map_lock:
            if kf_id not in self.map.keyframes:
                return
            cov = self.map.covisibility_weights(kf_id)
            # spanning-tree parent: older KF with max shared observations
            # (reference attaches mpParent at LocalMapping acceptance)
            older = {k: w for k, w in cov.items() if k < kf_id and k in self.map.keyframes}
            if older:
                self.map.keyframes[kf_id].parent_kf = max(older, key=older.get)
            else:
                prior = [k for k in self.map.keyframes if k < kf_id]
                self.map.keyframes[kf_id].parent_kf = max(prior, default=-1)
        self._kf_payload(kf_id)  # orders this stream after the tracked frame's tensors
        neighbors = sorted(cov, key=cov.get, reverse=True)[:3]
        # triangulation (CreateNewMapPoints) and fusion (SearchInNeighbors)
        # dispatched back to back, ONE pull for both. Fusion runs on the
        # PRE-triangulation point sets: this job's new points are fused by
        # the NEXT job instead (one-KF lag, as in the reference).
        tri_launches = self._tri_dispatch(kf_id, neighbors)
        lap("triangulation")
        fuse_launches, _own, nb_pts = self._fuse_batch_dispatch(kf_id, neighbors)
        lap("fusion")
        self._pull_and_merge(kf_id, tri_launches, fuse_launches, lap)
        with self.map_lock:
            touched = self.map.local_map_points([kf_id])
            if len(nb_pts):
                touched = np.unique(np.concatenate([touched, nb_pts]))
            self.map.update_point_stats(touched[self.map.pt_active[touched]])
        window = [kf_id] + sorted(cov, key=cov.get, reverse=True)[: self.local_window - 1]
        lap("stats")
        self._mapping_ba(kf_id, window)
        lap("ba")
        with self.map_lock:
            self._cull_points()
            self._cull_keyframes(window)
        lap("culling")
        if self.loop_closer is not None:
            # place recognition on the settled keyframe (the reference's
            # LoopClosing step): its BoW into the database through K8, then
            # detection, verification and correction, with the map lock held
            # from the BoW to the end of the closure, as the reference holds
            # it: the map the closure verified is the map it corrects, and a
            # tracker thread waits for the correction
            self._flush_pending_ba()
            with self.map_lock:
                if kf_id in self.map.keyframes:
                    pay = self._kf_payload(kf_id)
                    self.loop_closer.add_keyframe(kf_id, pay["desc01"], pay["valid"])
                    lap("bow")
                    if self.enable_loop_closing:
                        self.loop_closer.try_close(kf_id, lap)
        with self.map_lock:
            self.map.version += 1
        times["total"] = (time.perf_counter() - t0) * 1e3
        self.job_times.append(times)

    def _pull_and_merge(self, kf_id: int, tri_launches, fuse_launches, lap=lambda name: None):
        """ONE pull for dispatched triangulations and fusions (and the
        keyframe's deferred descriptor block), then the merges in dispatch
        order under the map lock; `lap("pull")` and `lap("merge")` mark the
        two phases. The descriptor handle is read once, and the pulled block
        fills the keyframe only if no other thread filled it meanwhile."""
        with self.map_lock:
            kf = self.map.keyframes.get(kf_id)
            handle = None if kf is None else kf.desc01_dev
            deferred = kf is not None and kf.desc01 is None and handle is not None
        pulls = [x for _, out in tri_launches for x in out] + [pf for _, pf, _ in fuse_launches]
        if deferred:
            pulls.append(handle)
        pulled = self._pull(*pulls)
        lap("pull")
        with self.map_lock:
            if deferred:
                block = pulled.pop()
                if kf.desc01 is None:
                    kf.desc01 = block
                kf.desc01_dev = None
            dsc1 = None if kf is None else kf.desc01
            if dsc1 is not None:
                for n, (nb_id, _) in enumerate(tri_launches):
                    idx, X, good = pulled[3 * n : 3 * n + 3]
                    self._tri_merge_pair(kf_id, nb_id, idx, X, good, dsc1)
            for (ids, _, target), pf in zip(fuse_launches, pulled[3 * len(tri_launches):]):
                self._fuse_apply(ids, pf, target)
        lap("merge")

    def _triangulate_batch(self, kf_id: int, nb_ids: List[int]):
        """Triangulation alone: dispatch, one pull, merge (the mapping job
        shares its pull with fusion instead)."""
        self._pull_and_merge(kf_id, self._tri_dispatch(kf_id, nb_ids), [])

    def _search_in_neighbors(self, kf_id: int, neighbors: List[int]):
        """Fusion alone, both passes (reference SearchInNeighbors): dispatch,
        one pull, alive-gated merges, statistics refresh of the points it
        touched."""
        launches, own, nb_pts = self._fuse_batch_dispatch(kf_id, neighbors)
        self._pull_and_merge(kf_id, [], launches)
        with self.map_lock:
            touched = np.unique(np.concatenate([own, nb_pts]) if len(nb_pts) else own)
            self.map.update_point_stats(touched[self.map.pt_active[touched]])

    def _mapping_ba(self, kf_id: int, window: List[int]):
        """Windowed local BA over `window` (`kf_id`'s) with outside-window
        anchors fixed; async, its write-back deferred. Never skipped, where
        the reference skips it while a newer keyframe waits (module
        docstring). Subclasses switch the flavour (VI)."""
        with self.map_lock:
            # fixed anchors: KFs observing window points but outside the window
            anchor = set()
            for p in self.map.local_map_points(window):
                for k in self.map.obs_kf[p]:
                    if k >= 0 and int(k) not in window:
                        anchor.add(int(k))
        fixed = sorted(anchor)[:8]
        if not fixed:
            # no outside-window anchors (early map): pin the oldest window
            # keyframe or the solve is GAUGE-FREE and each run moves the
            # whole world a little
            fixed = [min(window)]
        self._local_ba(window, fixed, defer=self.async_mapping)

    def _tri_dispatch(self, kf_id: int, nb_ids: List[int]):
        """Dispatch triangulation for every worthwhile pair; the feature
        payloads come from the device cache, only poses and free masks are
        uploaded. Returns [(nb_id, (idx, X, good) on the device)]."""
        launches = []
        for nb_id in nb_ids:
            snap = self._triangulation_snapshot(kf_id, nb_id)
            if snap is None:
                continue
            r1, t1, free1, r2, t2, free2 = snap
            p1 = self._kf_payload(kf_id)
            p2 = self._kf_payload(nb_id)
            out = triangulate_between(
                self._up(r1), self._up(t1), p1["xy"], p1["level"], p1["desc01"], self._up(free1),
                self._up(r2), self._up(t2), p2["xy"], p2["level"], p2["desc01"], self._up(free2),
                self.cam, self._sigma2_dev,
            )
            launches.append((nb_id, out))
        return launches

    def _tri_merge_pair(self, kf_id, nb_id, idx, X, good, dsc1):
        """Merge one pulled triangulation result into the map (under the
        caller's map lock)."""
        if not good.any():
            return
        kf = self.map.keyframes.get(kf_id)
        nb = self.map.keyframes.get(nb_id)
        if kf is None or nb is None:
            return
        # features may have been bound meanwhile (an earlier neighbour's
        # triangulation); mutual matching keeps f1/f2 duplicate-free
        f1s = np.nonzero(good)[0]
        f2s = idx[f1s]
        free = (kf.point_idx[f1s] < 0) & (nb.point_idx[f2s] < 0)
        f1s, f2s = f1s[free], f2s[free]
        self.map.add_points_batch(
            X[f1s], dsc1[f1s], kf_id, f1s.astype(np.int32), nb_id, f2s.astype(np.int32),
        )

    def _triangulation_snapshot(self, kf_id: int, nb_id: int):
        """One keyframe pair's poses + free masks (baseline gate included),
        copied under the map lock; None when the pair is not worth
        triangulating."""
        with self.map_lock:
            kf = self.map.keyframes.get(kf_id)
            nb = self.map.keyframes.get(nb_id)
            if kf is None or nb is None:
                return None
            baseline = np.linalg.norm(kf.center() - nb.center())
            pts_nb = nb.point_idx[nb.point_idx >= 0]
            if len(pts_nb) > 0:
                depths = (self.map.pt_xyz[pts_nb] @ nb.r_cw.T + nb.t_cw)[:, 2]
                med = np.median(depths[depths > 0]) if (depths > 0).any() else 1.0
                if baseline / max(med, 1e-6) < 0.01:
                    return None
            free1 = kf.valid & (kf.point_idx < 0)
            free2 = nb.valid & (nb.point_idx < 0)
            if free1.sum() == 0 or free2.sum() == 0:
                return None
            return kf.r_cw.copy(), kf.t_cw.copy(), free1, nb.r_cw.copy(), nb.t_cw.copy(), free2

    def _fuse_apply(self, pt_ids: np.ndarray, pf: np.ndarray, target_id: int) -> int:
        """Merge phase of Fuse (under the caller's map lock): a match on a
        free feature becomes an observation; a match on a feature bound to a
        DIFFERENT point merges the two (the fewer-observed one dies).
        Alive-gated: points may have died in an earlier apply of the same
        batch."""
        kf = self.map.keyframes.get(target_id)
        if kf is None:
            return 0
        fused = 0
        for f in np.nonzero(pf >= 0)[0]:
            p = int(pt_ids[pf[f]])
            if not self.map.pt_active[p]:
                continue
            q = int(kf.point_idx[f])
            if q < 0:
                if self.map.add_observation(p, target_id, int(f)):
                    fused += 1
            elif q != p and self.map.pt_active[q]:
                # keep the better-observed point (reference Fuse->Replace)
                if self.map.n_obs(q) >= self.map.n_obs(p):
                    self.map.replace_point(p, q)
                else:
                    self.map.replace_point(q, p)
                fused += 1
        return fused

    def _fuse_points_into_kf(self, pt_ids: np.ndarray, target_id: int, radius: float = 3.0) -> int:
        """One-pair Fuse (the loop closer's seam fusion, reference
        SearchAndFuse): the first `max_local_points` of `pt_ids` projected
        into keyframe `target_id`, one dispatch and one pull, then the
        merges. The map lock is held for the snapshot and the merges, not
        across the dispatch or the pull."""
        pt_ids = pt_ids[: self.max_local_points]
        with self.map_lock:
            tkf = self.map.keyframes.get(target_id)
            if tkf is None or len(pt_ids) == 0:
                return 0
            packed, bits, valid = self._point_payload(pt_ids)
            valid[: len(pt_ids)] = self.map.pt_active[pt_ids]
            r_cw, t_cw = tkf.r_cw.copy(), tkf.t_cw.copy()
        sel = np.full(self.max_local_points, -1, np.int64)
        sel[: len(pt_ids)] = np.arange(len(pt_ids))
        pay = self._kf_payload(target_id)
        point_for_feat, _, _n, _ = fuse_match_gathered(
            self._up(packed), self._up(bits), self._up(valid), self._up(sel), self._up(r_cw),
            self._up(t_cw), pay["xy"], pay["desc_pm1"], pay["valid"], self.cam, radius,
        )
        (pf,) = self._pull(point_for_feat)
        with self.map_lock:
            return self._fuse_apply(pt_ids, pf, target_id)

    def _fuse_batch_dispatch(self, kf_id: int, neighbors: List[int]):
        """Dispatch phase of SearchInNeighbors: the new KF's points into each
        neighbor, all neighbor points into the new KF (reference
        src/LocalMapping.cc:1487), as one union payload upload and one
        gather-dispatch per pair. The map lock is held for the snapshot
        only, never across an upload or a dispatch. Returns ([(pt_ids,
        device pf, target)], the keyframe's own points, the neighbors'
        points)."""
        cap = self.max_local_points
        with self.map_lock:
            kf = self.map.keyframes.get(kf_id)
            if kf is None:
                empty = np.zeros(0, np.int64)
                return [], empty, empty
            own = kf.point_idx[kf.point_idx >= 0]
            nb_pts = self.map.local_map_points(neighbors)
            union = np.unique(np.concatenate([own, nb_pts])) if len(nb_pts) else own
            union = union[:cap]
            packed, bits, valid = self._point_payload(union)
            valid[: len(union)] = self.map.pt_active[union]
            row_of = np.full(self.map.max_points, -1, np.int32)
            row_of[union] = np.arange(len(union), dtype=np.int32)
            pairs = []
            for pt_ids, target in [(own, nb) for nb in neighbors] + [(nb_pts, kf_id)]:
                tkf = self.map.keyframes.get(target)
                if tkf is None or len(pt_ids) == 0:
                    continue
                pt_ids = pt_ids[:cap]
                sel = np.full(cap, -1, np.int32)
                sel[: len(pt_ids)] = row_of[pt_ids]
                pairs.append((pt_ids, sel, tkf.r_cw.copy(), tkf.t_cw.copy(), target))
        payload = (self._up(packed), self._up(bits), self._up(valid))
        launches = []
        for pt_ids, sel, r_cw, t_cw, target in pairs:
            pay = self._kf_payload(target)
            point_for_feat, _, _n, _ = fuse_match_gathered(
                *payload, self._up(sel, np.int64), self._up(r_cw), self._up(t_cw),
                pay["xy"], pay["desc_pm1"], pay["valid"], self.cam, 3.0,
            )
            launches.append((pt_ids, point_for_feat, target))
        return launches, own, nb_pts

    def _local_ba(self, window: List[int], fixed: List[int], max_landmarks: int = 0, defer: bool = False,
                  kind: str = "local"):
        """BA over `window` with `fixed` anchors and at most `max_landmarks`
        points (0: `max_ba_landmarks`). The problem is snapshotted under the
        map lock and solved outside it; the solve is written back now, or
        with `defer` by the next `_flush_pending_ba`; keyframes made after
        the snapshot ride the solve's correction through the newest solved
        keyframe. The pose block is
        padded to `pose_bucket` (fixed identity poses no observation names),
        as the reference pads it; a local BA (`kind` "local") of at most
        GRAPHED_MAX_POSES poses replays its bucket's graph on the card, any
        other solve (the post-loop GBA, `kind` "gba") runs eagerly. A stereo
        pipeline (`bf` set) adds each observation's right u from its
        keyframe's `ur` and solves with the 3-row residual, through graphs of
        its own, counted as "stereo_local" / "stereo_gba". Counted by kind in
        `ba_replays` / `ba_eager_calls`."""
        max_landmarks = max_landmarks or self.max_ba_landmarks
        with self.map_lock:
            window = [k for k in window if k in self.map.keyframes]
            fixed = [k for k in fixed if k in self.map.keyframes]
            if len(window) < 2:
                return
            kf_list, pt_ids, kf_idx, uv, inv_s2, valid = self.map.build_ba_problem(window, fixed, max_landmarks)
            if len(pt_ids) == 0:
                return
            k = pose_bucket(len(kf_list))
            r_cw = np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
            t_cw = np.zeros((k, 3), np.float32)
            r_cw[: len(kf_list)] = [self.map.keyframes[i].r_cw for i in kf_list]
            t_cw[: len(kf_list)] = [self.map.keyframes[i].t_cw for i in kf_list]
            points = np.zeros((max_landmarks, 3), np.float32)
            points[: len(pt_ids)] = self.map.pt_xyz[pt_ids]
            # the points' slot generations: a slot culled and reused before a
            # deferred write-back holds another point by then
            gen = self.map.pt_gen[pt_ids].copy()
            fixed_mask = np.ones(k, bool)
            fixed_mask[: len(kf_list)] = [i in fixed for i in kf_list]
            stereo = None if self.bf is None else self.map.build_stereo_ur_grid(pt_ids, kf_list, max_landmarks)
            # keyframes made after this snapshot ride the solve's correction
            # through the newest solved keyframe (_apply_ba_result)
            next_kf = self.map._next_kf
            solved = [i for s, i in enumerate(kf_list) if not fixed_mask[s]]
            ref_id = max(solved, default=-1)
            ref_pre = None if ref_id < 0 else (r_cw[kf_list.index(ref_id)].copy(), t_cw[kf_list.index(ref_id)].copy())
        args = self._ba_args(VisionBAState(self._up(r_cw), self._up(t_cw), self._up(points)), kf_idx, uv, inv_s2,
                             valid, fixed_mask, stereo)
        graphed = self._on_card and kind == "local" and k <= GRAPHED_MAX_POSES
        out, valid_out = self._ba_graph(*args) if graphed else self._ba_graph.eager(*args)
        self._count_ba(kind if self.bf is None else "stereo_" + kind, graphed)
        job = (kf_list, pt_ids, gen, kf_idx, valid, fixed_mask, (out.r_cw, out.t_cw, out.points, valid_out),
               self._record_ready(), next_kf, ref_id, ref_pre)
        if not defer:
            return self._apply_ba_result(*job)
        with self._ba_lock:
            if self._pending_ba is not None:  # each job flushes before it solves
                raise RuntimeError("a deferred BA is already pending")
            self._pending_ba = job

    def _flush_pending_ba(self):
        """Write the deferred BA back, if one is pending. The swap and the
        write-back hold `_ba_lock`: a solve is applied exactly once, and a
        second caller returns after the first's write-back."""
        with self._ba_lock:
            job, self._pending_ba = self._pending_ba, None
            if job is not None:
                self._apply_ba_result(*job)

    def _apply_ba_result(self, kf_list, pt_ids, gen, kf_idx, valid, fixed_mask, solution, ready, next_kf, ref_id,
                         ref_pre):
        """One pull of the solve (after its event, from any thread), then the
        write-back under the map lock: poses of the solved keyframes; the
        keyframes made after the snapshot carried along through the newest
        solved keyframe (the reference's post-GBA spanning-tree pass); the
        points still in their slots; the observations BA marked as
        outliers removed. Publishes with `map.version`. (A deferred solve
        never meets a loop correction: a job with a loop closer writes its
        own BA back before the closure, under the lock the closure holds.)"""
        r_new, t_new, p_new, valid_new = self._pull(*solution, after=ready)
        with self.map_lock:
            for s, i in enumerate(kf_list):
                if not fixed_mask[s] and i in self.map.keyframes:
                    self.map.keyframes[i].r_cw = r_new[s]
                    self.map.keyframes[i].t_cw = t_new[s]
            if ref_pre is not None and ref_id in self.map.keyframes:
                rk = self.map.keyframes[ref_id]
                self._carry_keyframes(next_kf, kf_list, ref_pre, (rk.r_cw, rk.t_cw))
            alive = self.map.pt_active[pt_ids] & (self.map.pt_gen[pt_ids] == gen)
            self.map.pt_xyz[pt_ids[alive]] = p_new[: len(pt_ids)][alive]
            # remove observations BA marked as outliers
            dropped = valid & ~valid_new
            for row in np.nonzero(dropped[: len(pt_ids)].any(axis=1) & alive)[0]:
                p = int(pt_ids[row])
                if not self.map.pt_active[p]:
                    continue
                for s in np.nonzero(dropped[row])[0]:
                    self.map.remove_observation(p, int(kf_list[kf_idx[row, s]]))
            self.map.version += 1

    def _carry_keyframes(self, next_kf: int, kf_list, ref_pre, ref_new) -> list:
        """Move the keyframes made since a BA's snapshot (ids >= next_kf, none
        of them solved) with the world motion that took the newest solved
        keyframe from pose `ref_pre` to `ref_new`, each (r_cw, t_cw) (the
        reference's post-GBA spanning-tree pass; the caller holds the map
        lock). A threaded tracker keeps making keyframes while the worker
        solves: left behind, they and the tracker's re-base on the newest of
        them stay in the unsolved map. Returns the moved keyframes."""
        (r_old, t_old), (r_ref, t_ref) = ref_pre, ref_new
        moved = [self.map.keyframes[i] for i in sorted(self.map.keyframes) if i >= next_kf and i not in kf_list]
        for kf in moved:
            r_rel = kf.r_cw @ r_old.T
            t_rel = kf.t_cw - r_rel @ t_old
            kf.r_cw = normalize_np(r_rel @ r_ref)
            kf.t_cw = (r_rel @ t_ref + t_rel).astype(np.float32)
        self.kfs_carried += len(moved)
        return moved

    def _post_loop_gba(self, anchor_kf: int, scale_by_kf=None):
        """Full-map BA after a loop correction, anchored at the loop (old
        side) keyframe (reference RunGlobalBundleAdjustment, vision flavour;
        `scale_by_kf`, each keyframe's local world-scale change, is for the
        VI override): every keyframe, every active point (the landmark block
        the next power of two >= their count: a truncated point set leaves
        the rest of the map inconsistent with the new poses, and later local
        BAs drag the trajectory back toward it), eager. It runs in the loop
        job in every mode, inside the job's hold of the map lock (module
        docstring)."""
        with self.map_lock:
            ids = sorted(self.map.keyframes.keys())
            n_pts = int(self.map.pt_active.sum())
        if len(ids) < 3:
            return
        cap = max(self.max_ba_landmarks, 1 << int(np.ceil(np.log2(max(n_pts, 1)))))
        self._local_ba(ids, fixed=[anchor_kf], max_landmarks=cap, kind="gba")

    def _can_cull(self, k: int) -> bool:
        """Subclass veto hook (VI: the preintegration time-gap guard)."""
        return True

    def _on_cull(self, k: int):
        """Subclass hook run just before keyframe `k` is removed."""

    def _cull_keyframes(self, window: List[int]):
        """Redundant-keyframe culling (reference LocalMapping::
        KeyFrameCulling, src/LocalMapping.cc:1665-1824): a window KF is
        dropped when > 90 % of its tracked points are observed by at least
        3 other keyframes. The first two keyframes and the newest are never
        culled; at most one KF is culled per call."""
        protected = set(sorted(self.map.keyframes.keys())[:2])
        protected.add(self.last_kf_id)
        for k in window:
            if k in protected or k not in self.map.keyframes or not self._can_cull(k):
                continue
            kf = self.map.keyframes[k]
            pts = kf.point_idx[kf.point_idx >= 0]
            if len(pts) < 20:
                continue
            n_obs = (self.map.obs_kf[pts] >= 0).sum(axis=1)
            if (n_obs >= 4).mean() > 0.9:  # self + 3 others
                self._on_cull(k)
                # spanning tree: adopt the culled KF's children to its
                # parent (reference KeyFrame::SetBadFlag re-parenting)
                new_parent = kf.parent_kf
                if new_parent not in self.map.keyframes:
                    new_parent = self.last_kf_id
                for other in self.map.keyframes.values():
                    if other.parent_kf == k:
                        other.parent_kf = new_parent
                # re-anchor trajectory entries onto the spanning parent:
                # T_rel' = T_rel * T_k * T_anchor^{-1}
                anchor = new_parent if new_parent >= 0 else self.last_kf_id
                akf = self.map.keyframes[anchor]
                r_ak = kf.r_cw @ akf.r_cw.T
                t_ak = kf.t_cw - r_ak @ akf.t_cw
                self.traj_entries = [
                    (ts, kf_id, r_rel, t_rel)
                    if kf_id != k
                    else (ts, anchor, r_rel @ r_ak, r_rel @ t_ak + t_rel)
                    for ts, kf_id, r_rel, t_rel in self.traj_entries
                ]
                for p in pts:
                    self.map.remove_observation(int(p), k)
                kf.active = False
                if self.loop_closer is not None:
                    self.loop_closer.db.remove(k)
                del self.map.keyframes[k]
                self._kf_dev.pop(k, None)
                return

    def _cull_points(self):
        """Light MapPointCulling (reference src/LocalMapping.cc:1198): drop
        points whose found/visible ratio is low."""
        pts = self.map.active_point_ids()
        if len(pts) == 0:
            return
        vis = self.map.pt_visible[pts]
        fnd = self.map.pt_found[pts]
        bad = (vis > 4) & (fnd / np.maximum(vis, 1) < 0.25)
        for p in pts[bad]:
            self.map.remove_point(int(p))

    # -- state ---------------------------------------------------------------

    def _clear_tracking(self):
        """Forget the frames and device caches that belong to the map being
        replaced."""
        self.ref_frame = None
        self.last_frame = None
        self.frames_since_kf = 0
        self.velocity = None
        self._dev_carry = None
        self._carry_anchor = None
        self._stream_failed = False
        self._stream_fail_count = 0
        self._stream_weak_count = 0
        self._sync_frame = None
        self._lm_cache = None
        self._kf_dev = {}

    def reset(self):
        """Full system reset (reference Tracking/System::Reset): clear the
        map and initialize anew, once mapping is idle. Past trajectory
        entries are dropped with their keyframes."""
        self.wait_mapping_idle()
        with self.map_lock:
            self.map = MapStore()
            self.state = "NOT_INITIALIZED"
            self.last_kf_id = -1
            self._clear_tracking()
            self.traj_entries = []
            self.n_tracked = 0
            self._new_loop_closer()

    def set_localization_mode(self, enabled: bool):
        """Track against the frozen map without inserting keyframes
        (reference System::ActivateLocalizationMode), once mapping is idle."""
        self.wait_mapping_idle()
        self.localization_only = enabled

    def save_map(self, path: str):
        """Checkpoint the full map to one .npz (the JAX package's layout),
        once mapping is idle."""
        from viorb_tpu_torch.mapping.serialize import save_map

        self.wait_mapping_idle()
        with self.map_lock:
            save_map(self.map, path)

    def load_map(self, path: str, localization_only: bool = True):
        """Load a checkpointed map and resume from it. The next frame
        relocalizes into the loaded map (descriptor matching + PnP); with
        localization_only the map stays frozen, otherwise mapping continues
        from the loaded keyframes. With a vocabulary every loaded keyframe's
        BoW goes into a fresh keyframe database."""
        from viorb_tpu_torch.mapping.serialize import load_map

        self.wait_mapping_idle()
        with self.map_lock:
            self.map = load_map(path)
            active = self.map.kf_ids()
            self.last_kf_id = max(active) if active else -1
            self.state = "LOST" if active else "NOT_INITIALIZED"
            self.localization_only = localization_only
            self._clear_tracking()
            self._new_loop_closer()
            if self.loop_closer is not None:
                for k in active:
                    self.loop_closer.add_keyframe(k)

    # -- output --------------------------------------------------------------

    def _record_trajectory(self, fr: FrameRecord, ts: float):
        if fr.r_cw is None or self.last_kf_id < 0:
            return
        with self.map_lock:  # keyframe culling rewrites traj_entries under it
            kf = self.map.keyframes.get(self.last_kf_id)
            if kf is None:
                return
            # T_rel = T_frame_cw * T_kf_cw^{-1}
            r_rel = fr.r_cw @ kf.r_cw.T
            t_rel = fr.t_cw - r_rel @ kf.t_cw
            self.traj_entries.append((ts, self.last_kf_id, r_rel, t_rel))
            fr.ref = (self.last_kf_id, r_rel, t_rel, self.map.version)

    def _rescale_trajectory(self, s: float):
        """Scale the recorded frame poses with the map (VI init's rescale;
        the caller holds the map lock)."""
        self.traj_entries = [(ts, k, r, t * s) for ts, k, r, t in self.traj_entries]

    def trajectory_tum(self) -> np.ndarray:
        """(T,8): t, tx ty tz, qx qy qz qw (camera-to-world), composing the
        stored relative poses with the keyframes' CURRENT poses (reference
        SaveTrajectoryTUM), after the in-flight frames are collected and the
        pending BA is written back."""
        self.flush_stream()
        self._flush_pending_ba()
        ts, centers, r_wcs = [], [], []
        with self.map_lock:
            for t, kf_id, r_rel, t_rel in self.traj_entries:
                kf = self.map.keyframes.get(kf_id)
                if kf is None:
                    continue
                r_cw = r_rel @ kf.r_cw
                t_cw = r_rel @ kf.t_cw + t_rel
                ts.append(t)
                r_wcs.append(r_cw.T)
                centers.append(-r_cw.T @ t_cw)
        if not ts:
            return np.zeros((0, 8), np.float64)
        q = matrix_to_quat(torch.from_numpy(np.stack(r_wcs).astype(np.float32))).numpy()  # (w,x,y,z)
        c = np.stack(centers)
        return np.concatenate([np.asarray(ts)[:, None], c, q[:, 1:4], q[:, :1]], axis=1).astype(np.float64)


def _moved(kf, anchor) -> bool:
    """Whether keyframe `kf` left the pose `anchor` (id, r_cw, t_cw,
    version) recorded."""
    return not (np.array_equal(kf.r_cw, anchor[1]) and np.array_equal(kf.t_cw, anchor[2]))


def _moved_with(r, t, r_from, t_from, r_to, t_to):
    """T o (T_from^-1 o T_to): the pose (r, t), held relative to a keyframe
    that moved from T_from to T_to, moved along with it."""
    rd = r @ r_from.T
    return normalize_np(rd @ r_to), (rd @ (t_to - t_from) + t).astype(np.float32)


def normalize_np(R: np.ndarray) -> np.ndarray:
    """Re-orthonormalize a 3x3 rotation on the host (SVD projection), f32."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    d = np.sign(np.linalg.det(u @ vt))
    return (u @ np.diag([1.0, 1.0, d]) @ vt).astype(np.float32)
