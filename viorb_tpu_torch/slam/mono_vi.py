"""Monocular visual-inertial SLAM, lock-step or with async mapping (port of
viorb_tpu/slam/mono_vi.py: `MonoViSlam`).

The vision pipeline (slam/mono.py) with:
  * per-frame IMU buffering; each keyframe carries the IMU segment since the
    previous chain keyframe;
  * VI initialization once the keyframe chain spans enough time
    (slam/vi_init.py); on success the map and the poses are rescaled, the
    chain keyframes get NavStates, and tracking switches to IMU prediction
    + the 15-DoF VI pose LM;
  * the VI local BA over the keyframe window with the preintegration chain
    (optim/ba.py::vi_ba), the full-chain gravity-vertex BA at the refine
    marks, the closed-form init refined below the first mark;
  * IMU-only dead reckoning for at most IMU_SAFE_WINDOW seconds of lost
    vision, then relocalization and a 20-frame bias re-solve.

A steady VI frame is ONE replay of the graphed VI core
(`tracking_loop.make_vi_pipeline_core`: both preintegrations, propagation,
extraction, matching with the wide-radius retry, the VI LM and the frame's
marginal) and ONE pull of its bookkeeping fields; the since-frame and
since-keyframe IMU batches are padded to `imu_capacity` and uploaded through
pinned memory outside the graph. The tracker's NavState, the marginal prior
and the anchor stay on the device between frames. The padded local map is
MonoSlam's `_device_local_map` (the reference's `_device_local_map_vi` has
its key and layout).

Keyframe NavStates in the map are host NamedTuples of numpy arrays, laid
out in checkpoints as the reference's.

The VI BAs pad the pose block to the reference's buckets
(`optim/ba.py::pose_bucket`: padded NavStates are fixed identities with no
observation and no valid edge), and the local one (the window's
consecutive edges, at most GRAPHED_MAX_POSES poses) replays one CUDA graph
a bucket on the card, captured at first use; the VI global BAs
(post-init, post-loop) and the gravity-vertex BA run eagerly. Deliberate
difference from the reference: the global BA's multi-stride edge list is
not padded (the reference pads it to multiples of 16, one XLA compile per
shape; the eager solve compiles nothing, and padded edges are invalid, so
they never change a result).

With a vocabulary and `enable_loop_closing`, a loop correction ends in the
VI flavour of the post-loop global BA (`_post_loop_gba`): NavStates
re-derived from the corrected poses, then the full-chain VI BA.

Async mapping (`async_mapping=True`) runs the mapping job on MonoSlam's
worker thread, and the worker never touches the state the tracker owns
(`nav_cur`, the frame prior, the velocity, the last frame's pose, the
biases, gravity): an event that invalidates it (the VI init's rescale and
its refinements, a VI BA that moved the job's keyframe, a loop correction's
VI post-loop GBA, which runs on the worker inside the loop job) leaves new
biases and gravity in `_pending_imu_params` and bumps `_rebase_epoch` under
the map lock, and the tracker re-bases once, at its next frame entry
(`_drain_tracker_rebase`): `nav_cur` re-derived from the newest chain
keyframe's NavState propagated through the since-keyframe IMU samples (one
graph replay on the card), the last frame re-posed on it. Before VI init a
frame is a vision frame and MonoSlam's `_rebase_last_frame` re-bases it;
after VI init only the drain re-poses the last frame.

The tracker is kept in the worker's map where the reference lets it run
ahead (on the card, the arc un-paced and the circuit at 10 fps):
  * until VI init and through its refinement window (`init_refine_window`
    after it) a frame waits for an idle worker, as lock-step tracks: the
    closed-form init solves on the chain's camera centres, and keyframes
    made from frames tracked ahead of their predecessors' jobs gave it as
    little as half the true scale (un-paced runs ended 12-35 % short of the
    true size); in the window the closed-form refinements (1-2 s) and the
    gravity-vertex GBAs (2.5-3.1 s, eager) rescale and re-orient the map,
    and a tracker ahead of them left it (IMU-only from frame 37 on at 10
    fps; a backlog gate, the GBAs under the map lock and an idle-gated
    ratio trigger each still lost it); after the window it runs ahead as
    the reference's does (on the card, over the 30 s laps at 10 fps, it
    loses the map within a few seconds of the window's end where
    lock-step tracks every frame: an open fault, ROADMAP queue 3);
  * a VI frame tracked while a write-back moved the map makes no keyframe:
    left in the map before it, that keyframe became the newest and the
    next re-base moved the tracker back into the old map;
  * keyframes made during a VI BA's solve follow the newest solved
    keyframe's motion, and those made during a VI init's get NavStates.
A threaded run
captures the VI core's two graphs, the drain's graph and the local VI BA
at both pose buckets before its threads start; a worker never captures,
and a missing capture raises. Deliberate difference from the reference:
VI init sets `vi_ready` in the same hold of the map lock as its rescale and
epoch bump (the reference sets it after the lock, so a drain in between
drops the epoch without re-deriving `nav_cur`).

Not ported here: streaming VI (ROADMAP queue 1, D6); it raises
NotImplementedError.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from viorb_tpu_torch.cuda_graph import GraphedFunction
from viorb_tpu_torch.imu.navstate import GRAVITY_W, NavState, propagate_navstate
from viorb_tpu_torch.imu.preintegration import PreintegratedImu, compose_preint, preintegrate, preintegrate_batch
from viorb_tpu_torch.imu.types import ImuBatch, ImuNoise, padded_arrays
from viorb_tpu_torch.optim.ba import (
    GRAPHED_MAX_POSES,
    BAObservations,
    ImuChain,
    ViBAState,
    make_local_vi_ba,
    pose_bucket,
    vi_ba_gw_two_phase,
    vi_ba_two_phase,
)
from viorb_tpu_torch.optim.pose_only import ViPosePrior
from viorb_tpu_torch.optim.reprojection import Extrinsics
from viorb_tpu_torch.slam.mono import FrameRecord, MonoSlam
from viorb_tpu_torch.slam.tracking_loop import make_vi_pipeline_core
from viorb_tpu_torch.slam.vi_init import estimate_gyro_bias, try_vi_init

IMU_SAFE_WINDOW = 3.0  # seconds of IMU-only tracking allowed
_NOT_PORTED_D6 = ("MonoViSlam runs lock-step or with async mapping: streaming VI is not ported yet "
                  "(ROADMAP queue 1, D6: streaming MonoViSlam)")
_REBASE_GRAPHS: dict = {}  # ImuNoise -> the drain's GraphedFunction, process-wide


def _rebase_graph(noise: ImuNoise) -> GraphedFunction:
    """The drain's device step, (batch, bias_g, bias_a, t0, t1, nav, gravity)
    -> the NavState `nav` propagated through the samples of `batch` over
    [t0, t1]: one graph on the card, eager on the CPU."""
    return _REBASE_GRAPHS.setdefault(tuple(noise), GraphedFunction(
        lambda batch, bg, ba, t0, t1, nav, g: propagate_navstate(nav, preintegrate(batch, bg, ba, t0, t1, noise), g)))


class MonoViSlam(MonoSlam):
    """Monocular-inertial SLAM (the reference's TrackMonoVI facade),
    lock-step or with `async_mapping=True`. `process_frame_vi(image, ts,
    imu_samples)` is the entry point; `device=None` is the card,
    `device="cpu"` runs the eager versions. Call `shutdown()` after an
    async run."""

    def __init__(
        self,
        cam,
        r_bc: Optional[np.ndarray] = None,
        p_bc: Optional[np.ndarray] = None,
        imu_noise: ImuNoise = ImuNoise(),
        vi_init_min_time: float = 3.0,
        vi_init_min_kfs: int = 8,
        imu_capacity: int = 256,
        **kwargs,
    ):
        if kwargs.get("streaming"):
            raise NotImplementedError(_NOT_PORTED_D6)
        super().__init__(cam, **kwargs)
        self.r_bc = np.eye(3, dtype=np.float32) if r_bc is None else np.asarray(r_bc, np.float32)
        self.p_bc = np.zeros(3, np.float32) if p_bc is None else np.asarray(p_bc, np.float32)
        self.ext = Extrinsics(self._up(self.r_bc), self._up(self.p_bc))
        self.imu_noise = imu_noise
        self.vi_init_min_time = vi_init_min_time
        self.vi_init_min_kfs = vi_init_min_kfs
        self.imu_capacity = imu_capacity
        self.vi_ready = False
        self.gravity: Optional[np.ndarray] = None
        self.imu_since_kf: list = []  # [(t, gyro, acc)]
        self.imu_since_frame: list = []
        # the tracker's NavState on the device, and its host copy when known
        self.nav_cur: Optional[NavState] = None
        self._nav_cur_host: Optional[NavState] = None
        self.last_vision_time = 0.0
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        self.kf_chain: List[int] = []  # keyframe ids linked by IMU segments, in order
        self._ba_skips = 0  # local BAs skipped in a row (async: while a newer keyframe waits)
        self.init_time = 0.0
        # keep refining the init estimates until this much data exists
        self.init_refine_window = 12.0
        # chain spans (s) at which the full-chain gravity-vertex GBA fires
        # (each mark once); below the first mark the closed-form triplet
        # refine runs instead
        self.gw_refine_marks = [3.5, 5.0, 7.0, 9.0, 11.0]
        self._gw_mark_done = 0
        self._last_refine_len = 0
        # post-relocalization bias re-estimation
        self.reloc_bias_prepare = False
        self.reloc_buffer: List[tuple] = []  # (ts, r_cw, t_cw, imu samples)
        self.reloc_frames_needed = 20
        self.pre_init_lost = 0
        # optional VI-init convergence dump directory (scale.txt, gw.txt, ...)
        self.init_log_dir: Optional[str] = None
        # marginalized frame prior chain: frame-to-frame tracking carries the
        # previous frame's marginal; the chain re-anchors to the keyframe
        # whenever the map changes (map.version)
        self.frame_prior: Optional[ViPosePrior] = None
        self._prior_map_version = -1
        self._nav_last_frame: Optional[NavState] = None
        # mapping-side bias and gravity (what the BAs and checkpoints use)
        self._map_bias_g = np.zeros(3, np.float32)
        self._map_bias_a = np.zeros(3, np.float32)
        self._map_gravity: Optional[np.ndarray] = None
        # async: mapping-side events bump the epoch; the tracker re-bases
        # once at its next frame entry and takes the pending biases and
        # gravity (bias_g, bias_a, gravity) then (module docstring)
        self._rebase_epoch = 0
        self._rebase_seen = 0
        self._pending_imu_params: Optional[tuple] = None
        self.rebases = 0  # re-bases the tracker applied
        self.saturated_kf_decisions = 0  # keyframe decisions under the 1.5 s gap (two jobs waiting)
        self.frames_across_writeback = 0  # VI frames tracked while a write-back moved the map
        self._rebase = _rebase_graph(imu_noise)
        # the graphed VI core, process-wide (its cache key reads the
        # extrinsics back from the device: once here, never inside a frame)
        self._vi_core = make_vi_pipeline_core(self.cam, self.extractor, self.ext, self.imu_noise)
        self._true = self._up(np.ones((), bool)).reshape(())
        # the local VI BA, one CUDA graph a pose bucket on the card
        # (captured at first use in lock-step, before the threads start
        # when async)
        self._vi_ba_graph = make_local_vi_ba(self.cam)
        # host-clock ms of each VI mapping BA: (kind, ms), in order
        self.vi_ba_times: List[tuple] = []

    # -- NavStates -----------------------------------------------------------

    def _nav_host(self, r_cw, t_cw, v=None, bias_g=None, bias_a=None) -> NavState:
        """The body NavState (numpy fields) of a camera pose."""
        r_wc = r_cw.T
        c_w = -r_wc @ t_cw
        r_wb = r_wc @ self.r_bc.T
        p_wb = c_w + r_wc @ -(self.r_bc.T @ self.p_bc)
        z = np.zeros(3, np.float32)
        return NavState(
            p_wb.astype(np.float32),
            (np.zeros(3) if v is None else np.asarray(v)).astype(np.float32),
            r_wb.astype(np.float32),
            np.asarray(self.bias_g if bias_g is None else bias_g, np.float32),
            np.asarray(self.bias_a if bias_a is None else bias_a, np.float32),
            z, z.copy(),
        )

    def _tcw_from_nav(self, nav: NavState):
        """Camera pose (r_cw, t_cw) of a host NavState."""
        r_wc = np.asarray(nav.r) @ self.r_bc
        c_w = np.asarray(nav.p) - r_wc @ -(self.r_bc.T @ self.p_bc)
        r_cw = r_wc.T
        return r_cw.astype(np.float32), (-r_cw @ c_w).astype(np.float32)

    def _nav_up(self, ns: NavState) -> NavState:
        return NavState(*(self._up(np.asarray(x, np.float32)) for x in ns))

    def _set_nav_cur(self, host: NavState, dev: Optional[NavState] = None):
        self._nav_cur_host = host
        self.nav_cur = self._nav_up(host) if dev is None else dev

    def _upload_batch(self, gyro, acc, t) -> ImuBatch:
        """Samples as a padded ImuBatch on the device (pinned, no wait)."""
        return ImuBatch(*(self._up(x) for x in padded_arrays(gyro, acc, t, self.imu_capacity)))

    def _imu_batch(self, samples) -> ImuBatch:
        """The samples (t, gyro, acc), the last `imu_capacity` of them, as a
        padded ImuBatch on the device."""
        samples = samples[len(samples) - min(len(samples), self.imu_capacity):]
        return self._upload_batch(np.array([s[1] for s in samples], np.float32).reshape(-1, 3),
                                  np.array([s[2] for s in samples], np.float32).reshape(-1, 3),
                                  np.array([s[0] for s in samples], np.float32))

    def _kf_imu_batch(self, kf_id: int) -> ImuBatch:
        nav = self.map.keyframes[kf_id].nav
        return self._upload_batch(nav["imu_g"], nav["imu_a"], nav["imu_t"])

    @staticmethod
    def _stack_batches(batches: List[ImuBatch]) -> ImuBatch:
        return ImuBatch(*(torch.stack(x) for x in zip(*batches)))

    def _f32(self, x) -> torch.Tensor:
        """A number or array as an f32 tensor of its own shape on the device."""
        a = np.asarray(x, np.float32)
        return self._up(a).reshape(a.shape)

    # -- threads ---------------------------------------------------------------

    def _capture_before_threads(self, img: torch.Tensor, dmap):
        """MonoSlam's graphs, then the VI core's two graphs at the frame's,
        the padded local map's and `imu_capacity`'s shapes, the drain's
        graph, and the local VI BA at both pose buckets on placeholder
        problems (a capture records shapes; the values are any)."""
        super()._capture_before_threads(img, dmap)
        z3 = np.zeros(3, np.float32)
        nav = self._nav_up(NavState(z3, z3, np.eye(3, dtype=np.float32), z3, z3, z3, z3))
        zero, t, g = self._f32(z3), self._f32(0.0), self._f32(GRAVITY_W)
        batch = self._imu_batch([])
        for graph in self._vi_core.graphs.values():
            graph.prepare(img, nav, nav, batch, batch, t, t, t, zero, zero, g, nav, self._f32(np.zeros((15, 15))),
                          *dmap)
        self._rebase.prepare(batch, zero, zero, t, t, nav, g)
        for k in sorted({pose_bucket(4), GRAPHED_MAX_POSES}):
            self._vi_ba_graph.prepare(*self._placeholder_vi_ba(k))

    def _placeholder_vi_ba(self, k: int):
        """The local VI BA's arguments at pose bucket k: MonoSlam's vision
        placeholder (no valid observation, every pose fixed) with identity
        NavStates and k - 1 empty, invalid IMU edges."""
        vstate, kf_idx, uv, inv_s2, valid, fixed = self._placeholder_ba(k)
        z3 = np.zeros((k, 3), np.float32)
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3))
        nav = self._nav_up(NavState(z3, z3, eye, z3, z3, z3, z3))
        zero = self._f32(np.zeros(3))
        pre = preintegrate_batch(self._stack_batches([self._imu_batch([])] * (k - 1)), zero, zero,
                                 self._f32(np.zeros(k - 1)), self._f32(np.full(k - 1, 0.01)), self.imu_noise)
        return (ViBAState(nav, vstate.points), kf_idx, uv, inv_s2, valid, self.ext, pre,
                self._up(np.zeros(k - 1, bool)), self._f32(np.ones(6)), self._f32(GRAVITY_W), fixed)

    # -- frame entry ---------------------------------------------------------

    def _drain_tracker_rebase(self):
        """Async: apply the mapping-side events since the last frame to the
        tracker, once, at frame entry (lock-step applies them inline): take
        the pending biases and gravity, drop the frame prior, the last
        frame's NavState and the velocity, and after VI init re-derive
        `nav_cur` from the newest chain keyframe's NavState, propagated
        through the since-keyframe IMU samples up to the last frame's time,
        and re-pose the last frame on it."""
        with self.map_lock:
            if self._rebase_seen == self._rebase_epoch:
                return
            self._rebase_seen = self._rebase_epoch
            self.rebases += 1
            if self._pending_imu_params is not None:
                self.bias_g, self.bias_a, self.gravity = self._pending_imu_params
                self._pending_imu_params = None
            self.frame_prior = None
            self._nav_last_frame = None
            self.velocity = None
            if not self.vi_ready:
                return
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
            if not chain:
                return
            last_kf = self.map.keyframes[chain[-1]]
            if not (last_kf.nav and "state" in last_kf.nav):
                return
            ns, kf_ts = last_kf.nav["state"], last_kf.timestamp
            imu_buf = list(self.imu_since_kf)
        last = self.last_frame
        if last is not None and last.timestamp > kf_ts:
            # the samples up to the last frame only: the current frame's,
            # appended at its entry, are the VI core's since-frame batch (the
            # reference integrates them here too, and the core again)
            imu_buf = [x for x in imu_buf if x[0] <= last.timestamp]
            ns_d = self._rebase(self._imu_batch(imu_buf), self._f32(self.bias_g), self._f32(self.bias_a),
                                self._f32(kf_ts), self._f32(last.timestamp), self._nav_up(ns), self._f32(self.gravity))
            ns = NavState(*self._pull(*ns_d))
            last.r_cw, last.t_cw = self._tcw_from_nav(ns)
            self._set_nav_cur(ns, ns_d)
        else:
            self._set_nav_cur(ns)
        self.last_vision_time = max(self.last_vision_time, last.timestamp if last is not None else kf_ts)

    def _wait_for_worker(self):
        """Async: until VI init and its refinement window
        (`init_refine_window` after it) have passed, hold the frame until the
        mapping worker is idle (module docstring)."""
        last = self.last_frame
        if self.vi_ready and last is not None and last.timestamp - self.init_time >= self.init_refine_window:
            return
        self._mapping_queue.join()
        if self._worker_error is not None:
            raise RuntimeError("mapping worker died") from self._worker_error

    def _rebase_last_frame(self):
        """MonoSlam's re-base of the last frame on its keyframe's new pose,
        for vision frames (before VI init) only: after VI init the drain
        re-poses the last frame, and a rescale is no rigid move."""
        if not self.vi_ready:
            super()._rebase_last_frame()

    def process_frame_vi(self, image, ts: float, imu_samples) -> dict:
        """Track one frame. imu_samples: iterable of (t, gyro (3,), acc (3,))
        since the last call. Async, until VI init and its refinement window
        have passed, a frame waits for an idle mapping worker
        (`_wait_for_worker`)."""
        for s in imu_samples:
            self.imu_since_kf.append(s)
            self.imu_since_frame.append(s)
        if self.async_mapping:
            self._ensure_threads(image)
            self._wait_for_worker()
            self._drain_tracker_rebase()
        if not self.vi_ready:
            out = self.process_frame(image, ts)
            # pre-init loss with a tiny map is unrecoverable: full reset
            if out["state"] == "LOST" and len(self.map.kf_ids()) <= 5:
                self.pre_init_lost += 1
                if self.pre_init_lost >= 3:
                    self.reset_vi()
                    out = {"state": "NOT_INITIALIZED", "n_tracked": 0, "n_kfs": 0, "n_points": 0}
            else:
                self.pre_init_lost = 0
            self.imu_since_frame = []
            return out
        # the steady VI frame is one graph replay; the guard branches
        # (relocalization bias prepare, no inertial anchor) extract first
        if self.reloc_bias_prepare or self.nav_cur is None:
            fr = self._make_frame(image, ts)
            self._track_vi(fr, ts)
        else:
            fr = self._track_vi_fused(image, ts)
        self._record_trajectory(fr, ts)
        self.last_frame = fr
        self.imu_since_frame = []
        return {
            "state": self.state,
            "n_tracked": self.n_tracked,
            "n_kfs": len(self.map.kf_ids()),
            "n_points": len(self.map.active_point_ids()),
            "vi": True,
        }

    # -- keyframe hooks ------------------------------------------------------

    def _can_cull(self, k: int) -> bool:
        """A chain keyframe may be culled only when merging its IMU segment
        into the next one keeps the span short (<= 0.5 s), and never the
        chain's ends."""
        if k not in self.kf_chain:
            return True
        i = self.kf_chain.index(k)
        if i == 0 or i == len(self.kf_chain) - 1:
            return False
        prev_id, next_id = self.kf_chain[i - 1], self.kf_chain[i + 1]
        if prev_id not in self.map.keyframes or next_id not in self.map.keyframes:
            return False
        return self.map.keyframes[next_id].timestamp - self.map.keyframes[prev_id].timestamp <= 0.5

    def _on_cull(self, k: int):
        """Merge the culled keyframe's IMU samples into its next chain
        neighbour's and re-link prev <-> next."""
        if k not in self.kf_chain:
            return
        i = self.kf_chain.index(k)
        prev_id, next_id = self.kf_chain[i - 1], self.kf_chain[i + 1]
        nav_k = self.map.keyframes[k].nav or {}
        nxt = self.map.keyframes[next_id]
        nav_n = nxt.nav or {}
        t = np.concatenate([nav_k.get("imu_t", np.zeros(0, np.float32)), nav_n.get("imu_t", np.zeros(0, np.float32))])
        g = np.concatenate([nav_k.get("imu_g", np.zeros((0, 3), np.float32)),
                            nav_n.get("imu_g", np.zeros((0, 3), np.float32))])
        a = np.concatenate([nav_k.get("imu_a", np.zeros((0, 3), np.float32)),
                            nav_n.get("imu_a", np.zeros((0, 3), np.float32))])
        n_keep = min(len(t), self.imu_capacity)
        nxt.nav = nav_n
        nxt.nav["imu_t"] = t[len(t) - n_keep:]
        nxt.nav["imu_g"] = g[len(g) - n_keep:].astype(np.float32)
        nxt.nav["imu_a"] = a[len(a) - n_keep:].astype(np.float32)
        nxt.prev_kf = prev_id
        self.map.keyframes[prev_id].next_kf = next_id
        self.kf_chain.remove(k)

    def _on_keyframe_created(self, fr: FrameRecord, kf_id: int):
        """Attach the IMU segment since the previous keyframe, link the
        chain, and store the tracked NavState, before the mapping job."""
        with self.map_lock:
            kf = self.map.keyframes[kf_id]
            kf.nav = kf.nav or {}
            if self.imu_since_kf:
                n = min(len(self.imu_since_kf), self.imu_capacity)
                samples = self.imu_since_kf[len(self.imu_since_kf) - n:]
                kf.nav["imu_t"] = np.array([s[0] for s in samples], np.float32)
                kf.nav["imu_g"] = np.stack([np.asarray(s[1]) for s in samples]).astype(np.float32)
                kf.nav["imu_a"] = np.stack([np.asarray(s[2]) for s in samples]).astype(np.float32)
            else:
                kf.nav["imu_t"] = np.zeros(0, np.float32)
                kf.nav["imu_g"] = np.zeros((0, 3), np.float32)
                kf.nav["imu_a"] = np.zeros((0, 3), np.float32)
            if self.kf_chain:
                kf.prev_kf = self.kf_chain[-1]
                self.map.keyframes[self.kf_chain[-1]].next_kf = kf_id
            self.kf_chain.append(kf_id)
            self.imu_since_kf = []
            if self.vi_ready and self.nav_cur is not None:
                kf.nav["state"] = self._nav_cur_host if self._nav_cur_host is not None else NavState(
                    *self._pull(*self.nav_cur))

    def _insert_keyframe(self, fr: FrameRecord):
        super()._insert_keyframe(fr)
        if not self.async_mapping:
            # the mapping job (VI BA, init rescale) ran inline: re-sync the
            # frame (async re-bases at the next frame entry)
            kf_now = self.map.keyframes[self.last_kf_id]
            fr.r_cw, fr.t_cw = kf_now.r_cw.copy(), kf_now.t_cw.copy()

    def _mapping_ba(self, kf_id: int, window):
        """Vision windowed BA until VI init succeeds (plus the init attempt),
        then the VI windowed BA with the preintegration chain: the vision BA's
        scale-gauge-free solve would fight the IMU's metric scale. Until
        `init_refine_window` seconds after init, the full-chain gravity-vertex
        GBA fires at each chain-span mark, and below the first mark the
        closed-form init is re-solved every second keyframe. Async, after
        VI init: the VI BA is skipped while a newer keyframe waits (the
        next job solves a superset window), at most twice in a row, and
        never after a gravity-vertex GBA; before VI init the vision BA is
        never skipped (the closed-form init solves on its camera
        centers)."""
        if not self.vi_ready:
            with self.map_lock:
                anchor = set()
                for p in self.map.local_map_points(window):
                    for k in self.map.obs_kf[p]:
                        if k >= 0 and int(k) not in window:
                            anchor.add(int(k))
                fixed = sorted(anchor)[:8] or [min(window)]  # pin the gauge
            self._local_ba(window, fixed)
            self._maybe_vi_init()
            return
        with self.map_lock:
            kf_ts = self.map.keyframes[kf_id].timestamp
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
            chain_len = len(chain)
            span = (self.map.keyframes[chain[-1]].timestamp - self.map.keyframes[chain[0]].timestamp
                    if chain_len >= 2 else 0.0)
        if kf_ts - self.init_time < self.init_refine_window:
            marks = self.gw_refine_marks
            if self._gw_mark_done < len(marks) and span >= marks[self._gw_mark_done]:
                while self._gw_mark_done < len(marks) and span >= marks[self._gw_mark_done]:
                    self._gw_mark_done += 1
                self._vi_local_ba(kf_id, window_size=chain_len, optimize_gravity=True, iters=(10, 8))
                self._ba_skips = 0
                return
            if span < marks[0] and chain_len - self._last_refine_len >= 2:
                self._refine_vi_init()
                self._last_refine_len = chain_len
        if self.async_mapping and not self._mapping_queue.empty() and self._ba_skips < 2:
            self._ba_skips += 1
            self.ba_skipped += 1
            return
        self._ba_skips = 0
        self._vi_local_ba(kf_id)

    # -- VI initialization ---------------------------------------------------

    def _chain_snapshot(self, chain):
        """Camera centers, rotations, timestamps and stacked IMU batches of
        the chain keyframes (caller holds the lock)."""
        kfs = [self.map.keyframes[i] for i in chain]
        p_c = np.stack([k.center() for k in kfs])
        r_wc = np.stack([k.r_cw.T for k in kfs])
        ts = np.array([k.timestamp for k in kfs])
        batches = self._stack_batches([self._kf_imu_batch(i) for i in chain[1:]])
        return p_c, r_wc, ts, batches

    def _maybe_vi_init(self):
        with self.map_lock:
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
            if len(chain) < self.vi_init_min_kfs:
                return
            if self.map.keyframes[chain[-1]].timestamp - self.map.keyframes[chain[0]].timestamp < self.vi_init_min_time:
                return
            snap = self._chain_snapshot(chain)
        res = try_vi_init(*snap, r_bc=self.r_bc, p_bc=self.p_bc, noise=self.imu_noise)
        if res is None or not res.success or res.scale <= 0:
            return
        with self.map_lock:  # an async tracker's drain sees the rescale and vi_ready together
            self._apply_init_result(res, chain)
            self.vi_ready = True
            last = self.map.keyframes[chain[-1]]
            self.last_vision_time = last.timestamp
            self.init_time = last.timestamp
        # the post-init global VI BA with gravity fixed at the closed-form
        # estimate (over a short window the free-gravity GBA trades gravity
        # error for bias)
        self._vi_local_ba(chain[-1], window_size=len(chain), iters=(15, 10))

    def _log_init_state(self, res, t):
        if self.init_log_dir is None:
            return
        os.makedirs(self.init_log_dir, exist_ok=True)

        def app(name, vals):
            with open(os.path.join(self.init_log_dir, name), "a") as f:
                f.write(" ".join(f"{v:.6f}" for v in [t] + list(vals)) + "\n")

        app("scale.txt", [res.scale])
        app("gw.txt", list(res.gravity_w))
        app("biasg.txt", list(res.bias_g))
        app("biasa.txt", list(res.bias_a))
        app("condnum.txt", [res.condition_number])

    def _apply_init_result(self, res, chain):
        """Apply a (re-)estimated VI init: rescale the map and the
        trajectory, refresh gravity and biases, give the chain keyframes
        NavStates with the solved velocities, all in one hold of the map
        lock; the tracker continues from the newest chain keyframe (async:
        at its next frame entry, with the biases and gravity left pending).
        Chain keyframes an async tracker made during the solve get NavStates
        from their rescaled poses, with their own velocity rescaled or, when
        they have none yet, the velocity from their chain predecessor (the
        reference leaves their NavStates alone: unscaled, or none, so its
        tracker's drain can find none on the newest keyframe)."""
        with self.map_lock:
            self._log_init_state(res, self.map.keyframes[chain[-1]].timestamp)
            s = res.scale
            pts = self.map.active_point_ids()
            self.map.pt_xyz[pts] *= s
            self.map.pt_min_dist[pts] *= s
            self.map.pt_max_dist[pts] *= s
            for kf in self.map.keyframes.values():
                kf.t_cw = (kf.t_cw * s).astype(np.float32)
            self._rescale_trajectory(s)
            bias_g, bias_a = res.bias_g.astype(np.float32), res.bias_a.astype(np.float32)
            for idx, kf_id in enumerate(chain):
                kf = self.map.keyframes[kf_id]
                kf.nav = kf.nav or {}
                kf.nav["state"] = self._nav_host(kf.r_cw, kf.t_cw, res.velocities[idx], bias_g, bias_a)
            prev = self.map.keyframes[chain[-1]]
            for kf_id in [k for k in self.kf_chain if k > chain[-1] and k in self.map.keyframes]:
                kf = self.map.keyframes[kf_id]
                ns = self._nav_host(kf.r_cw, kf.t_cw, None, bias_g, bias_a)
                if "state" in kf.nav:
                    v = np.asarray(kf.nav["state"].v) * s
                else:
                    v = (ns.p - prev.nav["state"].p) / max(kf.timestamp - prev.timestamp, 1e-3)
                kf.nav["state"] = ns._replace(v=v.astype(np.float32))
                prev = kf
            self.map.version += 1
            self._map_bias_g, self._map_bias_a = bias_g, bias_a
            self._map_gravity = res.gravity_w.astype(np.float32)
            if self.async_mapping:
                self._pending_imu_params = (bias_g, bias_a, self._map_gravity)
                self._rebase_epoch += 1
                return
            self.bias_g, self.bias_a, self.gravity = bias_g, bias_a, self._map_gravity
            self._set_nav_cur(self.map.keyframes[chain[-1]].nav["state"])
            if self.last_frame is not None and self.last_frame.t_cw is not None:
                self.last_frame.t_cw = self.last_frame.t_cw * s

    def _refine_vi_init(self):
        """Re-run the closed-form init on the full (already metric) chain and
        apply it when its scale correction is small (0.7-1.4); triplet
        strides widen with the chain."""
        with self.map_lock:
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
            if len(chain) < max(4, self.vi_init_min_kfs):
                return
            snap = self._chain_snapshot(chain)
        max_stride = max(3, min(6, (len(chain) - 1) // 2))
        res = try_vi_init(*snap, r_bc=self.r_bc, p_bc=self.p_bc, noise=self.imu_noise,
                          strides=tuple(range(1, max_stride + 1)))
        if res is None or not res.success or not 0.7 < res.scale < 1.4:
            return
        self._apply_init_result(res, chain)

    def _need_new_keyframe(self, ts: float) -> bool:
        """The vision rules, or the VI time-gap rule: a keyframe after >= 0.5 s
        without one, so preintegration segments stay short; async, while two
        jobs wait in the mapping queue, after >= 1.5 s."""
        if super()._need_new_keyframe(ts):
            return True
        if self.suppress_keyframes or self.localization_only:
            return False
        if not self.vi_ready or self.n_tracked <= 15:
            return False
        ref_kf = self.map.keyframes.get(self.last_kf_id)
        if ref_kf is None:
            return False
        gap = ts - ref_kf.timestamp
        if self.async_mapping and self._mapping_queue.qsize() >= 2:
            self.saturated_kf_decisions += 1
            return gap >= 1.5
        return gap >= 0.5

    def reset_vi(self):
        """Reset the whole VI system (map and inertial state)."""
        self.reset()
        self.vi_ready = False
        self.gravity = None
        self.imu_since_kf = []
        self.imu_since_frame = []
        self.nav_cur = None
        self._nav_cur_host = None
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        self.kf_chain = []
        self.reloc_bias_prepare = False
        self.reloc_buffer = []
        self.pre_init_lost = 0
        self.frame_prior = None
        self._nav_last_frame = None
        self._map_bias_g = np.zeros(3, np.float32)
        self._map_bias_a = np.zeros(3, np.float32)
        self._map_gravity = None
        self._rebase_epoch = 0
        self._rebase_seen = 0
        self._pending_imu_params = None
        self._gw_mark_done = 0
        self._last_refine_len = 0

    # -- checkpoint / resume -------------------------------------------------

    def save_map(self, path: str):
        """VI checkpoint: the map (keyframe NavStates and IMU segments ride
        along) plus gravity, biases, the keyframe chain and the init time."""
        from viorb_tpu_torch.mapping.serialize import save_map

        self.wait_mapping_idle()
        with self.map_lock:
            extra = {
                "vi_ready": np.array(self.vi_ready),
                "kf_chain": np.asarray([k for k in self.kf_chain if k in self.map.keyframes], np.int64),
                "bias_g": self._map_bias_g,
                "bias_a": self._map_bias_a,
                "init_time": np.float64(self.init_time),
            }
            if self._map_gravity is not None:
                extra["gravity"] = self._map_gravity
            save_map(self.map, path, extra=extra)

    def load_map(self, path: str, localization_only: bool = True):
        """Resume from a VI checkpoint: the next frame relocalizes, then the
        20-frame bias re-solve rebuilds the NavState before VI tracking
        resumes."""
        from viorb_tpu_torch.mapping.serialize import load_map_extra

        super().load_map(path, localization_only=localization_only)
        extra = load_map_extra(path)
        self.vi_ready = bool(extra.get("vi_ready", False))
        self.kf_chain = [int(k) for k in extra.get("kf_chain", [])]
        self.bias_g = np.asarray(extra.get("bias_g", np.zeros(3)), np.float32)
        self.bias_a = np.asarray(extra.get("bias_a", np.zeros(3)), np.float32)
        self._map_bias_g = self.bias_g.copy()
        self._map_bias_a = self.bias_a.copy()
        self.init_time = float(extra.get("init_time", 0.0))
        if "gravity" in extra:
            self.gravity = np.asarray(extra["gravity"], np.float32)
            self._map_gravity = self.gravity.copy()
        # refinement finished in the saved session
        self._gw_mark_done = len(self.gw_refine_marks)
        self.init_refine_window = 0.0
        self.nav_cur = None
        self._nav_cur_host = None
        self.imu_since_kf = []
        self.imu_since_frame = []
        self.frame_prior = None
        self._nav_last_frame = None

    # -- relocalization + bias re-estimation ---------------------------------

    def _begin_reloc_bias_prepare(self, fr: FrameRecord, ts: float):
        """After a relocalization, suspend VI tracking and collect
        vision-only frames for the bias re-solve."""
        self.reloc_bias_prepare = True
        self.reloc_buffer = [(ts, fr.r_cw.copy(), fr.t_cw.copy(), [])]
        self.suppress_keyframes = True
        self.imu_since_kf = []  # the pre-loss segment is no longer usable
        self.frame_prior = None
        self._nav_last_frame = None

    def _reloc_prepare_step(self, fr: FrameRecord, ts: float):
        """Vision-only tracking while the 20-frame buffer fills; then the
        gyro bias and the velocity are re-solved and VI tracking resumes."""
        self._track(fr)  # vision path (keyframe insertion suppressed)
        if self.state != "OK" or fr.r_cw is None:
            # lost again mid-prepare: abandon and wait for the next reloc
            self.reloc_bias_prepare = False
            self.suppress_keyframes = False
            self.reloc_buffer = []
            self.state = "LOST"
            return
        self.reloc_buffer.append((ts, fr.r_cw.copy(), fr.t_cw.copy(), list(self.imu_since_frame)))
        if len(self.reloc_buffer) >= self.reloc_frames_needed:
            self._recompute_bias_and_navstate(ts)

    def _recompute_bias_and_navstate(self, ts: float):
        buf = self.reloc_buffer
        self.reloc_bias_prepare = False
        self.suppress_keyframes = False
        self.reloc_buffer = []
        r_wb = np.stack([(r.T @ self.r_bc.T) for _, r, _, _ in buf])
        batches = self._stack_batches([self._imu_batch(b[3]) for b in buf[1:]])
        zero = self._f32(np.zeros(3))
        pre0 = preintegrate_batch(batches, zero, zero, self._f32([b[0] for b in buf[:-1]]),
                                  self._f32([b[0] for b in buf[1:]]), self.imu_noise)
        self.bias_g = estimate_gyro_bias(r_wb, pre0).astype(np.float32)
        with self.map_lock:
            self._map_bias_g = self.bias_g
        # velocity from the last position difference
        p_cb = -(self.r_bc.T @ self.p_bc)
        p_wb = [-r_cw.T @ t_cw + r_cw.T @ p_cb for _, r_cw, t_cw, _ in buf[-2:]]
        v = (p_wb[1] - p_wb[0]) / max(buf[-1][0] - buf[-2][0], 1e-3)
        last_ts, r_cw, t_cw, _ = buf[-1]
        self._set_nav_cur(self._nav_host(r_cw, t_cw, v=v))
        self.last_vision_time = last_ts
        self.imu_since_kf = []
        self.state = "OK"

    # -- VI tracking ---------------------------------------------------------

    def _track_vi(self, fr: FrameRecord, ts: float):
        """The guard branches of VI tracking: the relocalization bias
        prepare, and a tracker with no inertial anchor (resumed from a
        checkpoint), which relocalizes first (localization-only stays on the
        vision tracker)."""
        if self.reloc_bias_prepare:
            self._reloc_prepare_step(fr, ts)
            return
        if self.nav_cur is None:
            if (self.localization_only and self.last_frame is not None and self.last_frame.r_cw is not None
                    and self.state == "OK"):
                self._track(fr)
                return
            if self._relocalize(fr):
                if not self.localization_only:
                    self._begin_reloc_bias_prepare(fr, ts)
            else:
                self.state = "LOST"
                self.n_tracked = 0
            return
        raise RuntimeError("_track_vi called outside its guard branches")

    def _track_vi_fused(self, image, ts: float) -> FrameRecord:
        """Steady-state VI tracking as ONE graph replay + ONE pull: the
        since-frame and since-keyframe preintegrations, the propagation,
        projection matching (the wide-radius retry on the device) and the
        15-DoF VI pose LM run in the graphed VI core. Frame-to-frame with the
        marginalized prior while the map is unchanged since the prior was
        made, otherwise frame-to-keyframe: two graphs, picked on the host."""
        last_t = self.last_frame.timestamp if self.last_frame else ts
        with self.map_lock:
            last_kf = self.map.keyframes[self.last_kf_id]
            ns_kf, t_kf = last_kf.nav["state"], last_kf.timestamp
            map_version = self.map.version
            epoch = self._rebase_epoch
        pts, dmap = self._device_local_map()
        use_prior = (self.frame_prior is not None and self._prior_map_version == map_version
                     and self._nav_last_frame is not None)
        if use_prior:
            ns_i, prior_state, prior_info = self._nav_last_frame, self.frame_prior.state, self.frame_prior.info
        else:
            ns_i = self._nav_up(ns_kf)
            prior_state, prior_info = ns_i, self._f32(np.zeros((15, 15)))
        out = self._vi_core(
            self._image(image), self.nav_cur, ns_i,
            self._imu_batch(self.imu_since_frame), self._imu_batch(self.imu_since_kf),
            self._f32(last_t), self._f32(ts), self._f32(t_kf),
            self._f32(self.bias_g), self._f32(self.bias_a), self._f32(self.gravity),
            prior_state, prior_info, *dmap, use_prior=use_prior,
        )
        feats, xy_d, fdesc, pf_d, vis_d, _n, nav_pred_d, ns_j_d, inl_d, marg_d = out
        # the frame's single pull (desc01 stays on the device)
        host = self._pull(xy_d, feats.level, feats.angle, feats.valid, pf_d, vis_d, inl_d, *nav_pred_d, *ns_j_d)
        xy, level, angle, fvalid, pf, visible, inl = host[:7]
        nav_pred, ns_j = NavState(*host[7:14]), NavState(*host[14:21])
        fr = FrameRecord(
            timestamp=ts, xy=xy, level=level.astype(np.int32), angle=angle, desc01=None, valid=fvalid,
            desc_pm1=fdesc, point_idx=np.full(xy.shape[0], -1, np.int32), desc01_dev=feats.desc01,
            xy_dev=xy_d, level_dev=feats.level, valid_dev=feats.valid,
        )
        fr.r_cw, fr.t_cw = self._tcw_from_nav(nav_pred)
        n_inl = int(inl.sum())
        if int((pf >= 0).sum()) < 10 or n_inl < 10:
            # IMU-only dead reckoning
            if ts - self.last_vision_time <= IMU_SAFE_WINDOW:
                self.state = "IMU_ONLY"
                self._set_nav_cur(nav_pred, nav_pred_d)
                self.n_tracked = 0
                return fr
            # beyond the IMU window: relocalization, then the 20-frame bias
            # re-solve before VI resumes
            if self._relocalize(fr):
                self._begin_reloc_bias_prepare(fr, ts)
                return fr
            self.state = "LOST"
            self.n_tracked = 0
            return fr
        self.n_tracked = n_inl
        self.state = "OK"
        self.last_vision_time = ts
        self._set_nav_cur(ns_j, ns_j_d)
        fr.r_cw, fr.t_cw = self._tcw_from_nav(ns_j)
        # this frame's marginal information is the next frame's prior
        self.frame_prior = ViPosePrior(ns_j_d, marg_d, self._true)
        self._prior_map_version = map_version
        self._nav_last_frame = ns_j_d
        self._count_tracked(fr, pts, pf, inl, visible)
        self.frames_since_kf += 1
        # a write-back that moved the map while this frame was tracked (its
        # epoch bump) leaves the frame in the map before it: it makes no
        # keyframe, which the next frame's drain would re-base on (async)
        with self.map_lock:
            if self._rebase_epoch != epoch:
                self.frames_across_writeback += 1
            elif self._need_new_keyframe(ts):
                self._insert_keyframe(fr)
                self.frames_since_kf = 0
        return fr

    def _post_loop_gba(self, anchor_kf: int, scale_by_kf=None):
        """VI flavour of the post-loop global BA (reference
        RunGlobalBundleAdjustment -> GlobalBundleAdjustmentNavState and the
        NavState propagation): every keyframe's NavState re-derived from its
        corrected camera pose, the world velocity rotated into the corrected
        frame (Vw2 = Rwb2 Rwb1^T Vw1: the body-frame velocity is invariant)
        and scaled by the keyframe's local world-scale change; then the
        full-chain VI BA, so the IMU chain and the closed loop settle
        together (the scale-free vision GBA would fight the IMU's metric
        scale); then the tracker re-based on the corrected newest keyframe
        (async: the epoch bumped, the tracker re-bases at its next frame).
        It runs in the loop job (async: on the worker), inside the job's
        hold of the map lock, as MonoSlam's does. Before VI init, the
        vision GBA."""
        if not self.vi_ready:
            return super()._post_loop_gba(anchor_kf, scale_by_kf)
        p_cb = -(self.r_bc.T @ self.p_bc)
        with self.map_lock:
            for kf_id, kf in self.map.keyframes.items():
                if not (kf.nav and "state" in kf.nav):
                    continue
                ns = kf.nav["state"]
                r_wc = kf.r_cw.T
                r_wb_new = r_wc @ self.r_bc.T
                p_wb_new = -r_wc @ kf.t_cw + r_wc @ p_cb
                s_loc = 1.0 if scale_by_kf is None else float(scale_by_kf.get(kf_id, 1.0))
                v_new = s_loc * (r_wb_new @ np.asarray(ns.r).T @ np.asarray(ns.v))
                kf.nav["state"] = ns._replace(p=p_wb_new.astype(np.float32), v=v_new.astype(np.float32),
                                              r=r_wb_new.astype(np.float32))
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
        if len(chain) >= 3:
            self._vi_local_ba(chain[-1], window_size=len(chain), iters=(10, 8))
        if self.async_mapping:
            with self.map_lock:
                self._rebase_epoch += 1
            return
        # the tracker restarts from the corrected newest keyframe: the
        # marginalized frame prior and the last frame's NavState are stale
        last = self.map.keyframes[chain[-1]]
        if last.nav and "state" in last.nav:
            self._set_nav_cur(last.nav["state"])
        self.frame_prior = None
        self._nav_last_frame = None
        self.velocity = None

    # -- VI local BA -----------------------------------------------------------

    def _vi_local_ba(self, kf_id: int, window_size: Optional[int] = None, optimize_gravity: bool = False,
                     iters: tuple = (5, 5)):
        """VI BA over the newest `window_size` chain keyframes (default: the
        local window) with covisible outside keyframes fixed: the window's
        consecutive IMU edges, plus composed strides 2, 4 and 8 when a window
        of >= 5 keyframes is given (the global BA); the gravity direction is
        free with `optimize_gravity`. Snapshot under the lock, solve, one
        pull, write-back under the lock (async: the tracker-side gravity
        left pending and the epoch bumped, as the module docstring says)."""
        t_start = time.perf_counter()
        with self.map_lock:
            chain = [k for k in self.kf_chain if k in self.map.keyframes]
            window = chain[-(window_size or self.local_window):]
            if len(window) < 2:
                return
            anchor = set()
            for p in self.map.local_map_points(window):
                for k in self.map.obs_kf[p]:
                    if k >= 0 and int(k) not in window and int(k) in self.map.keyframes:
                        anchor.add(int(k))
            fixed = sorted(anchor)[:6]
            kf_list, pt_ids, kf_idx, uv, inv_s2, valid = self.map.build_ba_problem(
                window, fixed, self.max_ba_landmarks
            )
            if len(pt_ids) == 0:
                return
            # the pose block padded to its bucket: identity NavStates, fixed
            k = pose_bucket(len(kf_list))
            # window keyframes have NavStates; fixed anchors made before VI
            # init get vision-derived ones
            navs = []
            for i in kf_list:
                kf = self.map.keyframes[i]
                navs.append(kf.nav["state"] if kf.nav and "state" in kf.nav else self._nav_host(kf.r_cw, kf.t_cw))
            z3 = np.zeros(3, np.float32)
            navs += [NavState(z3, z3, np.eye(3, dtype=np.float32), z3, z3, z3, z3)] * (k - len(kf_list))
            nav_np = NavState(*(np.stack(x) for x in zip(*navs)))
            points = np.zeros((self.max_ba_landmarks, 3), np.float32)
            points[: len(pt_ids)] = self.map.pt_xyz[pt_ids]
            fixed_mask = np.ones(k, bool)
            fixed_mask[: len(kf_list)] = [i in fixed or i == min(window) for i in kf_list]
            # keyframes made after this snapshot ride the solve's correction
            # through the newest solved keyframe (the write-back)
            next_kf = self.map._next_kf
            ref_slot = max((s for s in range(len(kf_list)) if not fixed_mask[s]), key=kf_list.__getitem__,
                           default=None)
            # the IMU edges between consecutive window keyframes (slots
            # 0..n_win-1); the default chain's remaining k-1 edges run into the
            # anchors and are invalid
            n_win = len(window)
            batches, valid_edges, t0s, t1s = [], [], [], []
            for a, b in zip(window[:-1], window[1:]):
                kfa, kfb = self.map.keyframes[a], self.map.keyframes[b]
                batches.append(self._kf_imu_batch(b))
                # an edge across a tracking-loss gap is dropped
                valid_edges.append(kfb.prev_kf == a and len(kfb.nav["imu_t"]) > 0
                                   and kfb.timestamp - kfa.timestamp < 3.0)
                t0s.append(kfa.timestamp)
                t1s.append(kfb.timestamp)
            while len(batches) < k - 1:
                batches.append(self._imu_batch([]))
                valid_edges.append(False)
                t0s.append(0.0)
                t1s.append(0.01)
            bias_g, bias_a, gravity = self._map_bias_g, self._map_bias_a, self._map_gravity
        pre = preintegrate_batch(self._stack_batches(batches), self._f32(bias_g), self._f32(bias_a),
                                 self._f32(t0s), self._f32(t1s), self.imu_noise)
        bias_info = self._f32(np.concatenate([
            np.full(3, 1.0 / max(self.imu_noise.gyro_bias_rw_var, 1e-12)),
            np.full(3, 1.0 / max(self.imu_noise.acc_bias_rw_var, 1e-12)),
        ]) * 0.005)
        if window_size is not None and n_win >= 5:
            # the global BA: multi-stride composed edges i -> i+s, whose
            # scale signal (~accel dt^2) outgrows their noise (~dt^1.5)
            seg = {1: PreintegratedImu(*(x[: n_win - 1] for x in pre))}
            okd = {1: list(valid_edges[: n_win - 1])}
            strides = [s for s in (2, 4, 8) if s < n_win]
            for s in strides:
                h = s // 2
                seg[s] = compose_preint(PreintegratedImu(*(x[: n_win - s] for x in seg[h])),
                                        PreintegratedImu(*(x[h: h + n_win - s] for x in seg[h])))
                okd[s] = [okd[h][i] and okd[h][i + h] for i in range(n_win - s)]
            idx_i = [i for s in [1] + strides for i in range(n_win - s)]
            idx_j = [i + s for s in [1] + strides for i in range(n_win - s)]
            chain_obj = ImuChain(
                pre=PreintegratedImu(*(torch.cat(x) for x in zip(*(seg[s] for s in [1] + strides)))),
                valid=self._up(np.array([o for s in [1] + strides for o in okd[s]], bool)),
                bias_cov_inv_diag=bias_info,
                idx_i=self._up(np.array(idx_i, np.int64)),
                idx_j=self._up(np.array(idx_j, np.int64)),
            )
        else:
            chain_obj = ImuChain(pre=pre, valid=self._up(np.array(valid_edges, bool)), bias_cov_inv_diag=bias_info)
        state = ViBAState(self._nav_up(nav_np), self._up(points))
        obs = BAObservations(kf_idx=self._up(kf_idx, np.int64), uv=self._up(uv), inv_sigma2=self._up(inv_s2),
                             valid=self._up(valid))
        g_new = None
        kind = "vi_ba_gw" if optimize_gravity else ("vi_gba" if window_size is not None else "vi_local")
        if kind == "vi_local" and tuple(iters) == (5, 5) and k <= GRAPHED_MAX_POSES:
            # the local window: its bucket's graph on the card
            out, valid_out = self._vi_ba_call(self._vi_ba_graph, state, *obs[:4], self.ext, chain_obj.pre,
                                              chain_obj.valid, chain_obj.bias_cov_inv_diag, self._f32(gravity),
                                              self._up(fixed_mask))
        elif optimize_gravity:
            out, g_new, obs2 = vi_ba_gw_two_phase(state, obs, self.cam, self.ext, chain_obj, self._f32(gravity),
                                                  self._up(fixed_mask), iters1=15, iters2=10)
            valid_out = obs2.valid
            self._count_ba(kind, False)
        else:
            out, obs2 = vi_ba_two_phase(state, obs, self.cam, self.ext, chain_obj, self._f32(gravity),
                                        self._up(fixed_mask), iters1=iters[0], iters2=iters[1])
            valid_out = obs2.valid
            self._count_ba(kind, False)
        # one pull for the whole result
        pulled = self._pull(*out.nav, out.points, valid_out, *([] if g_new is None else [g_new]))
        nav_new, p_new, valid_new = NavState(*pulled[:7]), pulled[7], pulled[8]
        with self.map_lock:
            if g_new is not None:
                self._map_gravity = pulled[9].astype(np.float32)
                if self.async_mapping:
                    self._pending_imu_params = (self._map_bias_g, self._map_bias_a, self._map_gravity)
                else:
                    self.gravity = self._map_gravity
            for s_i, i in enumerate(kf_list):
                if fixed_mask[s_i] or i not in self.map.keyframes:
                    continue
                kf = self.map.keyframes[i]
                ns = NavState(*(x[s_i].copy() for x in nav_new))
                kf.nav = kf.nav or {}
                kf.nav["state"] = ns
                kf.r_cw, kf.t_cw = self._tcw_from_nav(ns)
            if ref_slot is not None:
                self._carry_keyframes(next_kf, kf_list, self._tcw_from_nav(navs[ref_slot]),
                                      self._tcw_from_nav(NavState(*(x[ref_slot] for x in nav_new))))
            # only landmarks still alive take the solved positions
            alive = self.map.pt_active[pt_ids]
            self.map.pt_xyz[pt_ids[alive]] = p_new[: len(pt_ids)][alive]
            if kf_id in kf_list:
                if self.async_mapping:  # the tracker re-bases on the moved keyframe
                    self._rebase_epoch += 1
                else:
                    s_i = kf_list.index(kf_id)
                    self._set_nav_cur(NavState(*(x[s_i].copy() for x in nav_new)))
            dropped = valid & ~valid_new
            for row in np.nonzero(dropped[: len(pt_ids)].any(axis=1))[0]:
                p = int(pt_ids[row])
                if not self.map.pt_active[p]:
                    continue
                for s in np.nonzero(dropped[row])[0]:
                    self.map.remove_observation(p, int(kf_list[kf_idx[row, s]]))
            self.map.version += 1
        self.vi_ba_times.append((kind, len(kf_list), (time.perf_counter() - t_start) * 1e3))

    def _carry_keyframes(self, next_kf: int, kf_list, ref_pre, ref_new) -> list:
        """MonoSlam's carry of the keyframes made during a solve; their
        NavStates' position, rotation and velocity follow the same world
        motion. The reference's VI write-back leaves them in the unsolved
        map."""
        moved = super()._carry_keyframes(next_kf, kf_list, ref_pre, ref_new)
        (r_old, t_old), (r_ref, t_ref) = ref_pre, ref_new
        r_corr = r_ref.T @ r_old
        c_old, c_new = -r_old.T @ t_old, -r_ref.T @ t_ref
        for kf in moved:
            if kf.nav and "state" in kf.nav:
                ns = kf.nav["state"]
                kf.nav["state"] = ns._replace(p=(r_corr @ (ns.p - c_old) + c_new).astype(np.float32),
                                              v=(r_corr @ ns.v).astype(np.float32),
                                              r=(r_corr @ ns.r).astype(np.float32))
        return moved

    def _vi_ba_call(self, graph, *args):
        """The local VI BA through `graph`: a replay on the card, the eager
        solve on the CPU; counted as kind "vi_local"."""
        replayed = self._on_card
        out = graph(*args) if replayed else graph.eager(*args)
        self._count_ba("vi_local", replayed)
        return out
