"""Stereo SLAM (port of viorb_tpu/slam/stereo.py: `StereoSlam`, the
reference ORB-SLAM's TrackStereo path with its single-frame stereo
initialization and the close/far point split at keyframe insertion).

A steady frame is MonoSlam's: ONE replay of the graphed pipeline core on
the LEFT image and one pull. The right image is matched only when the
frame becomes a keyframe (or runs the eager path: initialization and the
fallback chain), since per-frame right u and depth feed nothing but a
keyframe's close points and the stereo BA residual. Matching a pair
(`_attach_stereo`):
  * the right image through the extractor (the fused K1 on the card) and
    undistortion;
  * `slam/kernels.py::match_stereo`: one masked Hamming matmul, gated to
    the scan line, the disparity range and the pyramid level;
  * the sub-pixel refinement through the hand-written kernel K9
    (`refine_subpixel`: `slam/stereo_cuda.py` on the card, the plain
    version on the CPU);
  * ONE pull of (ur, matched); depth = bf / disparity.
Initialization is a single frame: every feature with stereo depth becomes a
map point. At keyframe insertion the unmatched features closer than
`depth_factor` baselines become points at once; far ones are left to
two-view triangulation. The BAs add the 3-row stereo residual (`bf`, local
BAs through their own CUDA graphs), and loop closing pins the Sim3 scale.

Threaded modes are the reference's: `async_mapping=True` tracks each frame
on the calling thread beside the mapping worker, and `streaming=True` means
the same (`threaded_kwargs`): the stereo entry never takes MonoSlam's
streaming dispatch, in the reference either, so no collector thread starts.
A keyframe's pair is matched (right extraction, K9) and its close points
made on the calling thread before its job is queued, so the worker's
triangulation, fusion and stereo BA see them; the stereo local BA's graphs
are captured with the cores before the worker starts
(`_capture_before_threads`, at `bf`).
One deliberate difference: a frame with no motion-model anchor after
initialization (a loaded map) relocalizes, as MonoSlam's does, where the
reference's stereo path calls its tracker without a pose to predict from.
"""

from __future__ import annotations

import numpy as np

import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from viorb_tpu_torch.slam.kernels import match_stereo, refine_stereo_subpixel
from viorb_tpu_torch.slam.mono import FrameRecord, MonoSlam

DEPTH_MIN = 0.1


def threaded_kwargs(kwargs: dict) -> dict:
    """MonoSlam's keyword arguments for a stereo or RGB-D pipeline:
    `streaming=True` becomes `async_mapping=True`. The reference's stereo and
    RGB-D entries call the fused tracker on the calling thread whatever the
    flags, and its `streaming` implies async mapping: synchronous tracking
    beside the mapping worker."""
    if kwargs.pop("streaming", False):
        kwargs["async_mapping"] = True
    return kwargs


def refine_subpixel(img_l, img_r, xy_l, ur0, matched) -> torch.Tensor:
    """The sub-pixel right u (`slam/kernels.py::refine_stereo_subpixel`'s
    arguments): K9 on CUDA tensors, the plain version on CPU ones. The
    kernel's module is imported on the card only: it registers K9's launch
    counter."""
    if img_l.is_cuda:
        from viorb_tpu_torch.slam import stereo_cuda

        return stereo_cuda.refine_stereo_subpixel_cuda(img_l, img_r, xy_l, ur0, matched)
    return refine_stereo_subpixel(img_l, img_r, xy_l, ur0, matched)


def backproject(cam: PinholeCamera, fr: FrameRecord, z: np.ndarray) -> np.ndarray:
    """The frame's feature pixels at depths z (N,) -> world points (N,3)
    under the frame's pose."""
    xn = np.stack(
        [(fr.xy[:, 0] - cam.cx) / cam.fx, (fr.xy[:, 1] - cam.cy) / cam.fy, np.ones(len(fr.xy), np.float32)], axis=1
    )
    r_wc = fr.r_cw.T
    return (xn * z[:, None]) @ r_wc.T - r_wc @ fr.t_cw


def initialize_from_depth(slam: MonoSlam, fr: FrameRecord, ok: np.ndarray, z: np.ndarray) -> None:
    """Single-frame metric initialization (the reference's
    StereoInitialization): with at least 100 features `ok`, the frame
    becomes the first keyframe at the origin and each such feature a map
    point at depth z."""
    if ok.sum() < 100:
        return
    fr.r_cw = np.eye(3, dtype=np.float32)
    fr.t_cw = np.zeros(3, np.float32)
    pts_w = backproject(slam.cam, fr, z)
    kf_id = slam.map.add_keyframe(slam._kf_from_frame(fr))
    desc = fr.host_desc01()
    for f in np.nonzero(ok)[0]:
        fr.point_idx[f] = slam.map.add_point(pts_w[f], desc[f], kf_id, int(f))
    slam.map.update_point_stats(slam.map.active_point_ids())
    slam._seed_kf_payload(kf_id, fr)
    if slam.loop_closer is not None:
        with slam.map_lock:
            pay = slam._kf_payload(kf_id)
            slam.loop_closer.add_keyframe(kf_id, pay["desc01"], pay["valid"])
    slam.last_kf_id = kf_id
    slam.frames_since_kf = 0
    slam.velocity = None
    slam.state = "OK"
    slam.n_tracked = int(ok.sum())


def add_close_points(slam: MonoSlam, fr: FrameRecord, kf_id: int, z: np.ndarray, z_max: float) -> None:
    """The keyframe's free features (valid, no map point) with DEPTH_MIN <
    z < z_max become map points at once (the reference's close-point
    creation), before the keyframe's mapping job runs."""
    with slam.map_lock:
        kf = slam.map.keyframes[kf_id]
        free = kf.valid & (kf.point_idx < 0) & (z > DEPTH_MIN) & (z < z_max)
        pts_w = backproject(slam.cam, fr, z)
        desc = kf.ensure_desc01()
        for f in np.nonzero(free)[0]:
            slam.map.add_point(pts_w[f], desc[f], kf_id, int(f))
        slam.map.update_point_stats(slam.map.local_map_points([kf_id]))


class StereoSlam(MonoSlam):
    """Rectified stereo SLAM, lock-step or beside the mapping worker
    (`async_mapping`; `streaming` means the same here). `baseline` in
    metres; close points lie within `depth_factor` baselines; a match needs
    `min_disparity` px. Takes MonoSlam's keyword arguments; `device=None` is
    the card, which builds and loads K9 here, on the constructing thread."""

    loop_fix_scale = True  # the map is metric: loop Sim3s and the essential graph hold s = 1

    def __init__(self, cam: PinholeCamera, baseline: float, depth_factor: float = 35.0,
                 min_disparity: float = 0.5, **kwargs):
        self.baseline = float(baseline)
        self.bf = float(cam.fx) * self.baseline  # before MonoSlam's: its BA graph is the stereo one
        self.depth_th = depth_factor * self.baseline  # the close-point bound
        self.min_disparity = min_disparity
        self._img_r_pending = None  # (left, right) of a steady frame, until it is tracked
        self.right_extractions = 0  # pairs matched (_attach_stereo): one right-image extraction each
        super().__init__(cam, **threaded_kwargs(kwargs))
        if self._on_card:
            from viorb_tpu_torch.slam import stereo_cuda

            stereo_cuda._kernel()  # K9's entry resolved on this thread too

    def _kernel_libraries(self):
        from viorb_tpu_torch.slam import stereo_cuda  # on the card only

        return super()._kernel_libraries() + [stereo_cuda.LIB_NAME]

    # -- frames ----------------------------------------------------------------

    def _make_stereo_frame(self, img_l, img_r, ts: float) -> FrameRecord:
        fr = self._make_frame(img_l, ts)
        self._attach_stereo(fr, img_l, img_r)
        return fr

    def process_frame_stereo(self, img_l, img_r, ts: float) -> dict:
        """Track one rectified pair ((H,W) uint8 or f32 images: arrays or
        tensors). A steady frame replays the pipeline core on the left image
        alone; the pair is matched only if the frame becomes a keyframe.
        Returns MonoSlam's counts and `n_stereo`, the frame's features with a
        stereo match (0 for a steady frame that made no keyframe)."""
        if self.async_mapping:
            self._ensure_threads(img_l)
            self._rebase_last_frame()
        if self.state != "NOT_INITIALIZED" and self.last_frame is not None and self.last_frame.r_cw is not None:
            self._img_r_pending = (img_l, img_r)
            try:
                fr = self._track_fused(img_l, ts)
            finally:
                self._img_r_pending = None
        else:
            fr = self._make_stereo_frame(img_l, img_r, ts)
            if self.state == "NOT_INITIALIZED":
                initialize_from_depth(self, fr, fr.valid & (fr.depth > DEPTH_MIN), fr.depth)
            elif not self._relocalize(fr):  # no motion-model anchor (a loaded map): module docstring
                self.state = "LOST"
                self.n_tracked = 0
        if fr.ref is None:  # the motion-model path books its frame itself
            self._record_trajectory(fr, ts)
        self.last_frame = fr
        return {**self._info(), "n_stereo": int((fr.ur >= 0).sum()) if fr.ur is not None else 0}

    def _insert_keyframe(self, fr: FrameRecord):
        # a steady frame promoted to keyframe: match its pair now
        if fr.ur is None and self._img_r_pending is not None:
            self._attach_stereo(fr, *self._img_r_pending)
        super()._insert_keyframe(fr)

    def _attach_stereo(self, fr: FrameRecord, img_l, img_r):
        """Right extraction, undistortion, row matching and K9's sub-pixel
        refinement on the device, ONE pull of (ur, matched); sets fr.ur and
        fr.depth (-1 where there is no match with disparity >
        min_disparity)."""
        left, right = self._image(img_l), self._image(img_r)
        self.right_extractions += 1
        feats_r = self.extractor.extract(right, device=self.device)
        xy_r = undistort_points(self.cam, feats_r.xy)
        ur, matched = match_stereo(
            fr.xy_dev, fr.desc_pm1, fr.valid_dev, fr.level_dev, xy_r, feats_r.descriptors_pm1(), feats_r.valid,
            feats_r.level, self.min_disparity, self.bf / DEPTH_MIN,
        )
        ur = refine_subpixel(left.float(), right.float(), fr.xy_dev, ur, matched)
        ur, ok = self._pull(ur, matched)
        disp = fr.xy[:, 0] - ur
        ok = ok & (disp > self.min_disparity)
        fr.ur = np.where(ok, ur, -1.0).astype(np.float32)
        fr.depth = np.where(ok, self.bf / np.maximum(disp, 1e-6), -1.0).astype(np.float32)

    # -- mapping -------------------------------------------------------------

    def _on_keyframe_created(self, fr: FrameRecord, kf_id: int):
        """Close points from the keyframe's stereo depth, before its mapping
        job runs."""
        super()._on_keyframe_created(fr, kf_id)
        if fr.depth is not None:
            add_close_points(self, fr, kf_id, fr.depth, self.depth_th)
