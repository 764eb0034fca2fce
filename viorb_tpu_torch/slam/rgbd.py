"""RGB-D SLAM (port of viorb_tpu/slam/rgbd.py: `RgbdSlam`, the reference
ORB-SLAM's TrackRGBD path: a single-frame initialization from the depth
image and direct point creation at keyframe insertion).

A steady frame is MonoSlam's: ONE replay of the graphed pipeline core on
the image and one pull. The depth image is sampled only at a keyframe's
features (or on the eager path: initialization), at the rounded keypoint
pixel, clamped to the image, with one pull when it lies on the card. There
is no `bf`: the BAs stay monocular, as in the reference; loop closing pins
the Sim3 scale (the map is metric).

Threaded modes as `slam/stereo.py`'s: `async_mapping=True` (or
`streaming=True`, which means the same here) tracks on the calling thread
beside the mapping worker; a keyframe's depth is sampled and its points
made before its job is queued.
A frame with no motion-model anchor after initialization (a loaded map)
relocalizes, as MonoSlam's does (`slam/stereo.py` says why).
"""

from __future__ import annotations

import numpy as np
import torch

from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.slam.mono import FrameRecord, MonoSlam
from viorb_tpu_torch.slam.stereo import DEPTH_MIN, add_close_points, initialize_from_depth, threaded_kwargs

DEPTH_MAX = 12.0


class RgbdSlam(MonoSlam):
    """RGB-D SLAM with metric depth images, lock-step or beside the mapping
    worker (`async_mapping`; `streaming` means the same here); features
    deeper than `depth_max` m get no point from the depth image. Takes
    MonoSlam's keyword arguments; `device=None` is the card."""

    loop_fix_scale = True  # the map is metric: loop Sim3s and the essential graph hold s = 1

    def __init__(self, cam: PinholeCamera, depth_max: float = DEPTH_MAX, **kwargs):
        super().__init__(cam, **threaded_kwargs(kwargs))
        self.depth_max = depth_max
        self._pending_depth = None  # the depth image of the frame being tracked

    def _sample_depth(self, depth, fr: FrameRecord) -> np.ndarray:
        """(N,) f32 depth at the frame's features: the pixel at the rounded
        keypoint (half to even), clamped to the image."""
        h, w = depth.shape
        xs = np.clip(np.round(fr.xy[:, 0]).astype(np.int64), 0, w - 1)
        ys = np.clip(np.round(fr.xy[:, 1]).astype(np.int64), 0, h - 1)
        if isinstance(depth, torch.Tensor):
            if depth.device.type == "cpu":
                depth = depth.numpy()
            else:
                (z,) = self._pull(depth[self._up(ys), self._up(xs)])
                return z.astype(np.float32)
        return np.asarray(depth, np.float32)[ys, xs]

    def process_frame_rgbd(self, image, depth, ts: float) -> dict:
        """Track one frame (an (H,W) uint8 or f32 image) with its (H,W) metric
        depth image (array or tensor; <= 0 where there is none). Returns
        MonoSlam's counts."""
        if self.async_mapping:
            self._ensure_threads(image)
            self._rebase_last_frame()
        self._pending_depth = depth
        try:
            if self.state != "NOT_INITIALIZED" and self.last_frame is not None and self.last_frame.r_cw is not None:
                fr = self._track_fused(image, ts)
            else:
                fr = self._make_frame(image, ts)
                if self.state == "NOT_INITIALIZED":
                    z = self._sample_depth(depth, fr)
                    initialize_from_depth(self, fr, fr.valid & (z > DEPTH_MIN) & (z < self.depth_max), z)
                elif not self._relocalize(fr):  # no motion-model anchor (a loaded map): module docstring
                    self.state = "LOST"
                    self.n_tracked = 0
        finally:
            self._pending_depth = None
        if fr.ref is None:  # the motion-model path books its frame itself
            self._record_trajectory(fr, ts)
        self.last_frame = fr
        return self._info()

    def _on_keyframe_created(self, fr: FrameRecord, kf_id: int):
        """Points from the depth image at the keyframe's free features,
        before its mapping job runs."""
        super()._on_keyframe_created(fr, kf_id)
        if self._pending_depth is not None:
            add_close_points(self, fr, kf_id, self._sample_depth(self._pending_depth, fr), self.depth_max)
