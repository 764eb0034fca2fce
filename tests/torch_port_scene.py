"""Shared state for the port's parity tests (tests/test_torch_*.py): a
rendered arc at half size (240x376, camera scaled by 1/2) and the
reference's localization map, built by the JAX package's own extractor
from frame 0 and lifted with the renderer's ground-truth depth."""

import jax.numpy as jnp
import numpy as np

from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu.geometry.camera import undistort_points as ref_undistort
from viorb_tpu.io import synthetic as ref_synthetic
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.io import synthetic

N_FEATURES = 300
MAP_SLOTS = 1024
REF_CAM = RefCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)


def render_scene(n_frames):
    """(port camera, r_wc, c_w, port room, stacked planes, uint8 frames)."""
    cam = camera_from_fields(REF_CAM)
    r_wc, c_w = synthetic.make_trajectory(n_frames, dt=0.1)
    rooms = synthetic.default_room(0)
    planes = synthetic.stack_planes(rooms, device="cpu")
    frames = [
        synthetic.to_uint8(synthetic.render_frame(cam, r_wc[i], c_w[i], planes))
        for i in range(n_frames)
    ]
    return cam, r_wc, c_w, rooms, planes, frames


def reference_map(r_wc0, c_w0, frame0, feats=None):
    """The reference's DeviceMap fields as numpy (desc_pm1 as f32). `feats`:
    the reference's features of frame 0, where the caller has them already
    (a tracking core returns them) and need not compile the extractor on
    its own."""
    if feats is None:
        feats = RefExtractor(n_features=N_FEATURES).extract(frame0.numpy())
    xy = np.asarray(ref_undistort(REF_CAM, feats.xy))
    depth = ref_synthetic.depth_at(REF_CAM, r_wc0, c_w0, ref_synthetic.default_room(0), xy)
    ok = np.asarray(feats.valid) & np.isfinite(depth)
    rays = np.stack(
        [(xy[:, 0] - REF_CAM.cx) / REF_CAM.fx, (xy[:, 1] - REF_CAM.cy) / REF_CAM.fy,
         np.ones(len(xy))], -1,
    )
    pts = (rays * np.where(ok, depth, 0.0)[:, None]) @ r_wc0.T + c_w0
    pts = np.where(ok[:, None], pts, 0.0)
    dirs = pts - c_w0
    normal = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-9)
    pad = MAP_SLOTS - len(xy)

    def padded(x):
        return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])

    return dict(
        xyz=padded(pts.astype(np.float32)),
        desc_pm1=padded(np.asarray(feats.descriptors_pm1(jnp.float32))),
        valid=padded(ok),
        normal=padded(normal.astype(np.float32)),
        dmin=np.zeros(MAP_SLOTS, np.float32),
        dmax=np.full(MAP_SLOTS, 1e9, np.float32),
    )
