"""Monocular vision-only SLAM, lock-step (port of viorb_tpu/slam/mono.py:
`MonoSlam` in its default mode, `async_mapping=False, streaming=False`).

Host orchestration of the port's device functions, playing the reference
ORB-SLAM's Tracking and LocalMapping threads one after the other: each
frame is tracked, and a keyframe insertion runs the mapping job (the
reference's LocalMapping step) before the next frame.

The map lives in MapStore on the host (numpy). Per-frame compute runs on the
device: a steady frame is ONE replay of the graphed pipeline core
(`tracking_loop.make_pipeline_track_core`: extraction, projection matching
with the wide-radius retry, pose LM) and ONE pull of its bookkeeping
fields; the frame's descriptor bits stay on the device unless it becomes a
keyframe. The padded local map is uploaded once per map epoch
(`map.version`, the reference keyframe) and cached. Frames before
initialization and the fallback chain (reference-keyframe matching, then
relocalization without a vocabulary, then LOST) run eagerly; so does the
mapping job (triangulation, fusion, point statistics, local BA, culling).

Uploads go through pinned host memory and never wait for the device; each
pull copies into pinned memory and waits once. The two RANSAC solvers draw
from one `torch.Generator` seeded with `seed`, where the reference splits
`jax.random` keys: the port picks other hypotheses than the reference, so
the two are held to each other by outcome, not bit for bit.

Not ported here: async mapping and streaming (`async_mapping=True`,
`streaming=True`), a vocabulary (BoW relocalization and loop closing) and the
post-loop global BA; each raises NotImplementedError.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from viorb_tpu_torch.device import resolve_device
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
from viorb_tpu_torch.mapping.map import KeyFrameData, MapStore
from viorb_tpu_torch.optim.ba import BAObservations, VisionBAState, vision_ba_two_phase
from viorb_tpu_torch.optim.pose_only import PoseObs, pose_optimization_tcw
from viorb_tpu_torch.slam.kernels import (
    fuse_match_gathered,
    match_by_projection,
    triangulate_between,
    unpack_local_map,
)
from viorb_tpu_torch.slam.tracking_loop import make_pipeline_track_core
from viorb_tpu_torch.solvers.pnp import pnp_ransac
from viorb_tpu_torch.solvers.two_view import two_view_init

_NOT_PORTED = {
    "async_mapping": "async mapping (the mapping worker thread) is not ported yet: use async_mapping=False",
    "streaming": "streaming (the collector thread) is not ported yet: use streaming=False",
    "vocabulary": "a vocabulary (BoW relocalization, loop closing) is not ported yet: use vocabulary=None",
}


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

    def host_desc01(self) -> np.ndarray:
        if self.desc01 is None:
            self.desc01 = self.desc01_dev.cpu().numpy()
        return self.desc01


class MonoSlam:
    """Vision-only monocular SLAM, lock-step (the reference's System facade
    for TrackMonocular). `device=None` is the card
    (`viorb_tpu_torch.default_device()`, which raises without one);
    `device="cpu"` runs every device function's plain version eagerly."""

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
        async_mapping: bool = False,
        streaming: bool = False,
        device=None,
    ):
        for name, value in (("async_mapping", async_mapping), ("streaming", streaming),
                            ("vocabulary", vocabulary is not None)):
            if value:
                raise NotImplementedError(_NOT_PORTED[name])
        self.device = resolve_device(device)
        self.cam = cam
        self.extractor = OrbExtractor(n_features=n_features)
        self.map = MapStore()
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
        # the graphed tracking core (built lazily) + the device copy of the
        # padded local map, cached per map epoch
        self._track_core = None
        self._lm_cache = None
        # kf_id -> device payload (immutable per-KF feature tensors)
        self._kf_dev: dict = {}
        # localization-only: track against the existing map, never insert
        # keyframes or modify the map (reference
        # System::ActivateLocalizationMode -> Tracking::mbOnlyTracking)
        self.localization_only = False
        # host-clock ms of each mapping job's phases, in order of the jobs
        self.job_times: List[Dict[str, float]] = []

    # -- host <-> device ---------------------------------------------------

    def _up(self, a, dtype=None) -> torch.Tensor:
        """A numpy array (or number) on the device, C order. On the card the
        copy goes through pinned memory and does not wait for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _image(self, image) -> torch.Tensor:
        image = torch.as_tensor(image)
        if image.device == self.device:
            return image
        if self.device.type == "cuda" and image.device.type == "cpu":
            return image.contiguous().pin_memory().to(self.device, non_blocking=True)
        return image.to(self.device)

    def _pull(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """The tensors as numpy arrays with ONE wait for the device: each is
        copied into pinned memory without blocking, then the stream is
        synchronized once."""
        if self.device.type != "cuda":
            return [t.detach().numpy().copy() for t in tensors]
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for o, t in zip(outs, tensors):
            o.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [o.numpy() for o in outs]

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
        )

    def process_frame(self, image, ts: float) -> dict:
        """Track one frame (an (H,W) uint8 or f32 image: array or tensor)
        and, when it becomes a keyframe, run the mapping job. Returns the
        state, the tracked-point count and the map's keyframe and point
        counts."""
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
        self._record_trajectory(fr, ts)
        self.last_frame = fr
        return {
            "state": self.state,
            "n_tracked": self.n_tracked,
            "n_kfs": len(self.map.kf_ids()),
            "n_points": len(self.map.active_point_ids()),
        }

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
        the device tensors the tracked frame already owns: triangulation
        and fusion then upload nothing of it."""
        if fr.xy_dev is None or fr.level_dev is None or fr.valid_dev is None:
            return
        desc01 = fr.desc01_dev if fr.desc01_dev is not None else self._up(fr.host_desc01())
        self._kf_dev[kf_id] = dict(
            xy=fr.xy_dev, level=fr.level_dev, valid=fr.valid_dev, desc01=desc01, desc_pm1=fr.desc_pm1,
        )
        self._trim_kf_payloads()

    def _kf_payload(self, kf_id: int) -> dict:
        """Device payload of a keyframe (xy, level, valid, desc01 u8,
        desc_pm1 f32), uploaded once and cached."""
        ent = self._kf_dev.get(kf_id)
        if ent is None:
            kf = self.map.keyframes[kf_id]
            desc01 = kf.desc01_dev if kf.desc01_dev is not None else self._up(kf.ensure_desc01())
            valid = self._up(kf.valid)
            ent = dict(
                xy=self._up(kf.xy),
                level=self._up(kf.level, np.int64),
                valid=valid,
                desc01=desc01,
                desc_pm1=(desc01.to(torch.float32) * 2 - 1) * valid.to(torch.float32)[:, None],
            )
            self._kf_dev[kf_id] = ent
            self._trim_kf_payloads()
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
        r_pred, t_pred = self._predict_pose()
        pts, dev = self._device_local_map()
        feats, xy_d, fdesc, pf_d, r_d, t_d, inl_d, vis_d, _n = self._track_core(
            self._image(image), self._up(r_pred), self._up(t_pred), *dev
        )
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
        )
        fr.r_cw, fr.t_cw = r_pred, t_pred
        n_inl = int(inl.sum())
        if int((pf >= 0).sum()) < 10 or n_inl < 10:
            self._track(fr)  # rare: the host-stepped fallback chain
            return fr
        fr.r_cw, fr.t_cw = r_new, t_new
        self.n_tracked = n_inl
        self.state = "OK"
        self._count_tracked(fr, pts, pf, inl, visible)
        self._track_epilogue(fr)
        return fr

    def _count_tracked(self, fr: FrameRecord, pts, pf, inl, visible):
        """Bind the frame's inlier features to their points and bump the
        points' visible / found counters."""
        ok_feats = np.nonzero((pf >= 0) & inl)[0]
        fr.point_idx[ok_feats] = pts[pf[ok_feats]]
        if len(pts):
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
        if self._need_new_keyframe():
            self._insert_keyframe(fr)
            self.frames_since_kf = 0

    def _need_new_keyframe(self) -> bool:
        if self.localization_only or self.n_tracked <= 15:
            return False
        ref_kf = self.map.keyframes[self.last_kf_id]
        ref_tracked = int((ref_kf.point_idx >= 0).sum())
        interval_hit = self.frames_since_kf >= self.kf_max_interval
        ratio_hit = (
            self.frames_since_kf >= self.kf_min_interval
            and self.n_tracked < 0.6 * max(ref_tracked, 1)
        )
        return interval_hit or ratio_hit

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
        kf = self.map.keyframes.get(self.last_kf_id)
        if kf is None:
            return False
        has = (kf.point_idx >= 0) & kf.valid
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
        pts[mf] = self.map.pt_xyz[kf.point_idx[mk]]
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
        feat_to_pt[mf] = kf.point_idx[mk]
        fr.point_idx = np.where(inl & (feat_to_pt >= 0), feat_to_pt, -1).astype(np.int32)
        self.n_tracked = int(inl.sum())
        self.state = "OK"
        return True

    def _relocalize(self, fr: FrameRecord) -> bool:
        """Candidate keyframes -> descriptor matching to their map points ->
        PnP RANSAC -> pose-only refinement (reference
        Tracking::Relocalization, src/Tracking.cc:2127-2291). Without a
        vocabulary the candidates are the 5 keyframes with the most mutual
        descriptor matches, one batched Hamming matmul per keyframe."""
        scored = []
        for kid, kf_c in self.map.keyframes.items():
            has_c = (kf_c.point_idx >= 0) & kf_c.valid
            if has_c.sum() < 15:
                continue
            res_c = self._match_keyframe(kf_c, fr, has_c)
            scored.append((kid, int((res_c.idx >= 0).sum())))
        cands = sorted(scored, key=lambda x: -x[1])[:5]
        for cand_id, _score in cands:
            kf = self.map.keyframes.get(cand_id)
            has = (kf.point_idx >= 0) & kf.valid
            (idx,) = self._pull(self._match_keyframe(kf, fr, has).idx)
            mk = np.nonzero(idx >= 0)[0]
            if len(mk) < 15:
                continue
            mf = idx[mk]
            nf = fr.xy.shape[0]
            pts = np.zeros((nf, 3), np.float32)
            valid = np.zeros(nf, bool)
            pts[mf] = self.map.pt_xyz[kf.point_idx[mk]]
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
        """Create the keyframe, register its tracked observations, run the
        mapping job, and resync the frame to the keyframe's refined pose."""
        kf_id = self.map.add_keyframe(self._kf_from_frame(fr))
        for f in np.nonzero(fr.point_idx >= 0)[0]:
            p = int(fr.point_idx[f])
            if self.map.pt_active[p]:
                self.map.add_observation(p, kf_id, int(f))
        self._seed_kf_payload(kf_id, fr)
        self.last_kf_id = kf_id
        self._mapping_job(kf_id)
        kf_ = self.map.keyframes[kf_id]
        fr.r_cw, fr.t_cw = kf_.r_cw.copy(), kf_.t_cw.copy()

    def _mapping_job(self, kf_id: int):
        """The LocalMapping step for one keyframe: triangulation + fusion
        (dispatched together, drained with ONE pull), point statistics,
        windowed BA, culling. Appends its phases' host-clock ms to
        `job_times` (a dispatch returns before the device finishes; the
        pull waits for what is left)."""
        times = {}
        t0 = tick = time.perf_counter()

        def lap(name):
            nonlocal tick
            now = time.perf_counter()
            times[name] = (now - tick) * 1e3
            tick = now

        cov = self.map.covisibility_weights(kf_id)
        # spanning-tree parent: older KF with max shared observations
        # (reference attaches mpParent at LocalMapping acceptance)
        older = {k: w for k, w in cov.items() if k < kf_id and k in self.map.keyframes}
        if older:
            self.map.keyframes[kf_id].parent_kf = max(older, key=older.get)
        else:
            prior = [k for k in self.map.keyframes if k < kf_id]
            self.map.keyframes[kf_id].parent_kf = max(prior, default=-1)
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
        touched = self.map.local_map_points([kf_id])
        if len(nb_pts):
            touched = np.unique(np.concatenate([touched, nb_pts]))
        self.map.update_point_stats(touched[self.map.pt_active[touched]])
        window = [kf_id] + sorted(cov, key=cov.get, reverse=True)[: self.local_window - 1]
        lap("stats")
        self._mapping_ba(window)
        lap("ba")
        self._cull_points()
        self._cull_keyframes(window)
        lap("culling")
        self.map.version += 1
        times["total"] = (time.perf_counter() - t0) * 1e3
        self.job_times.append(times)

    def _pull_and_merge(self, kf_id: int, tri_launches, fuse_launches, lap=lambda name: None):
        """ONE pull for dispatched triangulations and fusions (and the
        keyframe's deferred descriptor block), then the merges in dispatch
        order; `lap("pull")` and `lap("merge")` mark the two phases."""
        kf = self.map.keyframes[kf_id]
        deferred = kf.desc01 is None
        pulls = [x for _, out in tri_launches for x in out] + [pf for _, pf, _ in fuse_launches]
        if deferred:
            pulls.append(kf.desc01_dev)
        pulled = self._pull(*pulls)
        lap("pull")
        if deferred:
            kf.desc01 = pulled.pop()
            kf.desc01_dev = None
        dsc1 = kf.ensure_desc01()
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
        touched = np.unique(np.concatenate([own, nb_pts]) if len(nb_pts) else own)
        self.map.update_point_stats(touched[self.map.pt_active[touched]])

    def _mapping_ba(self, window: List[int]):
        """Windowed local BA with outside-window anchors fixed."""
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
        self._local_ba(window, fixed)

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
        """Merge one pulled triangulation result into the map."""
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
        """One keyframe pair's poses + free masks (baseline gate included);
        None when the pair is not worth triangulating."""
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
        return kf.r_cw, kf.t_cw, free1, nb.r_cw, nb.t_cw, free2

    def _fuse_dispatch(self, pt_ids, target_id: int, radius: float, payload, row_of):
        """Dispatch fusion's projection matching for one (points, keyframe)
        pair against the job's union payload; returns (pt_ids, device
        point_for_feat) or None."""
        kf = self.map.keyframes.get(target_id)
        if kf is None or len(pt_ids) == 0:
            return None
        cap = self.max_local_points
        pt_ids = pt_ids[:cap]
        sel = np.full(cap, -1, np.int32)
        sel[: len(pt_ids)] = row_of[pt_ids]
        pay = self._kf_payload(target_id)
        point_for_feat, _, _n, _ = fuse_match_gathered(
            *payload, self._up(sel, np.int64), self._up(kf.r_cw), self._up(kf.t_cw),
            pay["xy"], pay["desc_pm1"], pay["valid"], self.cam, radius,
        )
        return pt_ids, point_for_feat

    def _fuse_apply(self, pt_ids: np.ndarray, pf: np.ndarray, target_id: int) -> int:
        """Merge phase of Fuse: a match on a free feature becomes an
        observation; a match on a feature bound to a DIFFERENT point merges
        the two (the fewer-observed one dies). Alive-gated: points may have
        died in an earlier apply of the same batch."""
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

    def _fuse_batch_dispatch(self, kf_id: int, neighbors: List[int]):
        """Dispatch phase of SearchInNeighbors: one union payload upload,
        then one gather-dispatch per pair (the new KF's points into each
        neighbor, all neighbor points into the new KF, reference
        src/LocalMapping.cc:1487). Returns ([(pt_ids, device pf, target)],
        the keyframe's own points, the neighbors' points)."""
        kf = self.map.keyframes[kf_id]
        own = kf.point_idx[kf.point_idx >= 0]
        nb_pts = self.map.local_map_points(neighbors)
        union = np.unique(np.concatenate([own, nb_pts])) if len(nb_pts) else own
        union = union[: self.max_local_points]
        packed, bits, valid = self._point_payload(union)
        valid[: len(union)] = self.map.pt_active[union]
        payload = (self._up(packed), self._up(bits), self._up(valid))
        row_of = np.full(self.map.max_points, -1, np.int32)
        row_of[union] = np.arange(len(union), dtype=np.int32)
        launches = []
        for pt_ids, target in [(own, nb) for nb in neighbors] + [(nb_pts, kf_id)]:
            out = self._fuse_dispatch(pt_ids, target, 3.0, payload, row_of)
            if out is not None:
                launches.append((out[0], out[1], target))
        return launches, own, nb_pts

    def _local_ba(self, window: List[int], fixed: List[int]):
        """Local BA over `window` with `fixed` anchors, written back to the
        map. The pose block is the window + anchors as they are: the
        reference pads it to a few bucketed sizes (_pose_bucket), one XLA
        compile each; eager PyTorch compiles nothing, so padding would only
        add work. The landmark block keeps the reference's fixed
        `max_ba_landmarks` rows."""
        window = [k for k in window if k in self.map.keyframes]
        fixed = [k for k in fixed if k in self.map.keyframes]
        if len(window) < 2:
            return
        kf_list, pt_ids, kf_idx, uv, inv_s2, valid = self.map.build_ba_problem(
            window, fixed, self.max_ba_landmarks
        )
        if len(pt_ids) == 0:
            return
        r_cw = np.stack([self.map.keyframes[i].r_cw for i in kf_list])
        t_cw = np.stack([self.map.keyframes[i].t_cw for i in kf_list])
        points = np.zeros((self.max_ba_landmarks, 3), np.float32)
        points[: len(pt_ids)] = self.map.pt_xyz[pt_ids]
        fixed_mask = np.array([i in fixed for i in kf_list])
        state = VisionBAState(self._up(r_cw, np.float32), self._up(t_cw, np.float32), self._up(points))
        obs = BAObservations(
            kf_idx=self._up(kf_idx, np.int64), uv=self._up(uv),
            inv_sigma2=self._up(inv_s2), valid=self._up(valid),
        )
        out, obs2 = vision_ba_two_phase(state, obs, self.cam, self._up(fixed_mask))
        r_new, t_new, p_new, valid_new = self._pull(out.r_cw, out.t_cw, out.points, obs2.valid)
        for s, i in enumerate(kf_list):
            if not fixed_mask[s]:
                self.map.keyframes[i].r_cw = r_new[s]
                self.map.keyframes[i].t_cw = t_new[s]
        alive = self.map.pt_active[pt_ids]
        self.map.pt_xyz[pt_ids[alive]] = p_new[: len(pt_ids)][alive]
        # remove observations BA marked as outliers
        dropped = valid & ~valid_new
        for row in np.nonzero(dropped.any(axis=1))[0]:
            p = int(pt_ids[row])
            if not self.map.pt_active[p]:
                continue
            for s in np.nonzero(dropped[row])[0]:
                self.map.remove_observation(p, int(kf_list[kf_idx[row, s]]))
        self.map.version += 1

    def _post_loop_gba(self, anchor_kf: int, scale_by_kf=None):
        """The post-loop global BA: belongs to loop closing, not ported yet."""
        raise NotImplementedError(_NOT_PORTED["vocabulary"])

    def _cull_keyframes(self, window: List[int]):
        """Redundant-keyframe culling (reference LocalMapping::
        KeyFrameCulling, src/LocalMapping.cc:1665-1824): a window KF is
        dropped when > 90 % of its tracked points are observed by at least
        3 other keyframes. The first two keyframes and the newest are never
        culled; at most one KF is culled per call."""
        protected = set(sorted(self.map.keyframes.keys())[:2])
        protected.add(self.last_kf_id)
        for k in window:
            if k in protected or k not in self.map.keyframes:
                continue
            kf = self.map.keyframes[k]
            pts = kf.point_idx[kf.point_idx >= 0]
            if len(pts) < 20:
                continue
            n_obs = (self.map.obs_kf[pts] >= 0).sum(axis=1)
            if (n_obs >= 4).mean() > 0.9:  # self + 3 others
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

    def reset(self):
        """Full system reset (reference Tracking/System::Reset): clear the
        map and initialize anew. Past trajectory entries are
        dropped with their keyframes."""
        self.map = MapStore()
        self.state = "NOT_INITIALIZED"
        self.ref_frame = None
        self.last_frame = None
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.velocity = None
        self._lm_cache = None
        self._kf_dev = {}
        self.traj_entries = []
        self.n_tracked = 0

    def set_localization_mode(self, enabled: bool):
        """Track against the frozen map without inserting keyframes
        (reference System::ActivateLocalizationMode)."""
        self.localization_only = enabled

    def save_map(self, path: str):
        """Checkpoint the full map to one .npz (the JAX package's layout)."""
        from viorb_tpu_torch.mapping.serialize import save_map

        save_map(self.map, path)

    def load_map(self, path: str, localization_only: bool = True):
        """Load a checkpointed map and resume from it. The next frame
        relocalizes into the loaded map (descriptor matching + PnP); with
        localization_only the map stays frozen, otherwise mapping continues
        from the loaded keyframes."""
        from viorb_tpu_torch.mapping.serialize import load_map

        self.map = load_map(path)
        active = self.map.kf_ids()
        self.last_kf_id = max(active) if active else -1
        self.state = "LOST" if active else "NOT_INITIALIZED"
        self.last_frame = None
        self.ref_frame = None
        self.velocity = None
        self.frames_since_kf = 0
        self.localization_only = localization_only
        self._lm_cache = None
        self._kf_dev = {}

    # -- output --------------------------------------------------------------

    def _record_trajectory(self, fr: FrameRecord, ts: float):
        if fr.r_cw is None or self.last_kf_id < 0:
            return
        kf = self.map.keyframes.get(self.last_kf_id)
        if kf is None:
            return
        # T_rel = T_frame_cw * T_kf_cw^{-1}
        r_rel = fr.r_cw @ kf.r_cw.T
        t_rel = fr.t_cw - r_rel @ kf.t_cw
        self.traj_entries.append((ts, self.last_kf_id, r_rel, t_rel))

    def trajectory_tum(self) -> np.ndarray:
        """(T,8): t, tx ty tz, qx qy qz qw (camera-to-world), composing the
        stored relative poses with the keyframes' CURRENT poses (reference
        SaveTrajectoryTUM)."""
        ts, centers, r_wcs = [], [], []
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


def normalize_np(R: np.ndarray) -> np.ndarray:
    """Re-orthonormalize a 3x3 rotation on the host (SVD projection), f32."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    d = np.sign(np.linalg.det(u @ vt))
    return (u @ np.diag([1.0, 1.0, d]) @ vt).astype(np.float32)
