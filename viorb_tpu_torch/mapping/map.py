"""Map store: keyframes, map points, observations, covisibility (port of
viorb_tpu/mapping/map.py, numpy as there).

Replaces the reference's Map/KeyFrame/MapPoint pointer graph
(reference: src/Map.cc, src/KeyFrame.cc, src/MapPoint.cc) with
fixed-capacity struct-of-arrays storage:

  * host-side numpy index structures (observation lists, covisibility,
    spanning tree) — the graph bookkeeping the reference also does on the
    CPU, here without the mutex web (snapshots are cheap array copies);
  * geometry/descriptor payloads kept as arrays ready to ship to device
    kernels (BA problem assembly emits the landmark-major grid of
    optim.ba directly).

The reference's per-object locks disappear: `MonoSlam` guards the store
with one lock (`map_lock`), mutates it under that lock and hands the
device functions snapshots taken under it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from viorb_tpu_torch import native

# Observation slots per point. 16 covers the BA window (10 KFs) plus
# anchors; a landmark observed by more keyframes than this keeps its BA
# constraints through the newest window anyway. Overflow is counted on the
# store (obs_overflow) and warned once — see add_observation.
MAX_OBS_PER_POINT = 16


@dataclass
class KeyFrameData:
    """Per-keyframe record (reference: KeyFrame members)."""

    kf_id: int
    timestamp: float
    r_cw: np.ndarray  # (3,3)
    t_cw: np.ndarray  # (3,)
    xy: np.ndarray  # (N,2) undistorted keypoint pixels (level-0 coords)
    level: np.ndarray  # (N,)
    angle: np.ndarray  # (N,)
    # (N,256) uint8; may be None until ensure_desc01() pulls it from
    # desc01_dev (keyframes created from streamed frames defer the 256 KB
    # device pull to the mapping job's batched pull)
    desc01: Optional[np.ndarray]
    valid: np.ndarray  # (N,) bool
    point_idx: np.ndarray  # (N,) int32 map-point id per feature (-1 none)
    # stereo: right-image u per feature (-1 = no stereo match)
    ur: Optional[np.ndarray] = None
    # VI fields (reference KeyFrame's NavState and IMU segment), filled by
    # MonoViSlam: "state", the keyframe's NavState with numpy fields (after
    # VI init); "imu_t" (S,), "imu_g" (S,3), "imu_a" (S,3), the IMU samples
    # since the previous chain keyframe (prev_kf / next_kf link the chain)
    nav: Optional[dict] = None
    imu_t0: float = 0.0
    prev_kf: int = -1
    next_kf: int = -1
    # spanning-tree parent: the older keyframe sharing the most map points
    # (reference KeyFrame::mpParent, include/KeyFrame.h:115-135); -1 = root
    parent_kf: int = -1
    bow: Optional[np.ndarray] = None  # sparse BoW vector (host)
    active: bool = True
    # device tensor backing a deferred desc01 (see ensure_desc01)
    desc01_dev: Optional[object] = None
    # lazy caches for the native update_point_stats kernel (descriptors
    # and levels are immutable once the keyframe exists)
    _desc_bits: Optional[np.ndarray] = None
    _level_i32: Optional[np.ndarray] = None

    @property
    def n_feats(self) -> int:
        return self.xy.shape[0]

    def center(self) -> np.ndarray:
        return -self.r_cw.T @ self.t_cw

    def ensure_desc01(self) -> np.ndarray:
        """Host descriptor block, pulling it from the device handle on
        first use (the mapping job batches this pull with its
        triangulation results; any other caller pays one pull)."""
        d = self.desc01
        if d is None:
            # two threads may race here (mapping worker vs tracker
            # fallback): the handle is read once, so a concurrent fulfiller
            # clearing desc01_dev cannot break this one, and a block another
            # fulfiller set is kept
            dev = self.desc01_dev
            if dev is not None:
                block = dev.cpu().numpy()
                if self.desc01 is None:
                    self.desc01 = block
                self.desc01_dev = None
            d = self.desc01
        return d

    def desc_bits(self) -> np.ndarray:
        """(N,4) uint64 packed 256-bit descriptors (bit b of word w =
        desc01[w*64+b]); cached — descriptors never change."""
        if self._desc_bits is None:
            packed = np.packbits(
                np.ascontiguousarray(self.ensure_desc01()), axis=1,
                bitorder="little",
            )
            self._desc_bits = np.ascontiguousarray(packed).view(np.uint64)
        return self._desc_bits

    def level_i32(self) -> np.ndarray:
        if self._level_i32 is None:
            self._level_i32 = np.ascontiguousarray(self.level, np.int32)
        return self._level_i32


class MapStore:
    """max_points is the INITIAL capacity: the SoA arrays grow
    geometrically on demand (the reference's std::set maps are unbounded,
    src/Map.cc; a KITTI-length run must not hit a hard wall). Device-side
    launch shapes stay fixed — they are capped by the local-map /
    BA-landmark capacities, not by the store size."""

    def __init__(self, max_points: int = 32768):
        self.keyframes: Dict[int, KeyFrameData] = {}
        self._next_kf = 0
        self.max_points = max_points
        # map point SoA
        self.pt_xyz = np.zeros((max_points, 3), np.float32)
        self.pt_desc01 = np.zeros((max_points, 256), np.uint8)
        self.pt_normal = np.zeros((max_points, 3), np.float32)
        self.pt_min_dist = np.zeros(max_points, np.float32)
        self.pt_max_dist = np.zeros(max_points, np.float32)
        self.pt_found = np.zeros(max_points, np.int32)
        self.pt_visible = np.zeros(max_points, np.int32)
        self.pt_first_kf = np.full(max_points, -1, np.int32)
        self.pt_active = np.zeros(max_points, bool)
        # slot generation, bumped each time a slot is handed to a new point:
        # a deferred write-back compares it with its snapshot, so it never
        # lands on a point that took a culled point's slot. Not part of a
        # checkpoint (the reference's layout has no such array).
        self.pt_gen = np.zeros(max_points, np.int64)
        # observations: point -> (kf, feat) slots
        self.obs_kf = np.full((max_points, MAX_OBS_PER_POINT), -1, np.int32)
        self.obs_feat = np.full((max_points, MAX_OBS_PER_POINT), -1, np.int32)
        self._next_pt = 0
        self._free_pts: List[int] = []
        self.obs_overflow = 0  # observations dropped on full slot rows
        # map-update epoch: bumped after every mapping write-back; readers
        # compare epochs instead of polling flags (reference
        # GetMapUpdateFlagForTracking, src/Tracking.cc:896-906)
        self.version = 0

    # -- keyframes ---------------------------------------------------------

    def add_keyframe(self, kf: KeyFrameData) -> int:
        kf.kf_id = self._next_kf
        self.keyframes[kf.kf_id] = kf
        self._next_kf += 1
        return kf.kf_id

    def kf_ids(self) -> List[int]:
        return [k for k, v in self.keyframes.items() if v.active]

    # -- points ------------------------------------------------------------

    def _grow_points(self, need: int):
        """Double the point-SoA capacity until it covers `need` rows."""
        new_cap = self.max_points
        while new_cap < need:
            new_cap *= 2
        if new_cap == self.max_points:
            return
        old = self.max_points

        def ext(a, fill):
            out = np.empty((new_cap,) + a.shape[1:], a.dtype)
            out[:old] = a
            out[old:] = fill
            return out

        self.pt_xyz = ext(self.pt_xyz, 0)
        self.pt_desc01 = ext(self.pt_desc01, 0)
        self.pt_normal = ext(self.pt_normal, 0)
        self.pt_min_dist = ext(self.pt_min_dist, 0)
        self.pt_max_dist = ext(self.pt_max_dist, 0)
        self.pt_found = ext(self.pt_found, 0)
        self.pt_visible = ext(self.pt_visible, 0)
        self.pt_first_kf = ext(self.pt_first_kf, -1)
        self.pt_active = ext(self.pt_active, False)
        self.pt_gen = ext(self.pt_gen, 0)
        self.obs_kf = ext(self.obs_kf, -1)
        self.obs_feat = ext(self.obs_feat, -1)
        self.max_points = new_cap

    def add_point(
        self, xyz, desc01, kf_id: int, feat_idx: int, normal=None
    ) -> int:
        if self._free_pts:
            i = self._free_pts.pop()
        else:
            i = self._next_pt
            self._next_pt += 1
            if i >= self.max_points:
                self._grow_points(i + 1)
        self.pt_gen[i] += 1
        self.pt_xyz[i] = xyz
        self.pt_desc01[i] = desc01
        self.pt_active[i] = True
        self.pt_found[i] = 1
        self.pt_visible[i] = 1
        self.pt_first_kf[i] = kf_id
        self.obs_kf[i] = -1
        self.obs_feat[i] = -1
        kf = self.keyframes[kf_id]
        c = kf.center()
        d = self.pt_xyz[i] - c
        dist = np.linalg.norm(d)
        self.pt_normal[i] = d / max(dist, 1e-9)
        level = int(kf.level[feat_idx])
        scale = 1.2**level
        self.pt_max_dist[i] = dist * scale
        self.pt_min_dist[i] = self.pt_max_dist[i] / (1.2**7)
        self.add_observation(i, kf_id, feat_idx)
        return i

    def add_points_batch(
        self,
        xyz: np.ndarray,  # (n,3)
        desc01: np.ndarray,  # (n,256)
        kf_id: int,
        feats1: np.ndarray,  # (n,) feature rows in kf_id
        nb_id: int,
        feats2: np.ndarray,  # (n,) feature rows in nb_id
    ) -> np.ndarray:
        """Vectorized add_point + two add_observations for a batch of
        freshly triangulated landmarks (the per-point Python path costs
        ~0.2 ms each; triangulation adds hundreds per keyframe). Callers
        guarantee feats1/feats2 are unbound and duplicate-free (mutual
        matching)."""
        n = len(feats1)
        if n == 0:
            return np.zeros(0, np.int64)
        take = min(len(self._free_pts), n)
        ids = [self._free_pts.pop() for _ in range(take)]
        rest = n - take
        if rest:
            if self._next_pt + rest > self.max_points:
                self._grow_points(self._next_pt + rest)
            ids.extend(range(self._next_pt, self._next_pt + rest))
            self._next_pt += rest
        ids = np.asarray(ids, np.int64)
        kf = self.keyframes[kf_id]
        nb = self.keyframes[nb_id]
        self.pt_gen[ids] += 1
        self.pt_xyz[ids] = xyz
        self.pt_desc01[ids] = desc01
        self.pt_active[ids] = True
        self.pt_found[ids] = 1
        self.pt_visible[ids] = 1
        self.pt_first_kf[ids] = kf_id
        self.obs_kf[ids] = -1
        self.obs_feat[ids] = -1
        c = kf.center()
        d = xyz - c
        dist = np.linalg.norm(d, axis=1)
        self.pt_normal[ids] = d / np.maximum(dist, 1e-9)[:, None]
        mx = dist * 1.2 ** kf.level[feats1].astype(np.float32)
        self.pt_max_dist[ids] = mx
        self.pt_min_dist[ids] = mx / (1.2**7)
        self.obs_kf[ids, 0] = kf_id
        self.obs_feat[ids, 0] = feats1
        self.obs_kf[ids, 1] = nb_id
        self.obs_feat[ids, 1] = feats2
        kf.point_idx[feats1] = ids
        nb.point_idx[feats2] = ids
        return ids

    def add_observation(self, pt: int, kf_id: int, feat_idx: int) -> bool:
        slots = self.obs_kf[pt]
        if (slots == kf_id).any():
            return True
        free = np.nonzero(slots < 0)[0]
        if len(free) == 0:
            self.obs_overflow += 1
            if self.obs_overflow in (1, 1000):
                import sys

                print(
                    f"[map] observation slots full on point {pt} "
                    f"({self.obs_overflow} overflow(s) so far, "
                    f"cap {MAX_OBS_PER_POINT})",
                    file=sys.stderr,
                )
            return False
        s = free[0]
        self.obs_kf[pt, s] = kf_id
        self.obs_feat[pt, s] = feat_idx
        self.keyframes[kf_id].point_idx[feat_idx] = pt
        return True

    def remove_point(self, pt: int):
        for s in range(MAX_OBS_PER_POINT):
            kf_id = self.obs_kf[pt, s]
            if kf_id >= 0 and kf_id in self.keyframes:
                fi = self.obs_feat[pt, s]
                kf = self.keyframes[kf_id]
                if kf.point_idx[fi] == pt:
                    kf.point_idx[fi] = -1
        self.obs_kf[pt] = -1
        self.obs_feat[pt] = -1
        self.pt_active[pt] = False
        self._free_pts.append(pt)

    def remove_observation(self, pt: int, kf_id: int):
        for s in range(MAX_OBS_PER_POINT):
            if self.obs_kf[pt, s] == kf_id:
                fi = self.obs_feat[pt, s]
                kf = self.keyframes.get(kf_id)
                if kf is not None and kf.point_idx[fi] == pt:
                    kf.point_idx[fi] = -1
                self.obs_kf[pt, s] = -1
                self.obs_feat[pt, s] = -1
        if self.n_obs(pt) < 2:
            # orphaned points die (like MapPoint::SetBadFlag on obs loss)
            if self.pt_active[pt]:
                self.remove_point(pt)

    def n_obs(self, pt: int) -> int:
        return int((self.obs_kf[pt] >= 0).sum())

    def replace_point(self, old: int, new: int):
        """Merge `old` into `new` (reference MapPoint::Replace,
        include/MapPoint.h:64): every observation of old re-points to new
        (where new has no observation in that keyframe yet and a free
        slot), found/visible counters merge, old dies."""
        if old == new or not self.pt_active[old] or not self.pt_active[new]:
            return
        for s in range(MAX_OBS_PER_POINT):
            kf_id = int(self.obs_kf[old, s])
            if kf_id < 0 or kf_id not in self.keyframes:
                continue
            fi = int(self.obs_feat[old, s])
            kf = self.keyframes[kf_id]
            if (self.obs_kf[new] == kf_id).any():
                # new already observed there: just clear the feature link
                if kf.point_idx[fi] == old:
                    kf.point_idx[fi] = -1
            else:
                self.obs_kf[old, s] = -1  # detach before re-adding
                if not self.add_observation(new, kf_id, fi):
                    if kf.point_idx[fi] == old:
                        kf.point_idx[fi] = -1
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        self.obs_kf[old] = -1
        self.obs_feat[old] = -1
        self.pt_active[old] = False
        self._free_pts.append(old)

    def active_point_ids(self) -> np.ndarray:
        return np.nonzero(self.pt_active[: self._next_pt])[0]

    # -- derived structures -------------------------------------------------

    def update_point_stats(self, pt_ids: np.ndarray):
        """Recompute distinctive descriptor (median Hamming, reference
        MapPoint::ComputeDistinctiveDescriptors) and normal/depth range
        (UpdateNormalAndDepth) for the given points, in the native C++
        kernel (XOR+popcount over packed bits).
        `update_point_stats_numpy` below is the behavioral spec."""
        if len(pt_ids) == 0:
            return
        n_kf = self._next_kf
        desc_ptrs = np.zeros(n_kf, np.uint64)
        level_ptrs = np.zeros(n_kf, np.uint64)
        centers = np.zeros((n_kf, 3), np.float32)
        alive = np.zeros(n_kf, np.uint8)
        keep = []  # keep the per-kf caches referenced during the call
        for k, kf in self.keyframes.items():
            db = kf.desc_bits()
            lv = kf.level_i32()
            keep.append((db, lv))
            desc_ptrs[k] = db.ctypes.data
            level_ptrs[k] = lv.ctypes.data
            centers[k] = kf.center()
            alive[k] = 1
        native.update_point_stats(
            np.ascontiguousarray(pt_ids, np.int64),
            self.obs_kf, self.obs_feat,
            desc_ptrs, level_ptrs, centers, alive,
            self.pt_xyz, self.pt_desc01, self.pt_normal,
            self.pt_min_dist, self.pt_max_dist,
        )
        del keep

    def covisibility_weights(self, kf_id: int) -> Dict[int, int]:
        """Count shared map points with other keyframes (reference:
        KeyFrame::UpdateConnections, >=15 threshold applied by callers).
        Hot host path — runs in the native C++ kernel."""
        kf = self.keyframes[kf_id]
        pts = kf.point_idx[kf.point_idx >= 0].astype(np.int64)
        if len(pts) == 0:
            return {}
        counts = native.covis_count(pts, self.obs_kf, kf_id, self._next_kf)
        return {
            int(k): int(c)
            for k, c in zip(np.nonzero(counts)[0], counts[counts > 0])
            if int(k) in self.keyframes
        }

    def local_map_points(self, kf_ids: List[int]) -> np.ndarray:
        """All active points observed by the given keyframes (native)."""
        arrs = [
            self.keyframes[k].point_idx
            for k in kf_ids
            if k in self.keyframes
        ]
        if not arrs:
            return np.zeros(0, np.int64)
        mask = native.union_points(
            np.concatenate(arrs), self.pt_active
        )
        return np.nonzero(mask)[0].astype(np.int64)

    # -- BA problem assembly -------------------------------------------------

    def build_ba_problem(
        self, window_kfs: List[int], fixed_kfs: List[int], max_landmarks: int
    ):
        """Emit the landmark-major BA grid (optim.ba.BAObservations layout)
        for the given window. Returns (kf_list, point_ids, kf_idx, feat_uv,
        inv_sigma2, valid) as numpy; caller converts to device arrays.

        kf_list = window_kfs + fixed_kfs; kf slot = index into kf_list.
        """
        kf_list = list(window_kfs) + [k for k in fixed_kfs if k not in window_kfs]
        slot_of_kf = np.full(self._next_kf, -1, np.int32)
        for i, k in enumerate(kf_list):
            slot_of_kf[k] = i
        pts = self.local_map_points(window_kfs)
        # prioritize points with most observations in the window
        if len(pts) > max_landmarks:
            counts = (self.obs_kf[pts] >= 0).sum(1)
            pts = pts[np.argsort(-counts)[:max_landmarks]]
        m = max_landmarks
        r = MAX_OBS_PER_POINT
        n_feat = max(self.keyframes[k].n_feats for k in kf_list)
        xy_all = np.zeros((len(kf_list), n_feat, 2), np.float32)
        level_all = np.zeros((len(kf_list), n_feat), np.int32)
        for i, k in enumerate(kf_list):
            kf = self.keyframes[k]
            xy_all[i, : kf.n_feats] = kf.xy
            level_all[i, : kf.n_feats] = kf.level
        inv_sigma2_of_level = (1.0 / 1.2 ** (2 * np.arange(16))).astype(np.float32)
        kf_idx_p, uv_p, inv_s2_p, valid_p = native.build_ba_grid(
            pts.astype(np.int64), self.obs_kf, self.obs_feat, slot_of_kf,
            xy_all, level_all, inv_sigma2_of_level,
        )
        kf_idx = np.zeros((m, r), np.int32)
        uv = np.zeros((m, r, 2), np.float32)
        inv_sigma2 = np.ones((m, r), np.float32)
        valid = np.zeros((m, r), bool)
        n = len(pts)
        kf_idx[:n] = kf_idx_p
        uv[:n] = uv_p
        inv_sigma2[:n] = inv_s2_p
        valid[:n] = valid_p
        return kf_list, pts, kf_idx, uv, inv_sigma2, valid

    def build_stereo_ur_grid(self, pt_ids: np.ndarray, kf_list: List[int], max_landmarks: int):
        """The right-u observation grid slot-aligned with build_ba_problem's
        (the stereo BA residual's): (ur (M,R) f32, -1 where none, ur_valid
        (M,R) bool), from each keyframe's `ur`."""
        m, r = max_landmarks, MAX_OBS_PER_POINT
        ur = np.full((m, r), -1.0, np.float32)
        urv = np.zeros((m, r), bool)
        if len(pt_ids) == 0:
            return ur, urv
        kfm = self.obs_kf[pt_ids]
        fm = self.obs_feat[pt_ids]
        for k in kf_list:
            kf = self.keyframes.get(k)
            if kf is None or kf.ur is None:
                continue
            rows, slots = np.nonzero(kfm == k)
            vals = kf.ur[fm[rows, slots]]
            ur[rows, slots] = vals
            urv[rows, slots] = vals >= 0
        return ur, urv


def update_point_stats_numpy(m: MapStore, pt_ids: np.ndarray) -> None:
    """`MapStore.update_point_stats` as a numpy loop, the reference's
    fallback (viorb_tpu/mapping/map.py): the behavioral spec the tests hold
    the native kernel to. Not called by the port."""
    for p in pt_ids:
        obs = [
            (int(k), int(f))
            for k, f in zip(m.obs_kf[p], m.obs_feat[p])
            if k >= 0 and k in m.keyframes
        ]
        if not obs:
            continue
        descs = np.stack([m.keyframes[k].ensure_desc01()[f] for k, f in obs])
        if len(descs) > 1:
            # median-hamming-distance descriptor
            d = (descs[:, None, :] != descs[None, :, :]).sum(-1)
            med = np.median(d, axis=1)
            m.pt_desc01[p] = descs[int(np.argmin(med))]
        else:
            m.pt_desc01[p] = descs[0]
        centers = np.stack([m.keyframes[k].center() for k, f in obs])
        dirs = m.pt_xyz[p] - centers
        norms = np.linalg.norm(dirs, axis=1)
        ok = norms > 1e-9
        if ok.any():
            m.pt_normal[p] = (dirs[ok] / norms[ok, None]).mean(0)
            n = np.linalg.norm(m.pt_normal[p])
            if n > 1e-9:
                m.pt_normal[p] /= n
        ref_k, ref_f = obs[-1]
        kf = m.keyframes[ref_k]
        dist = np.linalg.norm(m.pt_xyz[p] - kf.center())
        level = int(kf.level[ref_f])
        m.pt_max_dist[p] = dist * (1.2**level)
        m.pt_min_dist[p] = m.pt_max_dist[p] / (1.2**7)
