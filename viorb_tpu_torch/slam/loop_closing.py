"""Loop closing: BoW detection -> Sim3 verification -> pose-graph
correction (port of viorb_tpu/slam/loop_closing.py; the reference
ORB-SLAM's LoopClosing thread: DetectLoop with consecutive-group
consistency, ComputeSim3 with the Sim3Solver's RANSAC, CorrectLoop with
Sim3 propagation and the essential-graph optimization; the post-loop
global BA is the owning pipeline's `gba_fn`).

It runs inside the mapping job, after keyframe insertion. The map stays
on the host. The owning pipeline holds its map lock (`lock`, an RLock)
from `add_keyframe` to the end of `try_close`, as the reference's mapping
job does: no other thread changes the map between a closure's detection
and its write-back. The loop closer takes the same lock around each
snapshot and write-back of its own, for a caller that does not hold it
(re-entrant under the pipeline's). The device work runs on the calling
thread's stream: the keyframe's BoW through K8 (`bow/descend_cuda.py`),
descriptor matching, the Sim3 RANSAC, its reprojection refine and the
essential graph. The RANSAC draws from a `torch.Generator` seeded 7 on the
loop closer's device, where the reference splits `PRNGKey(7)`.

With `fix_scale` (stereo and RGB-D: their maps are metric, the reference
Sim3Solver's bFixScale) the RANSAC, its refine and the essential graph all
hold s = 1, and the 0.5 < s < 2 gate, which only a free scale needs, is
skipped.

Not copied from the reference as written: its O(K^2) Python loop that
builds the essential graph's edges one `jnp` call at a time, and its Python
loop that moves the map points one at a time. Both are array operations
here, with the same edges in the same order and the same points.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from viorb_tpu_torch.bow import BinaryVocabulary, KeyframeDatabase
from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features.matching import hamming_matrix, match_with_mask, valid_gate
from viorb_tpu_torch.geometry.camera import in_image_mask, project
from viorb_tpu_torch.geometry.sim3 import sim3_compose, sim3_inverse
from viorb_tpu_torch.mapping.map import MapStore
from viorb_tpu_torch.optim.pose_graph import Sim3Graph, optimize_sim3_graph
from viorb_tpu_torch.optim.sim3_refine import optimize_sim3_reproj
from viorb_tpu_torch.solvers.sim3_solver import sim3_ransac

SIM3_CAP = 256  # matched pairs a Sim3 problem holds
CONFIRM_CAP = 1024  # candidate-group points the projection confirm tries
COVIS_EDGE = 30  # covisibility weight of an essential-graph edge
COVIS_GROUP = 15  # covisibility weight of a group member


class LoopCloser:
    def __init__(
        self,
        map_store: MapStore,
        vocab: BinaryVocabulary,
        min_matches: int = 20,
        covis_consistency: int = 3,
        generator: Optional[torch.Generator] = None,
        cam=None,
        min_confirm_matches: int = 40,
        device=None,
        lock=None,
        fix_scale: bool = False,
    ):
        self.map = map_store
        self.vocab = vocab
        self.device = resolve_device(device)
        self.db = KeyframeDatabase(vocab)
        self.min_matches = min_matches
        self.covis_consistency = covis_consistency
        self._consistency: Dict[int, int] = {}  # candidate group member -> consecutive detections
        self.generator = generator if generator is not None else torch.Generator(self.device).manual_seed(7)
        self.loops_closed = 0
        self.cam = cam  # enables the reprojection refine and the projection confirm
        self.min_confirm_matches = min_confirm_matches
        self.lock = lock if lock is not None else threading.RLock()
        self.fix_scale = fix_scale  # s = 1 in every Sim3 of a closure (module docstring)
        # no detection for 10 keyframes after a closure (the reference's
        # mLastLoopKFid + 10 guard)
        self.loop_cooldown = 10
        self.last_loop_kf = -(10**9)
        # post-loop global BA gba_fn(anchor_kf, scale_by_kf) and seam fusion
        # fuse_fn(pt_ids, target_kf, radius) -> fused count, set by the
        # owning pipeline (the reference's RunGlobalBundleAdjustment and
        # SearchAndFuse): the fusion gives the GBA its cross-seam
        # observations, without which it relaxes back to the drifted shape
        self.gba_fn = None
        self.fuse_fn = None

    def _up(self, a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

    def _group(self, kf_id: int, min_weight: int = COVIS_GROUP):
        return [g for g, w in self.map.covisibility_weights(kf_id).items() if w >= min_weight and g in self.map.keyframes]

    # -- bookkeeping ---------------------------------------------------------

    def add_keyframe(self, kf_id: int, desc01: Optional[torch.Tensor] = None, valid: Optional[torch.Tensor] = None):
        """The keyframe's BoW (the batched descent, K8 on the card) into the
        database. `desc01` (N,256) uint8 and `valid` (N,) bool may be given
        on the loop closer's device (the pipeline's keyframe payload);
        otherwise they are uploaded."""
        if desc01 is None:
            with self.lock:
                kf = self.map.keyframes[kf_id]
                desc_np, valid_np = kf.ensure_desc01(), kf.valid.copy()
            desc01, valid = self._up(desc_np, np.uint8), self._up(valid_np)
        _, bow = self.vocab.transform_device(desc01, valid)
        with self.lock:
            kf = self.map.keyframes.get(kf_id)
            if kf is not None:
                kf.bow = bow
                self.db.add(kf_id, bow)

    # -- detection -------------------------------------------------------------

    def detect(self, kf_id: int) -> Optional[int]:
        """A consistent loop-candidate keyframe id, or None (the reference's
        DetectLoop: the minimum score over the covisible neighbours gates the
        candidates, whose covisibility group must persist for
        `covis_consistency` consecutive detections)."""
        with self.lock:
            return self._detect(kf_id)

    def _detect(self, kf_id: int) -> Optional[int]:
        kf = self.map.keyframes.get(kf_id)
        if kf is None or kf.bow is None or kf_id < self.last_loop_kf + self.loop_cooldown:
            return None
        covisible = {k for k, w in self.map.covisibility_weights(kf_id).items() if w >= COVIS_GROUP}
        neigh_scores = [
            BinaryVocabulary.score(kf.bow, self.map.keyframes[k].bow)
            for k in covisible
            if self.map.keyframes[k].bow is not None
        ]
        # neighbours may have no BoW yet (async mapping lag)
        min_score = min(neigh_scores) if neigh_scores else 0.05
        cands = self.db.detect_loop_candidates(kf_id, kf.bow, covisible, max(min_score, 0.01))
        new_consistency: Dict[int, int] = {}
        best = None
        for cand, _score in cands:
            group = {cand} | set(self.map.covisibility_weights(cand))
            cnt = max((self._consistency.get(g, 0) for g in group), default=0) + 1
            for g in group:
                new_consistency[g] = max(new_consistency.get(g, 0), cnt)
            if cnt >= self.covis_consistency and best is None:
                best = cand
        self._consistency = new_consistency
        return best

    # -- Sim3 verification -----------------------------------------------------

    def _sim3_snapshot(self, kf_id: int, cand_id: int) -> Optional[dict]:
        """What the verification reads of the map (under the lock): each
        keyframe's features, their points' world positions, its pose; the
        candidate group's points, their positions and descriptors."""
        kf, cd = self.map.keyframes.get(kf_id), self.map.keyframes.get(cand_id)
        if kf is None or cd is None:
            return None
        snap = {}
        for key, k in (("1", kf), ("2", cd)):
            pidx = k.point_idx.copy()
            snap["has" + key] = (pidx >= 0) & k.valid
            snap["pidx" + key] = pidx
            snap["xyz" + key] = self.map.pt_xyz[np.maximum(pidx, 0)]
            snap["desc" + key] = k.ensure_desc01().copy()
            snap["r" + key], snap["t" + key] = k.r_cw.copy(), k.t_cw.copy()
            snap["xy" + key] = k.xy.copy()
        snap["valid1"] = kf.valid.copy()
        pts = self.map.local_map_points([cand_id] + self._group(cand_id))[:CONFIRM_CAP]
        snap["confirm_xyz"] = self.map.pt_xyz[pts]
        snap["confirm_desc"] = self.map.pt_desc01[pts]
        return snap

    def compute_sim3(self, kf_id: int, cand_id: int):
        """(s12, r12, t12, confirmed matches, (current points, loop points))
        or None: the 3D-3D Sim3 between the two keyframes' matched map
        points in their camera frames (the reference's ComputeSim3), refined
        by two-way reprojection and confirmed by projecting the candidate's
        group through it; on a snapshot of the map."""
        with self.lock:
            snap = self._sim3_snapshot(kf_id, cand_id)
        if snap is None:
            return None
        has1, has2 = snap["has1"], snap["has2"]
        if has1.sum() < self.min_matches or has2.sum() < self.min_matches:
            return None
        d1 = self._up(snap["desc1"], np.float32) * 2 - 1
        d2 = self._up(snap["desc2"], np.float32) * 2 - 1
        res = match_with_mask(hamming_matrix(d1, d2), valid_gate(self._up(has1), self._up(has2)),
                              max_dist=50.0, ratio=0.9, mutual=True)
        idx = res.idx.cpu().numpy()
        m1 = np.nonzero(idx >= 0)[0]
        if len(m1) < self.min_matches:
            return None
        m2 = idx[m1]
        pc1 = snap["xyz1"][m1] @ snap["r1"].T + snap["t1"]
        pc2 = snap["xyz2"][m2] @ snap["r2"].T + snap["t2"]
        nn = min(len(m1), SIM3_CAP)
        p1 = np.zeros((SIM3_CAP, 3), np.float32)
        p2 = np.zeros((SIM3_CAP, 3), np.float32)
        v = np.zeros(SIM3_CAP, bool)
        p1[:nn] = pc1[:nn]
        p2[:nn] = pc2[:nn]
        v[:nn] = True
        p1_d, p2_d, v_d = self._up(p1), self._up(p2), self._up(v)
        out = sim3_ransac(p1_d, p2_d, v_d, self.generator, inlier_th=0.1, min_inliers=self.min_matches,
                          fix_scale=self.fix_scale)
        success, s12, r12, t12, ransac_inl = (x.cpu().numpy() for x in out)
        # mono scale drift within one loop stays far from 2x: an extreme
        # scale is a degenerate fit (coplanar or clustered pairs)
        if not bool(success) or not (self.fix_scale or 0.5 < float(s12) < 2.0):
            return None
        cur_pts = snap["pidx1"][m1[:nn]]
        loop_pts = snap["pidx2"][m2[:nn]]
        if self.cam is None:
            keep = ransac_inl[:nn]
            return float(s12), r12, t12, int(ransac_inl.sum()), (cur_pts[keep], loop_pts[keep])
        # the Sim3 refined by two-way reprojection (the reference's OptimizeSim3)
        uv1 = np.zeros((SIM3_CAP, 2), np.float32)
        uv2 = np.zeros((SIM3_CAP, 2), np.float32)
        uv1[:nn] = snap["xy1"][m1[:nn]]
        uv2[:nn] = snap["xy2"][m2[:nn]]
        refined = optimize_sim3_reproj(out.s, out.r, out.t, p1_d, self._up(uv1), p2_d, self._up(uv2), v_d,
                                       self.cam, fix_scale=self.fix_scale)
        s12, r12, t12, inl = (x.cpu().numpy() for x in refined)
        if int(inl.sum()) < self.min_matches:
            return None
        s12 = float(s12)
        # confirmation: the candidate group's points projected through S12
        # must match >= min_confirm_matches features of the current keyframe
        n_proj = self._confirm_by_projection(snap, s12, r12, t12)
        if n_proj < self.min_confirm_matches:
            return None
        keep = inl[:nn]
        return s12, r12, t12, n_proj, (cur_pts[keep], loop_pts[keep])

    def _confirm_by_projection(self, snap: dict, s12, r12, t12) -> int:
        """Map points of the candidate's covisibility group that project
        (through S12) onto matching features of the current keyframe: the
        mutual best match within 7.5 px, Hamming <= 50, ratio 0.9."""
        if len(snap["confirm_xyz"]) == 0:
            return 0
        x_cand = snap["confirm_xyz"] @ snap["r2"].T + snap["t2"]
        x_cur = (s12 * (x_cand @ r12.T) + t12).astype(np.float32)
        uv = project(self.cam, self._up(x_cur))
        pvalid = self._up(x_cur[:, 2] > 0.05) & in_image_mask(self.cam, uv, margin=1.0)
        d_pts = self._up(snap["confirm_desc"], np.float32) * 2 - 1
        d_kf = self._up(snap["desc1"], np.float32) * 2 - 1
        kf_xy = self._up(snap["xy1"])
        d2 = ((uv[:, None, :] - kf_xy[None, :, :]) ** 2).sum(-1)
        gate = pvalid[:, None] & self._up(snap["valid1"])[None, :] & (d2 <= 7.5**2)
        res = match_with_mask(hamming_matrix(d_pts, d_kf), gate, max_dist=50.0, ratio=0.9, mutual=True)
        n_valid, n_match = (int(x) for x in torch.stack([pvalid.sum(), (res.idx >= 0).sum()]).cpu())
        return 0 if n_valid < 10 else n_match

    # -- correction ------------------------------------------------------------

    def _essential_edges(self, ids, slot):
        """(edge_i, edge_j) slot arrays of the essential graph in the
        reference's order: covisibility edges (weight >= 30; each unordered
        pair once, oriented as first met walking the keyframes in id order),
        then spanning-tree edges parent -> child not already present, then
        consecutive keyframes not already linked."""
        k = len(ids)
        w30 = np.zeros((k, k), bool)
        for a in ids:
            cov = self.map.covisibility_weights(a)
            w30[slot[a], [slot[b] for b, cw in cov.items() if cw >= COVIS_EDGE and b in slot]] = True
        # (a, b) with a walked first is kept unless (b, a) was taken before it
        lower = np.tril(np.ones((k, k), bool), -1)
        cov_e = w30 & ~(lower & w30.T)
        seen = cov_e.copy()
        ei, ej = [list(x) for x in np.nonzero(cov_e)]
        for a in ids:
            p = self.map.keyframes[a].parent_kf
            if p in slot:
                ia, ip = slot[a], slot[p]
                if not seen[ia, ip] and not seen[ip, ia]:
                    seen[ip, ia] = True
                    ei.append(ip)
                    ej.append(ia)
        cons = np.arange(k - 1)
        cons = cons[~seen[cons, cons + 1] & ~seen[cons + 1, cons]]
        return np.concatenate([ei, cons]).astype(np.int64), np.concatenate([ej, cons + 1]).astype(np.int64)

    def correct(self, kf_id: int, cand_id: int, s12, r12, t12, pairs=None):
        """Essential-graph correction (the reference's CorrectLoop): the
        current keyframe's group moved rigidly by the measured correction,
        then a Sim3 graph over every keyframe (essential edges from the
        current relative poses plus the loop edge) optimized with the loop
        side fixed; SE3 poses written back (scale folded into the
        translation), points moved with their reference keyframe's
        correction; the seam merged (the Sim3-verified pairs replaced, the
        loop side's points fused into the current group); then the post-loop
        global BA, anchored at the candidate. The caller holds the map lock
        across (the pipeline's mapping job does), so the map the graph was
        built from is the map it writes back to; the write-back publishes
        with `map.version`."""
        dev = self.device
        with self.lock:
            ids = sorted(self.map.keyframes.keys())
            slot = {k: i for i, k in enumerate(ids)}
            r = np.stack([self.map.keyframes[i].r_cw for i in ids]).astype(np.float32)
            t = np.stack([self.map.keyframes[i].t_cw for i in ids]).astype(np.float32)
            group = {kf_id} | set(self._group(kf_id))
            ei, ej = self._essential_edges(ids, slot)
        k = len(ids)
        s_d, r_d, t_d = torch.ones(k, dtype=torch.float32, device=dev), self._up(r), self._up(t)
        ic, il = slot[kf_id], slot[cand_id]

        # rigid propagation of the measured correction to the current keyframe
        # and its group BEFORE the graph: corrected S_cur = S12 o S_cand, each
        # member keeps its pose relative to the current keyframe
        s12_d = torch.tensor(float(s12), dtype=torch.float32).to(dev)
        s_corr = sim3_compose(s12_d, self._up(r12, np.float32), self._up(t12, np.float32), s_d[il], r_d[il], t_d[il])
        gi = self._up(np.array(sorted(slot[g] for g in group), np.int64))
        inv_cur = sim3_inverse(s_d[ic], r_d[ic], t_d[ic])
        rel = sim3_compose(s_d[gi], r_d[gi], t_d[gi], *(x.expand(len(gi), *x.shape) for x in inv_cur))
        moved = sim3_compose(*rel, *(x.expand(len(gi), *x.shape) for x in s_corr))
        s_init, r_init, t_init = s_d.clone(), r_d.clone(), t_d.clone()
        s_init[gi], r_init[gi], t_init[gi] = moved

        # the essential graph: measured relatives S_ba = S_b * S_a^-1 at the
        # current (pre-correction) poses, plus the loop edge cand -> cur = S12
        ei_d, ej_d = self._up(ei), self._up(ej)
        meas = sim3_compose(s_d[ej_d], r_d[ej_d], t_d[ej_d], *sim3_inverse(s_d[ei_d], r_d[ei_d], t_d[ei_d]))
        graph = Sim3Graph(
            edge_i=torch.cat([ei_d, ei_d.new_full((1,), il)]),
            edge_j=torch.cat([ej_d, ej_d.new_full((1,), ic)]),
            meas_s=torch.cat([meas[0], s12_d[None]]),
            meas_r=torch.cat([meas[1], self._up(r12, np.float32)[None]]),
            meas_t=torch.cat([meas[2], self._up(t12, np.float32)[None]]),
            weight=torch.cat([torch.ones(len(ei), dtype=torch.float32, device=dev),
                              torch.full((1,), 2.0, dtype=torch.float32, device=dev)]),
        )
        fixed = np.zeros(k, bool)
        fixed[il] = True
        s_o, r_o, t_o = (x.cpu().numpy() for x in optimize_sim3_graph(
            s_init, r_init, t_init, graph, self._up(fixed), iters=40, fix_scale=self.fix_scale))

        with self.lock:
            # every active point follows its first-observation keyframe (else
            # its first observer still in the graph): p' = S_new^-1(S_old(p))
            pts = self.map.active_point_ids()
            member = np.zeros(self.map._next_kf + 1, bool)  # id -1 reads the last entry: False
            slot_of = np.full(self.map._next_kf + 1, -1, np.int64)
            member[ids] = True
            slot_of[ids] = np.arange(k)
            ref = self.map.pt_first_kf[pts].astype(np.int64)
            obs_ok = member[self.map.obs_kf[pts]]
            first_obs = self.map.obs_kf[pts][np.arange(len(pts)), np.argmax(obs_ok, axis=1)]
            ok = member[ref]
            keep = ok | obs_ok.any(axis=1)
            pts, ref = pts[keep], np.where(ok, ref, first_obs)[keep]
            i = slot_of[ref]
            x_cam = np.einsum("nij,nj->ni", r[i], self.map.pt_xyz[pts]) + t[i]  # the old poses, s = 1
            self.map.pt_xyz[pts] = np.einsum("nji,nj->ni", r_o[i], (x_cam - t_o[i]) / s_o[i][:, None])

            # SE3 poses: R, t / s
            for kf_key, j in slot.items():
                kf = self.map.keyframes.get(kf_key)
                if kf is not None:
                    kf.r_cw = r_o[j].astype(np.float32)
                    kf.t_cw = (t_o[j] / s_o[j]).astype(np.float32)
            # the local map-scale change of each keyframe (world distances near
            # it multiplied by 1/s): the VI pipeline rescales velocities with it
            scale_by_kf = {kf_key: 1.0 / float(s_o[j]) for kf_key, j in slot.items()}

            # the seam: without it the only cross-seam constraint is the loop
            # edge, and the GBA (which sees observations only) relaxes the map back
            if pairs is not None:
                for pc, pl in zip(*pairs):
                    pc, pl = int(pc), int(pl)
                    if pc >= 0 and pl >= 0 and pc != pl and self.map.pt_active[pc] and self.map.pt_active[pl]:
                        self.map.replace_point(pc, pl)  # the loop (old) side survives
            loop_pts = self.map.local_map_points([cand_id] + self._group(cand_id))
            self.map.version += 1
        if self.fuse_fn is not None:
            for g in sorted(group):
                self.fuse_fn(loop_pts, g, 4.0)
        if self.gba_fn is not None:
            self.gba_fn(cand_id, scale_by_kf)
        self.loops_closed += 1
        self.last_loop_kf = kf_id
        return True

    # -- entry -------------------------------------------------------------------

    def try_close(self, kf_id: int, lap=lambda name: None) -> bool:
        """Detection, verification and correction for a registered keyframe;
        `lap(name)` is called after each stage that ran ("detect", "sim3",
        "loop": the correction)."""
        cand = self.detect(kf_id)
        lap("detect")
        if cand is None:
            return False
        sim = self.compute_sim3(kf_id, cand)
        lap("sim3")
        if sim is None:
            return False
        s12, r12, t12, _n, pairs = sim
        closed = self.correct(kf_id, cand, s12, r12, t12, pairs=pairs)
        lap("loop")
        return closed

    def process(self, kf_id: int) -> bool:
        """The whole loop-closing step for a freshly inserted keyframe."""
        self.add_keyframe(kf_id)
        return self.try_close(kf_id)
