"""The port's VI post-loop GBA (viorb_tpu_torch/slam/mono_vi.py::
MonoViSlam._post_loop_gba) against the JAX reference's, on the reference's
MonoViSlam loop run over the rendered circuit with the biased, noisy
200 Hz IMU (tests/torch_loop_golden.npz, "vi"): the VI checkpoint at the
entry of the post-loop GBA (after `correct`: the corrected poses, the
NavStates not yet re-derived) loaded into the port's MonoViSlam, then
`_post_loop_gba` with the reference's anchor and per-keyframe scale:

  * every chain keyframe's NavState reproduces its camera pose to 1e-4
    (tests/test_e2e_vi_loop.py's contract);
  * NavStates p, v and R and the camera poses within 5e-4 of the
    reference's after the full-chain VI BA (10 + 8 LM iterations over 40
    keyframes; f32 sums in another order, measured 4.4e-5);
  * the tracker re-based: the current NavState is the newest chain
    keyframe's, the frame prior and the last frame's NavState dropped.

No reference pipeline runs here: the golden holds it. One test per file:
see tests/test_torch_fast.py."""

import numpy as np
import torch

from make_torch_goldens import LOOP_GOLDEN, load, load_checkpoint
from viorb_tpu_torch.geometry.camera import PinholeCamera
from viorb_tpu_torch.slam.mono_vi import MonoViSlam

torch.set_num_threads(1)

CAM = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
ATOL = 5e-4
CONSISTENT = 1e-4


def test_vi_post_loop_gba_matches_reference(tmp_path):
    gold = load(LOOP_GOLDEN)
    g = {k[3:]: v for k, v in gold.items() if k.startswith("vi_")}
    path = tmp_path / "gck.npz"
    np.savez(path, **load_checkpoint(gold, "vi_gck_"))
    slam = MonoViSlam(CAM, n_features=800, kf_max_interval=5, vi_init_min_time=2.5, vi_init_min_kfs=8, device="cpu")
    slam.load_map(str(path), localization_only=False)
    assert slam.vi_ready and slam.kf_chain == g["gba_kf_chain"].tolist()
    ids = sorted(slam.map.keyframes)
    assert ids == g["corr_kf_ids"].tolist()
    slam.frame_prior = object()  # stale state the re-base must drop
    slam._post_loop_gba(int(g["corr_anchor"]), dict(zip(ids, g["corr_scale"])))

    assert ids == g["gba_kf_ids"].tolist()
    r = np.stack([slam.map.keyframes[i].r_cw for i in ids])
    t = np.stack([slam.map.keyframes[i].t_cw for i in ids])
    np.testing.assert_allclose(r, g["gba_r_cw"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(t, g["gba_t_cw"], rtol=0, atol=ATOL)
    for i, k in enumerate(ids):
        kf = slam.map.keyframes[k]
        has = bool(kf.nav and "state" in kf.nav)
        assert has == bool(g["gba_nav_has"][i]), k
        if not has:
            continue
        ns = kf.nav["state"]
        for f in ("p", "v", "r"):
            np.testing.assert_allclose(getattr(ns, f), g[f"gba_nav_{f}"][i], rtol=0, atol=ATOL, err_msg=f"{k} {f}")
        if k in slam.kf_chain:
            r_wc = np.asarray(ns.r) @ slam.r_bc
            c_w = np.asarray(ns.p) + np.asarray(ns.r) @ slam.p_bc
            np.testing.assert_allclose(kf.r_cw, r_wc.T, atol=CONSISTENT)
            np.testing.assert_allclose(kf.t_cw, -r_wc.T @ c_w, atol=CONSISTENT)
    last = slam.map.keyframes[slam.kf_chain[-1]].nav["state"]
    np.testing.assert_array_equal(slam.nav_cur.p.numpy(), last.p)
    assert slam.frame_prior is None and slam._nav_last_frame is None and slam.velocity is None
