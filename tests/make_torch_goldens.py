"""Make the goldens the port is held to: `tests/torch_mono_golden.npz`
(lock-step and streaming MonoSlam), `tests/torch_vi_golden.npz`
(lock-step MonoViSlam), `tests/torch_front_golden.npz` (the tracking step
and cores), `tests/torch_optim_golden.npz` (the VI optimizers and init),
`tests/torch_loop_golden.npz` (loop closing),
`tests/torch_stereo_golden.npz` (lock-step StereoSlam and RgbdSlam),
`tests/torch_cli_golden.npz` (the command line over a TUM RGB-D dump) and
`tests/torch_parallel_golden.npz` (the distributed BAs).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_goldens.py [SET ...]           # write
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_goldens.py --check [SET ...]   # recompute, compare

SET is `mono`, `vi`, `front`, `optim`, `loop`, `stereo`, `cli` or `parallel`
(default: all eight). The mono set is described first; the others at
`VI_CONFIGS`, `FRONT_DOC`, `OPTIM_DOC`, `LOOP_DOC`, `STEREO_DOC`, `CLI_DOC`
and `PARALLEL_DOC`.

The JAX package's `MonoSlam` (the reference) runs, lock-step, on the frames
the PORT's renderer makes on the CPU (`viorb_tpu_torch.io.synthetic.
make_sequence(device="cpu")`, f32, the reference's arc and room), in these
configurations:

  * "half": the CPU test's (tests/test_torch_mono.py): the 376x240 camera of
    tests/torch_port_scene.py, 20 frames at dt=0.2 s (the same 4 s of the
    arc as "full_seed*", at half the frame rate: at dt=0.1 whether the
    two-view initialization succeeds on frames 0-1 depends on the RANSAC
    draw, see below; at dt=0.2 both packages initialize on frame 1), 300
    features, a keyframe at least every 5 frames, 1024 local-map slots, 512
    BA landmarks;
  * "full_seed0" ... "full_seed4": chip_smoke.py's: 752x480, 40 frames at
    dt=0.1 s, MonoSlam's defaults (1000 features, local window 10, 4096
    local-map slots, 2048 BA landmarks, a keyframe at least every 10
    frames), the sequence of tests/test_e2e_mono.py, with the reference's
    seeds 0-4. Here the two-view test on frames 0-1 passes or fails by the
    RANSAC draw (in the reference, and in the port, which draws from
    another stream), so the initialization frame is 1 or 2, and the map and
    trajectory that follow depend on the draw too. The card draws other
    hypotheses than the CPU, so chip_smoke.py holds its run to the
    reference's runs that initialized at the same frame, and prints their
    spread among themselves beside its own distance from them. This script
    prints that spread too.

For each it records the per-frame state, tracked count, keyframe and point
counts, the initialization frame, the TUM trajectory, the ATE to the
renderer's ground truth after Sim3 alignment, the configuration and the
commit of the reference package it was made on.

Besides, "half_stream": the reference's streaming mode on the first
STREAM_FRAMES frames of "half", flushed after every frame (`flush_stream`
and `wait_mapping_idle`: zero lag, tests/test_streaming.py's serialized
run) at `streaming_depth=1`. It records per frame the state, the tracked
count, the live keyframe ids (padded with -1) and the live point count,
which tests/test_torch_streaming.py holds the port's flushed streaming run
to with tests/test_streaming.py's tolerances.

Why a golden and not a live run: tests/test_e2e_mono.py already runs the
reference's MonoSlam in the same tier-1 suite (84.5 s alone, mostly XLA
compiles), and that suite is cut at 1470 s; a second live reference run
inside a port test would double the most expensive thing the port's tests
could add. The port's CPU test and chip_smoke.py read the file instead.

The committed file was made on the reference package at commit
a0c2be7cd5f1ac9e81352c80c41efd2127747e3a (its `reference_commit`, the last
commit that touched viorb_tpu/). Re-run after a change to the reference
package, the port's renderer or a configuration below, and commit the file. `--check` recomputes every array
and fails unless each equals the committed one (np.array_equal).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_mono_golden.npz")
STATES = ("NOT_INITIALIZED", "OK", "LOST")

CONFIGS = {
    "half": dict(width=376, height=240, fx=225.0, cx=188.0, cy=120.0, n_frames=20, dt=0.2,
                 n_features=300, local_window=10, max_local_points=1024, max_ba_landmarks=512,
                 kf_max_interval=5, seed=0),
}
FULL = dict(width=752, height=480, fx=450.0, cx=376.0, cy=240.0, n_frames=40, dt=0.1, n_features=1000,
            local_window=10, max_local_points=4096, max_ba_landmarks=2048, kf_max_interval=10)
FULL_SEEDS = (0, 1, 2, 3, 4)
CONFIGS.update({f"full_seed{seed}": dict(FULL, seed=seed) for seed in FULL_SEEDS})
SLAM_KEYS = ("n_features", "local_window", "max_local_points", "max_ba_landmarks", "kf_max_interval", "seed")
STREAM_FRAMES = 10  # tests/test_streaming.py's prefix


def reference_commit() -> str:
    """The last commit that touched the reference package."""
    return subprocess.run(
        ["git", "log", "-1", "--format=%H", "--", "viorb_tpu"],
        cwd=os.path.dirname(HERE), capture_output=True, text=True, check=True,
    ).stdout.strip()


def run_reference(name: str) -> dict:
    from viorb_tpu.eval.ate import ate_rmse
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.slam.mono import MonoSlam as RefMonoSlam
    from viorb_tpu_torch.interop import camera_from_fields
    from viorb_tpu_torch.io import synthetic

    c = CONFIGS[name]
    ref_cam = RefCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq = synthetic.make_sequence(c["n_frames"], cam=camera_from_fields(ref_cam), dt=c["dt"], device="cpu")
    slam = RefMonoSlam(ref_cam, **{k: c[k] for k in SLAM_KEYS})
    rows = []
    for image, ts in zip(seq.images, seq.timestamps):
        info = slam.process_frame(image.numpy(), float(ts))
        rows.append((STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"]))
    rows = np.asarray(rows, np.int64)
    traj = slam.trajectory_tum()
    return {
        "state": rows[:, 0],
        "n_tracked": rows[:, 1],
        "n_kfs": rows[:, 2],
        "n_points": rows[:, 3],
        "init_frame": np.int64(np.argmax(rows[:, 0] == STATES.index("OK"))),
        "traj": traj,
        "ate": np.float64(ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)),
        "config": np.array(sorted(c.items()), dtype=str),
    }


def run_reference_streaming(name: str) -> dict:
    """The reference's zero-lag streaming run on the first STREAM_FRAMES
    frames of configuration `name`."""
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.slam.mono import MonoSlam as RefMonoSlam
    from viorb_tpu_torch.interop import camera_from_fields
    from viorb_tpu_torch.io import synthetic

    c = CONFIGS[name]
    ref_cam = RefCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq = synthetic.make_sequence(c["n_frames"], cam=camera_from_fields(ref_cam), dt=c["dt"], device="cpu")
    slam = RefMonoSlam(ref_cam, streaming=True, streaming_depth=1, **{k: c[k] for k in SLAM_KEYS})
    rows, kf_ids = [], []
    try:
        for image, ts in zip(seq.images[:STREAM_FRAMES], seq.timestamps[:STREAM_FRAMES]):
            slam.process_frame(image.numpy(), float(ts))
            slam.flush_stream()
            slam.wait_mapping_idle()
            rows.append((STATES.index(slam.state), slam.n_tracked, int(slam.map.pt_active.sum())))
            kf_ids.append(sorted(slam.map.keyframes))
    finally:
        slam.shutdown()
    rows = np.asarray(rows, np.int64)
    ids = np.full((len(kf_ids), max(map(len, kf_ids))), -1, np.int64)
    for i, k in enumerate(kf_ids):
        ids[i, : len(k)] = k
    return {"state": rows[:, 0], "n_tracked": rows[:, 1], "n_points": rows[:, 2], "kf_ids": ids}


def make_mono() -> dict:
    out = {"reference_commit": np.array(reference_commit())}
    for name in CONFIGS:
        for k, v in run_reference(name).items():
            out[f"{name}_{k}"] = np.asarray(v)
    for k, v in run_reference_streaming("half").items():
        out[f"half_stream_{k}"] = v
    return out


# ---------------------------------------------------------------------------
# lock-step MonoViSlam (tests/test_torch_mono_vi.py, chip_smoke.py)
# ---------------------------------------------------------------------------

VI_GOLDEN = os.path.join(HERE, "torch_vi_golden.npz")
VI_STATES = ("NOT_INITIALIZED", "OK", "LOST", "IMU_ONLY")
VI_KEYS = ("n_features", "local_window", "max_local_points", "max_ba_landmarks", "kf_max_interval",
           "vi_init_min_time", "vi_init_min_kfs", "imu_capacity", "seed")
# The reference's MonoViSlam, lock-step, on the port's rendered frames (f32)
# and the port's synthetic IMU (200 Hz, equal to the reference's), in:
#   * "vi_half": the CPU test's: the 376x240 camera of
#     tests/torch_port_scene.py, 35 frames at dt=0.2 s (7 s of the arc), 300
#     features, a keyframe at least every 3 frames, VI init after 2.5 s and
#     8 keyframes, 1024 local-map slots, 512 BA landmarks. At this size the
#     reference recovers metric scale only to ~0.86 (its own outcome, which
#     the port is held to);
#   * "vi_full_seed0" ... "vi_full_seed5": tests/test_e2e_vi.py's
#     configuration at full size (752x480, 60 frames at dt=0.1 s, 800
#     features, a keyframe at least every 5 frames, VI init after 2.5 s and
#     8 keyframes, capacity 256) with the reference's RANSAC seeds 0-5:
#     chip_smoke.py replays seed 0's two-view minimal sets on the card and
#     holds its run to that run, and reports the spread of the others.
# Each records per frame the state (VI_STATES), tracked count, keyframe and
# point counts and vi_ready; the first VI frame; the final gravity; the TUM
# trajectory; the metric (SE3) and Sim3 ATE over the whole run and after
# POST_INIT_T s; the scale ratio (trajectory extent over the truth's); and
# each two-view RANSAC call's matches (x1, valid) and minimal sets
# (`two_view{i}_*`). Given the same minimal sets the port reproduces these
# runs (at full size on the CPU: trajectories 1e-5 of the extent apart);
# with draws of its own the outcome spreads as the reference's seeds do.
VI_HALF = dict(width=376, height=240, fx=225.0, cx=188.0, cy=120.0, n_frames=35, dt=0.2, n_features=300,
               local_window=10, max_local_points=1024, max_ba_landmarks=512, kf_max_interval=3,
               vi_init_min_time=2.5, vi_init_min_kfs=8, imu_capacity=256, seed=0)
VI_FULL = dict(width=752, height=480, fx=450.0, cx=376.0, cy=240.0, n_frames=60, dt=0.1, n_features=800,
               local_window=10, max_local_points=4096, max_ba_landmarks=2048, kf_max_interval=5,
               vi_init_min_time=2.5, vi_init_min_kfs=8, imu_capacity=256)
VI_FULL_SEEDS = (0, 1, 2, 3, 4, 5)
VI_CONFIGS = {"vi_half": VI_HALF}
VI_CONFIGS.update({f"vi_full_seed{seed}": dict(VI_FULL, seed=seed) for seed in VI_FULL_SEEDS})
POST_INIT_T = 4.5  # tests/test_e2e_vi.py's post-init split


def vi_inputs(c: dict, device="cpu"):
    """(port camera, port sequence, IMU) of a VI configuration."""
    from viorb_tpu_torch.geometry.camera import PinholeCamera
    from viorb_tpu_torch.io import synthetic

    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq = synthetic.make_sequence(c["n_frames"], cam=cam, dt=c["dt"], device=device)
    return cam, seq, synthetic.make_imu(c["n_frames"], c["dt"], hz=200.0)


def imu_between(imu, t0: float, t1: float):
    """The samples in (t0, t1] as (t, gyro, acc) tuples, process_frame_vi's
    argument."""
    sel = (imu.t > t0) & (imu.t <= t1)
    return [(float(t), g, a) for t, g, a in zip(imu.t[sel], imu.gyro[sel], imu.acc[sel])]


def vi_outcome(rows, traj, gravity, seq) -> dict:
    """The recorded outcome of one VI run (the port's too: chip_smoke.py and
    the CPU test compute it with the same function)."""
    from viorb_tpu_torch.eval.ate import ate_rmse

    rows = np.asarray(rows, np.int64)
    post = traj[:, 0] >= POST_INIT_T
    ate = lambda m, s: np.float64(ate_rmse(traj[m, 0], traj[m, 1:4], seq.timestamps, seq.c_w, with_scale=s))
    every = np.ones(len(traj), bool)
    return {
        "state": rows[:, 0], "n_tracked": rows[:, 1], "n_kfs": rows[:, 2], "n_points": rows[:, 3],
        "vi_ready": rows[:, 4],
        "init_frame": np.int64(np.argmax(rows[:, 4]) if rows[:, 4].any() else -1),
        "gravity": np.asarray(gravity if gravity is not None else np.zeros(3), np.float64),
        "traj": traj,
        "ate_metric": ate(every, False), "ate_sim3": ate(every, True),
        "ate_post_metric": ate(post, False) if post.sum() > 2 else np.float64(np.nan),
        "ate_post_sim3": ate(post, True) if post.sum() > 2 else np.float64(np.nan),
        "scale_ratio": np.float64(np.linalg.norm(np.ptp(traj[:, 1:4], axis=0)) / np.linalg.norm(np.ptp(seq.c_w, axis=0))),
    }


def _two_view_samples(valid, key, n_hypotheses=256):
    """The minimal sets the reference's `two_view_init` draws from `key`
    (viorb_tpu/solvers/two_view.py: one key per hypothesis, the H and the F
    set from the same key): ((n,4), (n,8)) int64."""
    import jax
    import jax.numpy as jnp

    n = valid.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, n_hypotheses)
    draw = lambda m: jax.vmap(lambda k: jax.random.choice(k, n, shape=(m,), replace=False, p=p))(keys)  # noqa: E731
    return np.asarray(draw(4), np.int64), np.asarray(draw(8), np.int64)


def run_reference_vi(name: str) -> dict:
    import viorb_tpu.slam.mono as ref_mono
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.slam.mono_vi import MonoViSlam as RefMonoViSlam

    c = VI_CONFIGS[name]
    cam, seq, imu = vi_inputs(c)
    # the two-view RANSAC's minimal sets, call by call: the card run of
    # chip_smoke.py draws the same hypotheses (two_view_from_samples)
    calls = []
    two_view = ref_mono.two_view_init

    def recording(x1, x2, valid, cam_, key):
        calls.append((np.asarray(x1), np.asarray(valid), *_two_view_samples(valid, key)))
        return two_view(x1, x2, valid, cam_, key)

    ref_mono.two_view_init = recording
    try:
        slam = RefMonoViSlam(RefCamera(**cam._asdict()), **{k: c[k] for k in VI_KEYS})
        rows, prev = [], -np.inf
        for image, ts in zip(seq.images, seq.timestamps):
            info = slam.process_frame_vi(image.numpy(), float(ts), imu_between(imu, prev, ts))
            prev = ts
            rows.append((VI_STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"],
                         int(slam.vi_ready)))
    finally:
        ref_mono.two_view_init = two_view
    out = vi_outcome(rows, slam.trajectory_tum(), slam.gravity, seq)
    out["config"] = np.array(sorted(c.items()), dtype=str)
    out["two_view_calls"] = np.int64(len(calls))
    for i, (x1, valid, idx_h, idx_f) in enumerate(calls):
        out.update({f"two_view{i}_x1": x1, f"two_view{i}_valid": valid, f"two_view{i}_idx_h": idx_h,
                    f"two_view{i}_idx_f": idx_f})
    return out


def make_vi() -> dict:
    """The VI runs, each in a process of its own, all at once."""
    import tempfile

    out = {"reference_commit": np.array(reference_commit())}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen([sys.executable, __file__, "--worker", name, os.path.join(tmp, name + ".npz")])
                 for name in VI_CONFIGS}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"the reference's VI run {name} failed")
            for k, v in load(os.path.join(tmp, name + ".npz")).items():
                out[f"{name}_{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the tracking step and cores (tests/test_torch_tracking.py, tests/test_torch_cores.py)
# ---------------------------------------------------------------------------

FRONT_GOLDEN = os.path.join(HERE, "torch_front_golden.npz")
FRONT_DOC = """The reference's front end on tests/torch_port_scene.py's half-size arc
(uint8 frames, 300 features), what the two tests compared with live JAX runs
before: `track_*`, the 8-level extractor's features of frame 0 and
`make_tracking_step` over frames 1-5 from the true frame-0 pose on the map
lifted from those features; `cores_*`, the 4-level pipeline core's features
of frame 0 (on an empty map), then the pipeline core on frames 1-5 (each
predicted from the reference's previous estimate), on frame 1 yawed by 0.1
rad (the 30 px retry, with the 15 px match count), and the streaming core on
frames 1-5 and a blank frame, with its carries."""
TRACK_FRAMES = 5
CORE_LEVELS = 4
_FEAT_FIELDS = ("xy", "response", "angle", "level", "desc01", "valid")
_CORE_FIELDS = ("xy", "fdesc", "pf", "r", "t", "inlier", "visible")


def _yaw(angle):
    c, s_ = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)


def _core_fields(ref) -> dict:
    """A core output's compared fields as numpy (fdesc as int8 +-1/0)."""
    return dict(xy=np.asarray(ref[1]), fdesc=np.asarray(ref[2], np.float32).astype(np.int8),
                pf=np.asarray(ref[3]), r=np.asarray(ref[4]), t=np.asarray(ref[5]),
                inlier=np.asarray(ref[6]), visible=np.asarray(ref[7]))


def make_front() -> dict:
    import jax.numpy as jnp

    from torch_port_scene import MAP_SLOTS, N_FEATURES, REF_CAM, reference_map, render_scene
    from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
    from viorb_tpu.slam import kernels as ref_kernels
    from viorb_tpu.slam import tracking_loop as ref_loop

    out = {"reference_commit": np.array(reference_commit())}
    _, r_wc, c_w, _, _, frames = render_scene(TRACK_FRAMES + 1)
    img = [jnp.asarray(f.numpy()) for f in frames]
    map_fields = ("xyz", "desc_pm1", "valid", "normal", "dmin", "dmax")

    def ref_map(fields):
        return [jnp.asarray(fields[k], jnp.bfloat16 if k == "desc_pm1" else None) for k in map_fields]

    # the tracking step, 8 levels
    feats = RefExtractor(n_features=N_FEATURES).extract(frames[0].numpy())
    for k, v in zip(_FEAT_FIELDS, feats):
        out[f"track_feats0_{k}"] = np.asarray(v)
    dmap = ref_loop.DeviceMap(*ref_map(reference_map(r_wc[0], c_w[0], frames[0], feats=feats)))
    carry = ref_loop.TrackCarry(*[jnp.asarray(np.asarray(x, np.float32)) for x in (
        r_wc[0].T, -r_wc[0].T @ c_w[0], np.eye(3), np.zeros(3))])
    step = ref_loop.make_tracking_step(REF_CAM, RefExtractor(n_features=N_FEATURES))
    rows = []
    for i in range(1, TRACK_FRAMES + 1):
        carry, o = step(carry, img[i], dmap)
        rows.append((np.asarray(o.r_cw), np.asarray(o.t_cw), int(o.n_inliers)))
    for n, k in enumerate(("r_cw", "t_cw", "n_inliers")):
        out[f"track_{k}"] = np.stack([np.asarray(r[n]) for r in rows])

    # the pipeline and streaming cores, 4 levels
    ext = RefExtractor(n_features=N_FEATURES, n_levels=CORE_LEVELS)
    pipe = ref_loop.make_pipeline_track_core(REF_CAM, ext)
    empty = [jnp.zeros((MAP_SLOTS, 3)), jnp.zeros((MAP_SLOTS, 256), jnp.bfloat16), jnp.zeros(MAP_SLOTS, bool),
             jnp.zeros((MAP_SLOTS, 3)), jnp.zeros(MAP_SLOTS), jnp.ones(MAP_SLOTS)]
    r_pred, t_pred = r_wc[0].T, -r_wc[0].T @ c_w[0]
    feats0 = pipe(img[0], jnp.asarray(r_pred), jnp.asarray(t_pred), *empty)[0]
    for k, v in zip(_FEAT_FIELDS, feats0):
        out[f"cores_feats0_{k}"] = np.asarray(v)
    cmap = ref_map(reference_map(r_wc[0], c_w[0], frames[0], feats=feats0))
    per = []
    for i in range(1, TRACK_FRAMES + 1):
        ref = pipe(img[i], jnp.asarray(r_pred), jnp.asarray(t_pred), *cmap)
        per.append(dict(_core_fields(ref), nmatch=int(ref[8])))
        r_pred, t_pred = np.array(ref[4]), np.array(ref[5])
    for k in per[0]:
        out[f"cores_pipe_{k}"] = np.stack([np.asarray(p[k]) for p in per])
    r_off = _yaw(0.1) @ r_wc[1].T
    t_off = _yaw(0.1) @ (-r_wc[1].T @ c_w[1])
    ref = pipe(img[1], jnp.asarray(r_off), jnp.asarray(t_off), *cmap)
    narrow = ref_kernels.match_by_projection(*cmap, jnp.asarray(r_off), jnp.asarray(t_off), ref[1], ref[2],
                                             ref[0].valid, REF_CAM, jnp.float32(15.0))
    for k, v in dict(_core_fields(ref), nmatch=int(ref[8]), narrow_nmatch=int(narrow[2])).items():
        out[f"cores_retry_{k}"] = np.asarray(v)
    stream = ref_loop.make_streaming_track_core(REF_CAM, ext)
    carry = ref_loop.TrackCarry(*[jnp.asarray(np.asarray(x, np.float32)) for x in (
        r_wc[0].T, -r_wc[0].T @ c_w[0], np.eye(3), np.zeros(3))])
    per = []
    for i in range(1, TRACK_FRAMES + 1):
        carry, ref = stream(carry, img[i], *cmap)
        per.append(dict(_core_fields(ref), ok=bool(ref[8]),
                        **{"carry_" + k: np.asarray(v) for k, v in zip(carry._fields, carry)}))
    for k in per[0]:
        out[f"cores_stream_{k}"] = np.stack([np.asarray(p[k]) for p in per])
    blank = jnp.asarray(np.full(frames[0].shape, 128, np.uint8))
    frozen, ref = stream(carry, blank, *cmap)
    out["cores_blank_ok"] = np.asarray(bool(ref[8]))
    for k, v in zip(frozen._fields, frozen):
        out[f"cores_blank_carry_{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the VI optimizers and the VI init (tests/test_torch_vi_optim.py, tests/test_torch_vi_init.py)
# ---------------------------------------------------------------------------

OPTIM_GOLDEN = os.path.join(HERE, "torch_optim_golden.npz")
OPTIM_DOC = """The reference's IMU preintegration and VI optimizers on
tests/torch_vi_problems.py's seeded problems, whose live compiles take 4-15
s each on a CPU: `imu_*`, `preintegrate` on one segment and
`preintegrate_batch` on four at capacity 256 (one jit); `pose_*`,
`pose_optimization_vi` (2 rounds x 5 iterations, as the VI core runs it)
frame-to-keyframe (`pose_kf_*`) and frame-to-frame with the prior and the
anchor optimized (`pose_ff_*`); `ba_*`, `vi_ba` and `vi_ba_gw` (6 LM
iterations each) with the whole problem's inputs under `*_in_*`; `init_*`,
`try_vi_init` on tests/test_vi_init.py's clean and biased keyframe chains."""
POSE_ROUNDS, POSE_ITERS, BA_ITERS = 2, 5, 6
INIT_FIXTURES = {"clean": dict(scale=2.5),
                 "biased": dict(bias_g=np.array([0.02, -0.015, 0.03]), bias_a=np.array([0.15, -0.1, 0.2]),
                                scale=1.8, n_kf=16)}


def make_optim() -> dict:
    import jax
    import jax.numpy as jnp

    from test_vi_init import build_chain
    from torch_vi_problems import ba_problem, imu_problem, pose_problem
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.imu import ImuBatch, NavState, preintegrate, preintegrate_batch
    from viorb_tpu.optim import ba as rba
    from viorb_tpu.optim.pose_only import PoseObs, ViPosePrior, pose_optimization_vi
    from viorb_tpu.optim.reprojection import Extrinsics
    from viorb_tpu.slam.vi_init import try_vi_init

    cam = RefCamera(fx=225.0, fy=225.0, cx=188.0, cy=120.0, width=376, height=240)
    out = {"reference_commit": np.array(reference_commit())}
    j = jnp.asarray

    ip = imu_problem()
    out.update({f"imu_in_{k}": np.asarray(v) for k, v in ip.items()})

    @jax.jit
    def preint(b, bg, ba, t0, t1):
        first = jax.tree.map(lambda x: x[0], b)
        rest = jax.tree.map(lambda x: x[1:], b)
        return preintegrate(first, bg, ba, t0[0], t1[0]), preintegrate_batch(rest, bg, ba, t0[1:], t1[1:])

    one, many = preint(ImuBatch(j(ip["gyro"]), j(ip["acc"]), j(ip["t"]), j(ip["mask"])), j(ip["bg"]), j(ip["ba"]),
                       j(ip["t0"]), j(ip["t1"]))
    for tag, p_ in (("one", one), ("many", many)):
        for f, x in zip(p_._fields, p_):
            out[f"imu_{tag}_{f}"] = np.asarray(x)

    pp = pose_problem()
    out.update({f"pose_in_{k}": np.asarray(v) for k, v in pp.items()})
    pre = preintegrate(ImuBatch.from_arrays(pp["gyro"], pp["acc"], pp["t"], capacity=256), j(pp["bg"]), j(pp["ba"]),
                       j(pp["t_i"]), j(pp["t_j"]))

    def nav(prefix):
        return NavState(j(pp[prefix + "_p"]), j(pp[prefix + "_v"]), j(pp[prefix + "_r"]), j(pp["bg"]), j(pp["ba"]),
                        j(pp["dbg"]), j(pp["dba"]))

    obs = PoseObs(j(pp["points"]), j(pp["uv"]), j(pp["inv_sigma2"]), j(pp["valid"]))
    ext = Extrinsics(j(pp["r_bc"]), j(pp["p_bc"]))
    for tag, opt in (("kf", False), ("ff", True)):
        prior = ViPosePrior(nav("nsi"), j(pp["prior_info"]), j(True)) if opt else None
        ns_j, ns_i, inl, marg = pose_optimization_vi(
            nav("nsj"), nav("nsi"), obs, cam, ext, pre, j(pp["gravity"]), j(pp["bias_info"]), prior=prior,
            rounds=POSE_ROUNDS, iters_per_round=POSE_ITERS, optimize_i=opt)
        for f, x in zip(NavState._fields, ns_j):
            out[f"pose_{tag}_nsj_{f}"] = np.asarray(x)
        for f, x in zip(NavState._fields, ns_i):
            out[f"pose_{tag}_nsi_{f}"] = np.asarray(x)
        out[f"pose_{tag}_inlier"] = np.asarray(inl)
        out[f"pose_{tag}_marg"] = np.asarray(marg)

    bp = ba_problem()
    out.update({f"ba_in_{k}": np.asarray(v) for k, v in bp.items()})
    pre = preintegrate_batch(ImuBatch(j(bp["gyro"]), j(bp["acc"]), j(bp["t"]), j(bp["mask"])), jnp.zeros(3),
                             jnp.zeros(3), j(bp["t0"]), j(bp["t1"]))
    k = bp["nav_p"].shape[0]
    state = rba.ViBAState(NavState(*[j(bp["nav_" + f]) for f in NavState._fields]), j(bp["points"]))
    bobs = rba.BAObservations(j(bp["kf_idx"].astype(np.int32)), j(bp["uv"]), j(bp["inv_sigma2"]), j(bp["valid"]))
    chain = rba.ImuChain(pre, jnp.ones(k - 1, bool), j(bp["bias_info"]))
    bext = Extrinsics(j(bp["r_bc"]), j(bp["p_bc"]))
    res, chi2 = rba.vi_ba(state, bobs, cam, bext, chain, j(bp["gravity"]), j(bp["fixed"]), iters=BA_ITERS)
    res_gw, g_gw, chi2_gw = rba.vi_ba_gw(state, bobs, cam, bext, chain, j(bp["gravity"]), j(bp["fixed"]),
                                         iters=BA_ITERS)
    for tag, r_, c_ in (("vi", res, chi2), ("gw", res_gw, chi2_gw)):
        for f, x in zip(NavState._fields, r_.nav):
            out[f"ba_{tag}_nav_{f}"] = np.asarray(x)
        out[f"ba_{tag}_points"] = np.asarray(r_.points)
        out[f"ba_{tag}_chi2"] = np.asarray(c_)
    out["ba_gw_gravity"] = np.asarray(g_gw)

    for tag, kw in INIT_FIXTURES.items():
        p_c, r_wc, ts, batches, _ = build_chain(**kw)
        r = try_vi_init(p_c, r_wc, ts, batches)
        out[f"init_{tag}_success"] = np.asarray(r.success)
        for f in ("scale", "gravity_w", "bias_g", "bias_a", "velocities", "condition_number"):
            out[f"init_{tag}_{f}"] = np.asarray(getattr(r, f))
    return out


# ---------------------------------------------------------------------------
# loop closing (tests/test_torch_loop_closing.py, tests/test_torch_vi_loop.py,
# tests/test_torch_sim3.py, chip_smoke.py)
# ---------------------------------------------------------------------------

LOOP_GOLDEN = os.path.join(HERE, "torch_loop_golden.npz")
LOOP_DOC = """The reference's MonoSlam ("mono", tests/test_e2e_loop.py's configuration)
and MonoViSlam ("vi", tests/test_e2e_vi_loop.py's), lock-step with loop
closing, on the port's rendered 100-frame circuit (752x480, dt=0.1 s, pixel
noise 4.0, 800 features, a keyframe at least every 5 frames) with a
vocabulary the reference trains (k=8, depth 3) on the features of every
12th frame (its OrbExtractor, 600 features), the VI run with the biased,
noisy 200 Hz circuit IMU. Each run records, for the FIRST keyframe whose
`try_close` closes a loop:
  * `ckpt_*` (mono only): the map checkpoint (the pipeline's `save_map`) at
    the entry of that `try_close`; `gck_*`: the checkpoint at the entry of
    the post-loop GBA (VI extras included). Both are cut to what the loop
    tests read (`pack_checkpoint`; `load_checkpoint` restores the layout):
    point arrays to the slots in use, descriptors as little-endian packed
    bits under `*desc01@bits`, keypoint angles zeroed; `ckpt_` keeps the
    keypoints and descriptors of the keyframe, the candidate and the
    keyframe's covisibility group (the seam fusion's targets) and every
    point's; `gck_` keeps every keyframe's keypoints and no descriptor,
    BoW, normal or depth range;
  * the keyframe and its candidate, the loop closer's consistency groups
    and `last_loop_kf` at that entry;
  * `ransac_*`: the Sim3 RANSAC's inputs, the reference's 128 minimal sets
    (the index triples `jax.random.choice` drew from its key) and its
    output; `refine_*`: `optimize_sim3_reproj`'s inputs and output;
    `sim3_*`: what `compute_sim3` returned (S12, the confirm count, the
    matched point pairs); `graph_*`: `optimize_sim3_graph`'s inputs and
    output;
  * `corr_*`: the keyframe poses and active points after `correct` (at the
    entry of the post-loop GBA, with its anchor and the per-keyframe scale);
    `gba_*`: the same after the post-loop GBA (VI: every keyframe's
    NavState p, v, r too);
  * `reloc_*`: the host `transform` of that keyframe's descriptors (words)
    and `db.query(bow, max_results=5)` on the database at that entry;
  * the vocabulary, the run's loop count, TUM trajectory and Sim3 ATE, and
    each two-view RANSAC call's matches and minimal sets (`two_view{i}_*`,
    as tests/torch_vi_golden.npz holds them).
Besides, `circle_out_*`: the reference's `optimize_sim3_graph` on
tests/test_bow_posegraph.py's drifted circle (`circle_graph_problem`), the
small problem tests/test_torch_sim3.py holds the port's to."""
LOOP_CONFIG = dict(width=752, height=480, fx=450.0, cx=376.0, cy=240.0, n_frames=100, dt=0.1, kind="circuit",
                   noise_std=4.0, n_features=800, kf_max_interval=5, vocab_every=12, vocab_features=600,
                   vocab_k=8, vocab_depth=3)
LOOP_VI = dict(vi_init_min_time=2.5, vi_init_min_kfs=8)
LOOP_IMU = dict(hz=200.0, kind="circuit", noise_g=0.002, noise_a=0.03,
                bias_g=np.array([0.002, -0.001, 0.0015], np.float32),
                bias_a=np.array([0.03, -0.02, 0.01], np.float32))
LOOP_RUNS = ("mono", "vi")
VOCAB_FIELDS = ("children", "centers", "is_leaf", "word_id", "idf")


PT_FILL = {"pt_first_kf": -1, "obs_kf": -1, "obs_feat": -1}  # a free point slot's values, else 0


def pack_desc(arrays: dict) -> dict:
    """`*desc01` arrays ((...,256) {0,1}) as packed bits under `*desc01@bits`."""
    return {(k + "@bits" if k.endswith("desc01") else k): (np.packbits(v, axis=-1, bitorder="little")
                                                           if k.endswith("desc01") else v)
            for k, v in arrays.items()}


def pack_checkpoint(arrays: dict, keep_kfs=(), for_ba: bool = False) -> dict:
    """A checkpoint's arrays for the golden, cut to what the loop tests read:
    point arrays to the slots in use; keypoint angles zeroed (only tracking
    reads them); descriptors as packed bits, a keyframe's zeroed outside
    `keep_kfs`. `for_ba` (the checkpoint a post-loop GBA starts from): every
    keyframe's keypoints kept, its BoW dropped, the points' descriptors,
    normals and depth range zeroed (a BA reads poses, points and
    observations only)."""
    n = int(arrays["_next_pt"])
    out = {}
    for k, v in arrays.items():
        if k.startswith("pt_") or k.startswith("obs_"):
            v = v[:n]
        if k.startswith("kf") and k[2].isdigit():
            kf, field = int(k[2:k.index("_")]), k[k.index("_") + 1:]
            if field == "angle" or (field == "desc01" and kf not in keep_kfs) or (
                    field == "xy" and not for_ba and kf not in keep_kfs):
                v = np.zeros_like(v)
            if field == "bow" and for_ba:
                continue
        if for_ba and k in ("pt_desc01", "pt_normal", "pt_min_dist", "pt_max_dist"):
            v = np.zeros_like(v)
        out[k] = v
    return pack_desc(out)


def load_checkpoint(data: dict, prefix: str) -> dict:
    """The checkpoint arrays stored under `prefix` in a golden, as `save_map`
    wrote them (descriptors unpacked, point arrays padded back to
    `max_points`)."""
    arrays = {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}
    out = {}
    m = int(arrays["max_points"])
    for k, v in arrays.items():
        if k.endswith("desc01@bits"):
            k, v = k[:-5], np.unpackbits(v, axis=-1, bitorder="little")
        if k.startswith("pt_") or k.startswith("obs_"):
            v = np.concatenate([v, np.full((m - len(v), *v.shape[1:]), PT_FILL.get(k, 0), v.dtype)])
        out[k] = v
    return out


def loop_inputs(device="cpu"):
    """(port camera, the port's rendered noisy circuit, the circuit IMU)."""
    from viorb_tpu_torch.geometry.camera import PinholeCamera
    from viorb_tpu_torch.io import synthetic

    c = LOOP_CONFIG
    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq = synthetic.make_sequence(c["n_frames"], cam=cam, dt=c["dt"], kind=c["kind"], noise_std=c["noise_std"],
                                  device=device)
    return cam, seq, synthetic.make_imu(c["n_frames"], c["dt"], **LOOP_IMU)


def _sim3_samples(valid, key, n_hypotheses=128):
    """The index triples the reference's `sim3_ransac` draws from `key`
    (one split key per hypothesis, `jax.random.choice` without replacement
    weighted by `valid`), computed under `jax.jit` as the solver does."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def draw(valid, key):
        n = valid.shape[0]
        p = valid.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        keys = jax.random.split(key, n_hypotheses)
        return jax.vmap(lambda k: jax.random.choice(k, n, shape=(3,), replace=False, p=p))(keys)

    return np.asarray(draw(jnp.asarray(valid), key), np.int64)


def _poses_points(m) -> dict:
    ids = sorted(m.keyframes)
    pts = np.nonzero(m.pt_active)[0]
    return {"kf_ids": np.asarray(ids, np.int64),
            "r_cw": np.stack([m.keyframes[i].r_cw for i in ids]).astype(np.float32),
            "t_cw": np.stack([m.keyframes[i].t_cw for i in ids]).astype(np.float32),
            "pt_ids": pts.astype(np.int64), "pt_xyz": m.pt_xyz[pts].astype(np.float32)}


def run_reference_loop(name: str) -> dict:
    import tempfile

    import viorb_tpu.optim.sim3_refine as ref_refine
    import viorb_tpu.slam.loop_closing as ref_lc
    import viorb_tpu.slam.mono as ref_mono
    from viorb_tpu.bow import train_vocabulary
    from viorb_tpu.eval.ate import ate_rmse
    from viorb_tpu.features import OrbExtractor as RefExtractor
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.slam.mono import MonoSlam as RefMonoSlam
    from viorb_tpu.slam.mono_vi import MonoViSlam as RefMonoViSlam

    c = LOOP_CONFIG
    cam, seq, imu = loop_inputs()
    ex = RefExtractor(n_features=c["vocab_features"])
    descs = []
    for i in range(0, c["n_frames"], c["vocab_every"]):
        f = ex.extract(seq.images[i].numpy())
        descs.append(np.asarray(f.desc01)[np.asarray(f.valid)])
    vocab = train_vocabulary(np.concatenate(descs), k=c["vocab_k"], depth=c["vocab_depth"])

    rec, cur, two_view_calls = {}, {}, []
    orig = (ref_lc.LoopCloser.try_close, ref_lc.LoopCloser.compute_sim3, ref_lc.sim3_ransac,
            ref_refine.optimize_sim3_reproj, ref_lc.optimize_sim3_graph, ref_mono.two_view_init)
    tmp = tempfile.mkdtemp()

    def group(lc, kf_id):
        return {kf_id} | {g for g, w in lc.map.covisibility_weights(kf_id).items() if w >= 15}

    def checkpoint():
        path = os.path.join(tmp, "ckpt.npz")
        slam.save_map(path)
        return load(path)

    def try_close(self, kf_id):
        if rec:
            return orig[0](self, kf_id)
        cur.clear()
        cur["raw_ckpt"] = checkpoint()
        cur["keep"] = group(self, kf_id)  # the fusion targets
        kf = self.map.keyframes[kf_id]
        words, qbow = self.vocab.transform(kf.ensure_desc01(), kf.valid)
        hits = self.db.query(qbow, max_results=5)
        cur.update({
            "kf": np.int64(kf_id), "last_loop_kf": np.int64(self.last_loop_kf),
            "consistency": np.array(sorted(self._consistency.items()), np.int64).reshape(-1, 2),
            "reloc_words": np.asarray(words, np.int64),
            "reloc_hits": np.array([h[0] for h in hits], np.int64),
            "reloc_scores": np.array([h[1] for h in hits], np.float64),
        })
        closed = orig[0](self, kf_id)
        if closed:
            raw, keep = cur.pop("raw_ckpt"), cur.pop("keep")
            if name == "mono":
                cur.update({f"ckpt_{k}": v for k, v in pack_checkpoint(raw, keep).items()})
            rec.update(cur)
        return closed

    def compute_sim3(self, kf_id, cand_id):
        cur["keep"] |= {cand_id}  # the Sim3 matches the two keyframes
        out = orig[1](self, kf_id, cand_id)
        cur["cand"] = np.int64(cand_id)
        if out is not None:
            s12, r12, t12, n, (cur_pts, loop_pts) = out
            cur.update({"sim3_s": np.float32(s12), "sim3_r": np.asarray(r12, np.float32),
                        "sim3_t": np.asarray(t12, np.float32), "sim3_n": np.int64(n),
                        "sim3_cur_pts": np.asarray(cur_pts, np.int64), "sim3_loop_pts": np.asarray(loop_pts, np.int64)})
        return out

    def sim3_ransac(p1, p2, valid, key, **kw):
        out = orig[2](p1, p2, valid, key, **kw)
        cur.update({"ransac_p1": np.asarray(p1), "ransac_p2": np.asarray(p2), "ransac_valid": np.asarray(valid),
                    "ransac_idx": _sim3_samples(valid, key), "ransac_success": np.asarray(out.success),
                    "ransac_s": np.asarray(out.s), "ransac_r": np.asarray(out.r), "ransac_t": np.asarray(out.t),
                    "ransac_inliers": np.asarray(out.inliers)})
        return out

    def refine(s12, r12, t12, x1, uv1, x2, uv2, valid, cam_, **kw):
        out = orig[3](s12, r12, t12, x1, uv1, x2, uv2, valid, cam_, **kw)
        names = ("s12", "r12", "t12", "x1", "uv1", "x2", "uv2", "valid")
        cur.update({f"refine_{k}": np.asarray(v) for k, v in zip(names, (s12, r12, t12, x1, uv1, x2, uv2, valid))})
        cur.update({f"refine_out_{k}": np.asarray(v) for k, v in zip(("s", "r", "t", "inliers"), out)})
        return out

    def graph_opt(s, r, t, graph, fixed, **kw):
        out = orig[4](s, r, t, graph, fixed, **kw)
        cur.update({"graph_s": np.asarray(s), "graph_r": np.asarray(r), "graph_t": np.asarray(t),
                    "graph_fixed": np.asarray(fixed), "graph_iters": np.int64(kw.get("iters", 20))})
        cur.update({f"graph_{k}": np.asarray(v) for k, v in graph._asdict().items()})
        cur.update({f"graph_out_{k}": np.asarray(v) for k, v in zip(("s", "r", "t"), out)})
        return out

    def two_view(x1, x2, valid, cam_, key):
        two_view_calls.append((np.asarray(x1), np.asarray(valid), *_two_view_samples(valid, key)))
        return orig[5](x1, x2, valid, cam_, key)

    ref_lc.LoopCloser.try_close, ref_lc.LoopCloser.compute_sim3 = try_close, compute_sim3
    ref_lc.sim3_ransac, ref_refine.optimize_sim3_reproj, ref_lc.optimize_sim3_graph = sim3_ransac, refine, graph_opt
    ref_mono.two_view_init = two_view
    try:
        ref_cam = RefCamera(**cam._asdict())
        kw = dict(n_features=c["n_features"], kf_max_interval=c["kf_max_interval"], vocabulary=vocab,
                  enable_loop_closing=True)
        slam = RefMonoViSlam(ref_cam, **kw, **LOOP_VI) if name == "vi" else RefMonoSlam(ref_cam, **kw)
        gba = slam.loop_closer.gba_fn

        def gba_fn(anchor, scale_by_kf):
            if not rec and "corr_kf_ids" not in cur:
                cur.update({f"corr_{k}": v for k, v in _poses_points(slam.map).items()})
                cur.update({f"gck_{k}": v for k, v in pack_checkpoint(checkpoint(), for_ba=True).items()})
                cur["corr_anchor"] = np.int64(anchor)
                cur["corr_scale"] = np.array([scale_by_kf[k] for k in cur["corr_kf_ids"]], np.float64)
                gba(anchor, scale_by_kf)
                cur.update({f"gba_{k}": v for k, v in _poses_points(slam.map).items()})
                if name == "vi":
                    ids = cur["gba_kf_ids"]
                    nav = [slam.map.keyframes[i].nav.get("state") if slam.map.keyframes[i].nav else None
                           for i in ids]
                    has = np.array([n is not None for n in nav])
                    cur["gba_nav_has"] = has
                    for f in ("p", "v", "r"):
                        cur[f"gba_nav_{f}"] = np.stack([np.asarray(getattr(n, f), np.float32) if n is not None
                                                        else np.zeros((3, 3) if f == "r" else 3, np.float32)
                                                        for n in nav])
                    cur["gba_kf_chain"] = np.asarray(slam.kf_chain, np.int64)
                return
            gba(anchor, scale_by_kf)

        slam.loop_closer.gba_fn = gba_fn
        prev = -np.inf
        for image, ts in zip(seq.images, seq.timestamps):
            if name == "vi":
                slam.process_frame_vi(image.numpy(), float(ts), imu_between(imu, prev, ts))
                prev = ts
            else:
                slam.process_frame(image.numpy(), float(ts))
    finally:
        (ref_lc.LoopCloser.try_close, ref_lc.LoopCloser.compute_sim3, ref_lc.sim3_ransac,
         ref_refine.optimize_sim3_reproj, ref_lc.optimize_sim3_graph, ref_mono.two_view_init) = orig
    if not rec:
        raise RuntimeError(f"the reference's {name} loop run closed no loop")
    traj = slam.trajectory_tum()
    out = dict(rec)
    out.update({"vocab_children": vocab.children, "vocab_is_leaf": vocab.is_leaf, "vocab_word_id": vocab.word_id,
                "vocab_idf": vocab.idf,
                "vocab_centers@bits": np.packbits(vocab.centers_pm1 > 0, axis=-1, bitorder="little")})
    out.update({"loops_closed": np.int64(slam.loop_closer.loops_closed), "traj": traj,
                "ate": np.float64(ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=True)),
                "config": np.array(sorted(dict(LOOP_CONFIG, **(LOOP_VI if name == "vi" else {})).items()), dtype=str)})
    # the two-view RANSAC's minimal sets, call by call (chip_smoke.py can
    # replay them: two_view_from_samples)
    out["two_view_calls"] = np.int64(len(two_view_calls))
    for i, (x1, valid, idx_h, idx_f) in enumerate(two_view_calls):
        out.update({f"two_view{i}_x1": x1, f"two_view{i}_valid": valid, f"two_view{i}_idx_h": idx_h,
                    f"two_view{i}_idx_f": idx_f})
    return out


def circle_graph_problem(seed: int = 3, k: int = 12) -> dict:
    """tests/test_bow_posegraph.py's drifted circle at k keyframes, numpy f32:
    the truth (gt_*), the start (s, r, t), exact odometry edges plus the
    closing edge (edge_*, meas_*, weight) and the fixed first keyframe."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(k) / k
    c, s_ = np.cos(ang), np.sin(ang)
    z, o = np.zeros(k), np.ones(k)
    r_wc = np.stack([np.stack([c, -s_, z], -1), np.stack([s_, c, z], -1), np.stack([z, z, o], -1)], -2)
    gt_r = np.swapaxes(r_wc, 1, 2).astype(np.float32)
    gt_t = (-np.einsum("kij,kj->ki", gt_r, 3.0 * np.stack([c, s_, z], -1))).astype(np.float32)
    ei = np.r_[np.arange(k - 1), k - 1].astype(np.int64)
    ej = np.r_[np.arange(1, k), 0].astype(np.int64)
    meas_r = np.einsum("eij,ekj->eik", gt_r[ej], gt_r[ei]).astype(np.float32)
    meas_t = (gt_t[ej] - np.einsum("eij,ej->ei", meas_r, gt_t[ei])).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    return dict(gt_r=gt_r, gt_t=gt_t, s=np.exp(np.linspace(0, 0.15, k)).astype(np.float32), r=gt_r.copy(),
                t=(gt_t + rng.normal(size=(k, 3)) * np.linspace(0, 0.3, k)[:, None]).astype(np.float32),
                edge_i=ei, edge_j=ej, meas_s=np.ones(k, np.float32), meas_r=meas_r, meas_t=meas_t,
                weight=np.ones(k, np.float32), fixed=fixed)


CIRCLE_ITERS = 20


def run_reference_circle() -> dict:
    """The reference's `optimize_sim3_graph` on `circle_graph_problem()`
    (its jit compile alone takes ~10 s on a CPU)."""
    import jax.numpy as jnp
    from viorb_tpu.optim.pose_graph import Sim3Graph, optimize_sim3_graph

    p = circle_graph_problem()
    graph = Sim3Graph(*(jnp.asarray(p[f]) for f in ("edge_i", "edge_j", "meas_s", "meas_r", "meas_t", "weight")))
    out = optimize_sim3_graph(jnp.asarray(p["s"]), jnp.asarray(p["r"]), jnp.asarray(p["t"]), graph,
                              jnp.asarray(p["fixed"]), iters=CIRCLE_ITERS)
    return {f"circle_out_{f}": np.asarray(v) for f, v in zip("srt", out)}


def load_vocab_arrays(data: dict, prefix: str) -> dict:
    """The golden's vocabulary arrays (centers unpacked to (nodes,256) {0,1})."""
    out = {k: data[f"{prefix}vocab_{k}"] for k in VOCAB_FIELDS if k != "centers"}
    out["centers"] = np.unpackbits(data[f"{prefix}vocab_centers@bits"], axis=-1, bitorder="little")
    return out


def make_loop() -> dict:
    """The two loop runs, each in a process of its own, both at once."""
    import tempfile

    out = {"reference_commit": np.array(reference_commit()), **run_reference_circle()}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen([sys.executable, __file__, "--loop-worker", name,
                                         os.path.join(tmp, name + ".npz")]) for name in LOOP_RUNS}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"the reference's loop run {name} failed")
            for k, v in load(os.path.join(tmp, name + ".npz")).items():
                out[f"{name}_{k}"] = v
    return out


STEREO_GOLDEN = os.path.join(HERE, "torch_stereo_golden.npz")
STEREO_DOC = """The reference's StereoSlam ("stereo") and RgbdSlam ("rgbd"), lock-step, on
the port's rendered frames at tests/torch_port_scene.py's half size (the
376x240 camera, the first 14 frames of the arc at dt=0.2 s of "half" above,
f32 frames):
the stereo run on `make_stereo_sequence`'s pair (baseline 0.11 m), the RGB-D
run on `make_sequence(with_depth=True)`'s images and depth, each with 300
features, a keyframe at least every 5 frames, 1024 local-map slots and 512
BA landmarks. Each records per frame the state, tracked count, keyframe and
point counts (and `n_stereo`, the stereo run's matched features), the TUM
trajectory and its metric ATE (SE3 alignment, no scale). Neither pipeline
draws a RANSAC hypothesis while tracking holds, so the port's run is held
to the reference's frame by frame.
Besides, `fix_*`, the reference's fixed-scale Sim3 solvers (`fix_scale=True`)
on the mono loop run's recorded problems in tests/torch_loop_golden.npz:
`fix_ransac_*`, `sim3_ransac` (inlier threshold 0.1, 20 inliers, as the
loop closer calls it) with the key PRNGKey(FIX_KEY) and the 128 minimal
sets it draws; `fix_refine_*`, `optimize_sim3_reproj` from that RANSAC's
result; `fix_circle_*`, `optimize_sim3_graph` on `circle_graph_problem()`
started at unit scales."""
FIX_KEY = 11
STEREO_CONFIG = dict(CONFIGS["half"], n_frames=14, baseline=0.11)
STEREO_RUNS = ("stereo", "rgbd")


def stereo_inputs(name: str, device="cpu"):
    """(port camera, the port's rendered sequence of STEREO_CONFIG, the
    second input of each frame): for "stereo" `make_stereo_sequence`'s
    right images, for "rgbd" `make_sequence(with_depth=True)`'s depth
    images of the same left frames."""
    from viorb_tpu_torch.geometry.camera import PinholeCamera
    from viorb_tpu_torch.io import synthetic

    c = STEREO_CONFIG
    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    if name == "stereo":
        return (cam, *synthetic.make_stereo_sequence(c["n_frames"], cam=cam, dt=c["dt"], baseline=c["baseline"],
                                                     device=device))
    return (cam, *synthetic.make_sequence(c["n_frames"], cam=cam, dt=c["dt"], device=device, with_depth=True))


def run_reference_stereo(name: str) -> dict:
    from viorb_tpu.eval.ate import ate_rmse
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.slam.rgbd import RgbdSlam as RefRgbdSlam
    from viorb_tpu.slam.stereo import StereoSlam as RefStereoSlam

    c = STEREO_CONFIG
    cam, seq, second = stereo_inputs(name)
    ref_cam = RefCamera(**cam._asdict())
    keys = {k: c[k] for k in SLAM_KEYS}
    if name == "stereo":
        slam = RefStereoSlam(ref_cam, baseline=c["baseline"], **keys)
        step = slam.process_frame_stereo
    else:
        slam = RefRgbdSlam(ref_cam, **keys)
        step = slam.process_frame_rgbd
    rows = []
    for image, other, ts in zip(seq.images, second, seq.timestamps):
        info = step(image.numpy(), other.numpy(), float(ts))
        rows.append((STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"],
                     info.get("n_stereo", 0)))
    rows = np.asarray(rows, np.int64)
    traj = slam.trajectory_tum()
    return {
        "state": rows[:, 0], "n_tracked": rows[:, 1], "n_kfs": rows[:, 2], "n_points": rows[:, 3],
        "n_stereo": rows[:, 4], "traj": traj,
        "ate": np.float64(ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)),
        "config": np.array(sorted(c.items()), dtype=str),
    }


def run_reference_fix_scale() -> dict:
    """The reference's fixed-scale Sim3 RANSAC, refine and essential graph
    (STEREO_DOC's `fix_*`)."""
    import jax
    import jax.numpy as jnp
    from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
    from viorb_tpu.optim.pose_graph import Sim3Graph, optimize_sim3_graph
    from viorb_tpu.optim.sim3_refine import optimize_sim3_reproj
    from viorb_tpu.solvers.sim3_solver import sim3_ransac

    g = load(LOOP_GOLDEN)
    c = LOOP_CONFIG
    cam = RefCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    key = jax.random.PRNGKey(FIX_KEY)
    p1, p2, valid = (jnp.asarray(g[f"mono_ransac_{k}"]) for k in ("p1", "p2", "valid"))
    rs = sim3_ransac(p1, p2, valid, key, inlier_th=0.1, min_inliers=20, fix_scale=True)
    out = {"fix_ransac_idx": _sim3_samples(g["mono_ransac_valid"], key)}
    out.update({f"fix_ransac_{k}": np.asarray(v) for k, v in rs._asdict().items()})
    names = ("x1", "uv1", "x2", "uv2", "valid")
    ref = optimize_sim3_reproj(rs.s, rs.r, rs.t, *(jnp.asarray(g["mono_refine_" + k]) for k in names), cam,
                               fix_scale=True)
    out.update({f"fix_refine_{k}": np.asarray(v) for k, v in zip(("s", "r", "t", "inliers"), ref)})
    p = circle_graph_problem()
    graph = Sim3Graph(*(jnp.asarray(p[f]) for f in ("edge_i", "edge_j", "meas_s", "meas_r", "meas_t", "weight")))
    circ = optimize_sim3_graph(jnp.ones_like(jnp.asarray(p["s"])), jnp.asarray(p["r"]), jnp.asarray(p["t"]), graph,
                               jnp.asarray(p["fixed"]), iters=CIRCLE_ITERS, fix_scale=True)
    out.update({f"fix_circle_{f}": np.asarray(v) for f, v in zip("srt", circ)})
    return out


def make_stereo() -> dict:
    out = {"reference_commit": np.array(reference_commit())}
    for name in STEREO_RUNS:
        for k, v in run_reference_stereo(name).items():
            out[f"{name}_{k}"] = np.asarray(v)
    out.update(run_reference_fix_scale())
    return out


CLI_GOLDEN = os.path.join(HERE, "torch_cli_golden.npz")
CLI_DOC = """The reference's command line (`viorb_tpu.run.main`) over a TUM RGB-D dump
at tests/torch_port_scene.py's half size: the first CLI_CONFIG["n_frames"]
frames of the arc of "half" above (the 376x240 camera, dt=0.2 s) rendered
on the CPU by the PORT's renderer with their depth images, the images
rounded to uint8 and the depth to uint16 at TUM's 5000 units a metre, and
written by the port's `io/png.py` as rgb/*.png and depth/*.png with an
associations.txt and a settings file (300 features, DepthMapFactor 5000)
(`write_cli_dump`); then `--dataset tum --rgbd`. It records the trajectory
file the run writes, its metric ATE (SE3) to the renderer's truth, and the
SHA-256 of the dump's uint8 and uint16 arrays: tests/test_torch_run_cli.py
writes its own dump the same way and checks the digest first, so both
packages' runs read the same integers."""
CLI_CONFIG = dict(CONFIGS["half"], n_frames=8, depth_factor=5000.0)


def cli_settings() -> str:
    """The dump's settings file (the reference's YAML schema)."""
    c = CLI_CONFIG
    return ("%YAML:1.0\n"
            f"Camera.fx: {c['fx']}\nCamera.fy: {c['fx']}\nCamera.cx: {c['cx']}\nCamera.cy: {c['cy']}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.width: {c['width']}\nCamera.height: {c['height']}\n"
            "Camera.fps: 5.0\nCamera.RGB: 0\n"
            f"DepthMapFactor: {c['depth_factor']}\nORBextractor.nFeatures: {c['n_features']}\n")


def write_cli_dump(root: str) -> dict:
    """CLI_DOC's TUM RGB-D dump under `root` (rgb/, depth/,
    associations.txt, settings.yaml); returns the sequence, the uint8 images,
    the uint16 depth images and their SHA-256 digest."""
    import hashlib

    from viorb_tpu_torch.geometry.camera import PinholeCamera
    from viorb_tpu_torch.io import synthetic
    from viorb_tpu_torch.io.png import write_png

    c = CLI_CONFIG
    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq, depths = synthetic.make_sequence(c["n_frames"], cam=cam, dt=c["dt"], device="cpu", with_depth=True)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    images = [synthetic.to_uint8(im).numpy() for im in seq.images]
    depth16 = [np.clip(np.round(d.numpy() * c["depth_factor"]), 0, 65535).astype(np.uint16) for d in depths]
    digest = hashlib.sha256()
    lines = []
    for i, (img, dep, ts) in enumerate(zip(images, depth16, seq.timestamps)):
        write_png(os.path.join(root, f"rgb/{i:04d}.png"), img)
        write_png(os.path.join(root, f"depth/{i:04d}.png"), dep)
        digest.update(img.tobytes())
        digest.update(dep.tobytes())
        lines.append(f"{ts:.6f} rgb/{i:04d}.png {ts:.6f} depth/{i:04d}.png")
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write(cli_settings())
    return {"seq": seq, "images": images, "depth16": depth16, "digest": digest.hexdigest()}


def cli_argv(root: str, out: str) -> list:
    """The command line both packages' runs take over the dump."""
    return ["--dataset", "tum", "--rgbd", "--path", root, "--config", os.path.join(root, "settings.yaml"),
            "--out", out]


def make_cli() -> dict:
    import tempfile

    from viorb_tpu import run
    from viorb_tpu.eval.ate import ate_rmse

    with tempfile.TemporaryDirectory() as tmp:
        dump = write_cli_dump(tmp)
        out = os.path.join(tmp, "traj.txt")
        run.main(cli_argv(tmp, out))
        traj = np.loadtxt(out)
    seq = dump["seq"]
    return {
        "reference_commit": np.array(reference_commit()),
        "traj": traj,
        "ate": np.float64(ate_rmse(traj[:, 0], traj[:, 1:4], seq.timestamps, seq.c_w, with_scale=False)),
        "digest": np.array(dump["digest"]),
        "config": np.array(sorted(CLI_CONFIG.items()), dtype=str),
    }


PARALLEL_GOLDEN = os.path.join(HERE, "torch_parallel_golden.npz")
PARALLEL_DOC = """The reference's landmark-sharded BAs on an 8-device virtual CPU mesh
(`distributed_vision_ba`, `distributed_vi_ba`) and its single-device
`vision_ba` / `vi_ba`, at tests/test_distributed_ba.py's two problems, built
as that test builds them (its `rng` fixture: default_rng(42) for each): the
vision problem ("vision_*": 6 keyframes, 256 landmarks, every landmark seen
by every keyframe, 0.3 px noise, perturbed poses and points, keyframe 0
fixed, 10 iterations) and the VI problem ("vi_*": 6 NavStates on
tests/test_ba.py's simulated arc, 128 landmarks, its preintegrated chain,
the same noise, 10 iterations). Each holds its inputs and both solves'
outputs. The mesh needs XLA's 8 host devices, set before JAX starts, so the
runs go in a process of their own (`--parallel-worker`)."""


def run_reference_parallel() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    sys.path.insert(0, HERE)
    from test_ba import _simulate_vi_trajectory, make_world
    from test_distributed_ba import CAM, _problem

    from viorb_tpu.geometry.camera import project
    from viorb_tpu.geometry.so3 import exp_so3
    from viorb_tpu.imu import ImuNoise, NavState
    from viorb_tpu.optim import BAObservations, Extrinsics, ImuChain, ViBAState, VisionBAState, vi_ba, vision_ba
    from viorb_tpu.parallel import distributed_vi_ba, distributed_vision_ba, shard_observations

    assert len(jax.devices()) == 8, jax.devices()
    mesh = Mesh(np.array(jax.devices()), ("lm",))
    out = {"reference_commit": np.array(reference_commit())}

    def obs_arrays(prefix, obs):
        for f in ("kf_idx", "uv", "inv_sigma2", "valid"):
            out[f"{prefix}_{f}"] = np.asarray(getattr(obs, f))

    # the vision problem (test_distributed_matches_single)
    rng = np.random.default_rng(42)
    k, m = 6, 256
    pts, Rs, ts, obs = _problem(rng, k, m)
    R0, t0 = Rs.copy(), ts.copy()
    for i in range(1, k):
        R0[i] = np.asarray(exp_so3(jnp.asarray(rng.normal(size=3) * 0.01))) @ Rs[i]
        t0[i] = ts[i] + rng.normal(size=3).astype(np.float32) * 0.05
    p0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    state = VisionBAState(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(p0))
    fixed = jnp.zeros(k, bool).at[0].set(True)
    out_s, chi2_s = vision_ba(state, obs, CAM, fixed, iters=10)
    obs_d = shard_observations(obs, mesh)
    state_d = VisionBAState(state.r_cw, state.t_cw, jax.device_put(state.points, obs_d.uv.sharding))
    out_d, chi2_d = distributed_vision_ba(state_d, obs_d, CAM, fixed, mesh, iters=10)
    out.update(vision_r0=np.asarray(R0, np.float32), vision_t0=np.asarray(t0, np.float32),
               vision_p0=np.asarray(p0, np.float32), vision_fixed=np.asarray(fixed))
    obs_arrays("vision", obs)
    for tag, o, c in (("single", out_s, chi2_s), ("dist", out_d, chi2_d)):
        out[f"vision_{tag}_r_cw"], out[f"vision_{tag}_t_cw"] = np.asarray(o.r_cw), np.asarray(o.t_cw)
        out[f"vision_{tag}_points"], out[f"vision_{tag}_chi2"] = np.asarray(o.points), np.asarray(c)

    # the VI problem (test_distributed_vi_matches_single)
    rng = np.random.default_rng(42)
    navs, pres, g_w = _simulate_vi_trajectory(k)
    m = 128
    pts = make_world(rng, m, depth=(5.0, 12.0))
    ext = Extrinsics.identity()
    uvs = []
    for p, v, R in navs:
        uv = np.asarray(project(CAM, jnp.asarray((pts - p) @ R))).copy()
        uv += rng.normal(size=uv.shape) * 0.3
        uvs.append(uv.astype(np.float32))
    obs = BAObservations(kf_idx=jnp.asarray(np.tile(np.arange(k, dtype=np.int32), (m, 1))),
                         uv=jnp.asarray(np.stack(uvs, 1)), inv_sigma2=jnp.ones((m, k)), valid=jnp.ones((m, k), bool))
    ps, vs, Rs = (np.stack([n[i] for n in navs]) for i in range(3))
    z = np.zeros((k, 3), np.float32)
    ps_n = ps + rng.normal(size=ps.shape).astype(np.float32) * 0.05
    vs_n = vs + rng.normal(size=vs.shape).astype(np.float32) * 0.1
    ps_n[0], vs_n[0] = ps[0], vs[0]
    nav0 = NavState(*(jnp.asarray(x) for x in (ps_n, vs_n, Rs, z, z, z, z)))
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    chain = ImuChain(
        pre=jax.tree.map(lambda *xs: jnp.stack(xs), *pres), valid=jnp.ones(k - 1, bool),
        bias_cov_inv_diag=jnp.concatenate([jnp.full(3, 1.0 / ImuNoise().gyro_bias_rw_var),
                                           jnp.full(3, 1.0 / ImuNoise().acc_bias_rw_var)]) * 0.005)
    state = ViBAState(nav0, jnp.asarray(pts0))
    out_s, chi2_s = vi_ba(state, obs, CAM, ext, chain, jnp.asarray(g_w), fixed, iters=10)
    obs_d = shard_observations(obs, mesh)
    state_d = ViBAState(nav0, jax.device_put(state.points, obs_d.uv.sharding))
    out_d, chi2_d = distributed_vi_ba(state_d, obs_d, CAM, ext, chain, jnp.asarray(g_w), fixed, mesh, iters=10)
    obs_arrays("vi", obs)
    for f in NavState._fields:
        out[f"vi_nav0_{f}"] = np.asarray(getattr(nav0, f))
    for f in chain.pre._fields:
        out[f"vi_pre_{f}"] = np.asarray(getattr(chain.pre, f))
    out.update(vi_points0=np.asarray(pts0, np.float32), vi_bias_info=np.asarray(chain.bias_cov_inv_diag),
               vi_gravity=np.asarray(g_w, np.float32), vi_fixed=np.asarray(fixed))
    for tag, o, c in (("single", out_s, chi2_s), ("dist", out_d, chi2_d)):
        for f in ("p", "v", "r"):
            out[f"vi_{tag}_{f}"] = np.asarray(getattr(o.nav, f))
        out[f"vi_{tag}_chi2"] = np.asarray(c)
    return out


def make_parallel() -> dict:
    import tempfile

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(HERE),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "parallel.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel-worker", path], env=env, check=True,
                       timeout=900)
        return load(path)


SETS = {"mono": (GOLDEN, lambda: make_mono()), "vi": (VI_GOLDEN, lambda: make_vi()),
        "front": (FRONT_GOLDEN, lambda: make_front()), "optim": (OPTIM_GOLDEN, lambda: make_optim()),
        "loop": (LOOP_GOLDEN, lambda: make_loop()), "stereo": (STEREO_GOLDEN, lambda: make_stereo()),
        "cli": (CLI_GOLDEN, lambda: make_cli()), "parallel": (PARALLEL_GOLDEN, lambda: make_parallel())}


def spread(data: dict) -> list:
    """Lines on the reference's own spread over the full-width seeds, per
    initialization frame: trajectories apart (RMS after Sim3, as a share of
    the second's extent) and the ATE range."""
    from viorb_tpu_torch.eval.ate import associate, umeyama_alignment

    def apart(a, b):
        ia, ib = associate(a[:, 0], b[:, 0])
        s, r, t = umeyama_alignment(a[ia, 1:4], b[ib, 1:4], with_scale=True)
        err = b[ib, 1:4] - (s * a[ia, 1:4] @ r.T + t)
        return float(np.sqrt((err**2).sum(1).mean()) / np.linalg.norm(b[:, 1:4] - b[0, 1:4], axis=1).max())

    lines = []
    for init in sorted({int(data[f"full_seed{s}_init_frame"]) for s in FULL_SEEDS}):
        seeds = [s for s in FULL_SEEDS if int(data[f"full_seed{s}_init_frame"]) == init]
        d = [apart(data[f"full_seed{a}_traj"], data[f"full_seed{b}_traj"]) for a in seeds for b in seeds if a != b]
        ates = [float(data[f"full_seed{s}_ate"]) for s in seeds]
        lines.append(f"full width, init at frame {init}: seeds {seeds}, trajectories "
                     f"{min(d, default=0) * 100:.3f}-{max(d, default=0) * 100:.3f} % of the extent apart, "
                     f"ATE {min(ates):.4f}-{max(ates):.4f} m ({max(ates) / min(ates):.2f}x)")
    return lines


def load(path: str = GOLDEN) -> dict:
    """The golden as {key: array}."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def main(argv) -> int:
    if argv[:1] == ["--worker"]:  # one VI run, in a process of its own (make_vi)
        np.savez_compressed(argv[2], **run_reference_vi(argv[1]))
        return 0
    if argv[:1] == ["--loop-worker"]:  # one loop run, in a process of its own (make_loop)
        np.savez_compressed(argv[2], **run_reference_loop(argv[1]))
        return 0
    if argv[:1] == ["--parallel-worker"]:  # the mesh runs, in a process of their own (make_parallel)
        np.savez_compressed(argv[1], **run_reference_parallel())
        return 0
    check = "--check" in argv
    names = [a for a in argv if a != "--check"] or list(SETS)
    bad_sets = []
    for name in names:
        path, make = SETS[name]
        data = make()
        if check:
            want = load(path)
            bad = sorted(k for k in set(data) | set(want)
                         if k not in data or k not in want or not np.array_equal(data[k], want[k], equal_nan=data[k].dtype.kind == "f"))
            print(f"{name}: golden reproduced: every array equal" if not bad else f"{name}: golden differs at {bad}")
            bad_sets += [name] if bad else []
            data = want
        else:
            np.savez_compressed(path, **data)
            print(f"wrote {path} (reference package at {data['reference_commit']})")
        if name == "mono":
            print("\n".join(spread(data)))
            for cfg in CONFIGS:
                print(f"{cfg}: init frame {int(data[cfg + '_init_frame'])}, "
                      f"{int(data[cfg + '_n_kfs'][-1])} keyframes, {int(data[cfg + '_n_points'][-1])} points, "
                      f"ATE {float(data[cfg + '_ate']):.4f} m")
        if name == "loop":
            for run in LOOP_RUNS:
                print(f"{run}: first loop at keyframe {int(data[run + '_kf'])} -> {int(data[run + '_cand'])}, "
                      f"{int(data[run + '_loops_closed'])} loops, S12 scale {float(data[run + '_sim3_s']):.4f}, "
                      f"confirm {int(data[run + '_sim3_n'])}, ATE {float(data[run + '_ate']):.4f} m")
        if name == "stereo":
            for run in STEREO_RUNS:
                print(f"{run}: {int((data[run + '_state'] == 1).sum())} frames OK, "
                      f"{int(data[run + '_n_kfs'][-1])} keyframes, {int(data[run + '_n_points'][-1])} points, "
                      f"metric ATE {float(data[run + '_ate']):.4f} m")
        if name == "cli":
            print(f"cli: {len(data['traj'])} trajectory rows, metric ATE {float(data['ate']):.4f} m, "
                  f"dump digest {data['digest']}")
        if name == "parallel":
            for run in ("vision", "vi"):
                key = "r_cw" if run == "vision" else "p"
                d = np.abs(data[f"{run}_dist_{key}"] - data[f"{run}_single_{key}"]).max()
                print(f"{run}: distributed vs single-device {key} {d:.2e}, RMS "
                      f"{np.sqrt(data[run + '_dist_chi2'].mean()):.4f} / {np.sqrt(data[run + '_single_chi2'].mean()):.4f}")
        if name == "vi":
            for cfg in VI_CONFIGS:
                print(f"{cfg}: VI init at frame {int(data[cfg + '_init_frame'])}, "
                      f"{int(data[cfg + '_n_kfs'][-1])} keyframes, metric ATE {float(data[cfg + '_ate_metric']):.4f} m, "
                      f"post-init {float(data[cfg + '_ate_post_metric']):.4f} / {float(data[cfg + '_ate_post_sim3']):.4f} m, "
                      f"scale {float(data[cfg + '_scale_ratio']):.4f}")
    return 1 if bad_sets else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
