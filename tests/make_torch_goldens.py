"""Make the goldens the port's lock-step MonoSlam is held to:
`tests/torch_mono_golden.npz`.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_goldens.py           # write
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_goldens.py --check   # recompute, compare

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


def make() -> dict:
    out = {"reference_commit": np.array(reference_commit())}
    for name in CONFIGS:
        for k, v in run_reference(name).items():
            out[f"{name}_{k}"] = np.asarray(v)
    for k, v in run_reference_streaming("half").items():
        out[f"half_stream_{k}"] = v
    return out


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
    data = make()
    if "--check" in argv:
        want = load()
        bad = sorted(k for k in set(data) | set(want)
                     if k not in data or k not in want or not np.array_equal(data[k], want[k]))
        print("golden reproduced: every array equal" if not bad else f"golden differs at {bad}")
        print("\n".join(spread(want)))
        return 1 if bad else 0
    np.savez_compressed(GOLDEN, **data)
    print("\n".join(spread(data)))
    for name in CONFIGS:
        print(f"{name}: init frame {int(data[name + '_init_frame'])}, "
              f"{int(data[name + '_n_kfs'][-1])} keyframes, {int(data[name + '_n_points'][-1])} points, "
              f"ATE {float(data[name + '_ate']):.4f} m")
    print(f"wrote {GOLDEN} (reference package at {data['reference_commit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
