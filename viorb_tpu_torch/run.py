"""CLI runner: dataset replay through the SLAM pipeline (port of
viorb_tpu/run.py: the same flags, checks, messages and outputs).

Counterpart of the reference's example mains (reference:
Examples/Monocular/mono_{tum,euroc,kitti}.cc, Examples/RGB-D/rgbd_tum.cc and
the VI rosbag replay in Examples/ROS/ORB_VIO/src/ros_vio.cc, with its
lock-step and drop-when-behind stream modes). Prints per-frame timing
statistics at exit like the reference mains
(Examples/Monocular/mono_euroc.cc:98-125).

The pipeline runs on the card unless `--device` names another torch
device: without a CUDA device and without `--device cpu` the run stops
with RuntimeError before it loads anything. Synthetic sequences are
rendered on that device; dataset images are read on the host as f32 (PNG
through `io/png.py`, no matplotlib or PIL). Differences from the JAX
package's runner:
  * `--device`;
  * with `--stream`, the frames are processed on the main thread and fed
    from a thread of their own (`io/stream.py`'s docstring);
  * `--stream lockstep` processes every frame of a sequence of any length:
    its feeder waits for room in the synchronizer's image queue, where the
    JAX package's drops all but the last 64 frames once it runs ahead;
  * a TUM RGB-D run whose settings give no `DepthMapFactor` (or with no
    `--config`) reads depth with TUM's factor, 5000; the JAX package's
    default factor, 1.0, never fell back to it;
  * `main` stops the pipeline's threads at the end and returns the SLAM
    object.

Usage:
  python -m viorb_tpu_torch --dataset synthetic --frames 60 --out traj.txt
  python -m viorb_tpu_torch --dataset tum --path <seq_dir> --config cfg.yaml
  python -m viorb_tpu_torch --dataset euroc --path <seq_dir> --config cfg.yaml --vi
  python -m viorb_tpu_torch --dataset kitti --path <seq_dir> --config cfg.yaml --stereo
  python -m viorb_tpu_torch ... --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

TUM_DEPTH_FACTOR = 5000.0  # TUM RGB-D's 16-bit depth PNGs: 5000 units a metre


def main(argv=None):
    ap = argparse.ArgumentParser(description="viorb_tpu_torch SLAM runner")
    ap.add_argument("--dataset", choices=["synthetic", "tum", "euroc", "kitti"],
                    default="synthetic")
    ap.add_argument("--path", help="dataset sequence directory")
    ap.add_argument("--config", help="settings YAML (reference schema)")
    ap.add_argument("--vi", action="store_true", help="visual-inertial mode")
    ap.add_argument("--stereo", action="store_true", help="stereo mode")
    ap.add_argument("--rgbd", action="store_true",
                    help="RGB-D mode (TUM associations / synthetic depth; "
                         "reference Examples/RGB-D/rgbd_tum.cc)")
    ap.add_argument("--associations", default=None, metavar="TXT",
                    help="TUM RGB-D associations file "
                         "(default <path>/associations.txt)")
    ap.add_argument("--baseline", type=float, default=0.11,
                    help="stereo baseline (m) when the config has no Camera.bf")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--out-kf", default=None)
    ap.add_argument("--out-kitti", default=None)
    ap.add_argument("--n-features", type=int, default=None)
    ap.add_argument("--init-log-dir", default=None,
                    help="dump VI-init convergence series here (like the "
                         "reference's tmp/*.txt; plot with eval.plot_init)")
    ap.add_argument("--viz-dir", default=None,
                    help="headless viewer: dump annotated frame + map PNGs "
                         "here (reference Viewer/FrameDrawer/MapDrawer)")
    ap.add_argument("--viz-every", type=int, default=10,
                    help="dump a frame overlay every N frames")
    ap.add_argument("--stream", choices=["direct", "lockstep", "realtime"],
                    default="direct",
                    help="VI ingestion: direct in-loop calls, or through "
                         "MsgSynchronizer queues in lockstep (every frame, "
                         "reference ros_vio.cc) or realtime (drop stale "
                         "frames when behind, ros_vio_realtime.cc)")
    ap.add_argument("--replay-speed", type=float, default=0.0,
                    help="stream replay pacing: 1.0 = wall-clock realtime, "
                         "0 = as fast as possible")
    ap.add_argument("--save-map", default=None, metavar="NPZ",
                    help="checkpoint the final map to this .npz")
    ap.add_argument("--load-map", default=None, metavar="NPZ",
                    help="resume from a map checkpoint (relocalizes into "
                         "it on the first frame)")
    ap.add_argument("--localization-only", action="store_true",
                    help="track against the (loaded) map without mapping "
                         "(reference ActivateLocalizationMode)")
    ap.add_argument("--streaming", action="store_true",
                    help="latency-hiding tracking: device-resident pose "
                         "carry + collector thread with batched pulls "
                         "(mono/stereo-less modes; keyframe decisions lag "
                         "by up to --streaming-depth frames)")
    ap.add_argument("--streaming-depth", type=int, default=2)
    ap.add_argument("--vocab", default=None, metavar="NPZ",
                    help="BoW vocabulary npz; default: the bundled "
                         "assets/vocab.npz (reference: stock ORBvoc + "
                         "tools/bin_vocabulary.cc)")
    ap.add_argument("--loop-closing", action="store_true",
                    help="enable BoW loop detection + closure + GBA")
    ap.add_argument("--device", default=None,
                    help="torch device of the pipeline (default: the CUDA "
                         "card; raises without one); 'cpu' runs the plain "
                         "versions of every kernel on the CPU")
    args = ap.parse_args(argv)
    if args.dataset != "synthetic" and not args.path:
        ap.error(f"--dataset {args.dataset} requires --path <sequence dir>")
    if args.localization_only and not args.load_map:
        ap.error("--localization-only requires --load-map")
    if args.rgbd and (args.vi or args.stereo):
        ap.error("--rgbd is mutually exclusive with --vi/--stereo")
    if args.rgbd and args.dataset not in ("synthetic", "tum"):
        ap.error("--rgbd supports --dataset tum or synthetic "
                 "(the reference ships rgbd_tum only)")

    from viorb_tpu_torch.device import resolve_device
    from viorb_tpu_torch.io.config import SlamConfig

    device = resolve_device(args.device)
    if args.config:
        cfg = SlamConfig.from_yaml(args.config)
    else:
        from viorb_tpu_torch.geometry.camera import PinholeCamera

        cfg = SlamConfig(camera=PinholeCamera(
            fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480
        ))
    n_features = args.n_features or cfg.n_features

    # frame source
    imu_stream = None
    right_paths = None
    right_images = None
    depth_paths = None
    depth_images = None
    if args.dataset == "synthetic":
        from viorb_tpu_torch.io.synthetic import make_imu, make_sequence, make_stereo_sequence

        if args.stereo:
            seq, right_images = make_stereo_sequence(
                n_frames=args.frames, dt=0.1, baseline=args.baseline, device=device
            )
        elif args.rgbd:
            seq, depth_images = make_sequence(
                n_frames=args.frames, dt=0.1, with_depth=True, device=device
            )
        else:
            seq = make_sequence(n_frames=args.frames, dt=0.1, device=device)
        frames = list(zip(seq.timestamps.tolist(), seq.images))
        cfg.camera = seq.cam
        if args.vi:
            imu = make_imu(args.frames, 0.1)
            imu_stream = (imu.t, imu.gyro, imu.acc)
    elif args.dataset == "tum":
        from viorb_tpu_torch.io.datasets import load_tum_mono, load_tum_rgbd

        if args.rgbd:
            assoc = args.associations or os.path.join(args.path, "associations.txt")
            left, depth_paths = load_tum_rgbd(args.path, assoc)
            frames = list(left)
        else:
            frames = list(load_tum_mono(args.path))
    elif args.dataset == "euroc":
        from viorb_tpu_torch.io.datasets import load_euroc_imu, load_euroc_mono, load_euroc_stereo

        if args.stereo:
            left, right_paths = load_euroc_stereo(args.path)
            frames = list(left)
        else:
            frames = list(load_euroc_mono(args.path))
        if args.vi:
            t, g, a = load_euroc_imu(args.path)
            if cfg.multiply_g:
                a = a * 9.80665
            imu_stream = (t, g, a)
    else:
        from viorb_tpu_torch.io.datasets import load_kitti_mono, load_kitti_stereo

        if args.stereo:
            left, right_paths = load_kitti_stereo(args.path)
            frames = list(left)
        else:
            frames = list(load_kitti_mono(args.path))

    # vocabulary: explicit file, else the bundled asset when a consumer
    # (loop closing, map-resume relocalization) needs one
    vocab = None
    if args.vocab:
        from viorb_tpu_torch.bow import BinaryVocabulary

        vocab = BinaryVocabulary.load(args.vocab)
    elif args.loop_closing or args.load_map:
        from viorb_tpu_torch.bow import default_vocabulary

        vocab = default_vocabulary()
    vkw = dict(vocabulary=vocab, enable_loop_closing=args.loop_closing, device=device)

    # system
    if args.vi:
        from viorb_tpu_torch.slam.mono_vi import MonoViSlam

        slam = MonoViSlam(
            cfg.camera,
            r_bc=cfg.r_bc,
            p_bc=cfg.p_bc,
            n_features=n_features,
            local_window=cfg.local_window,
            vi_init_min_time=min(cfg.vins_init_time, 3.0),
            **vkw,
        )
        if args.init_log_dir:
            slam.init_log_dir = args.init_log_dir
    elif args.stereo:
        from viorb_tpu_torch.slam.stereo import StereoSlam

        baseline = (cfg.bf / cfg.camera.fx) if cfg.bf > 0 else args.baseline
        slam = StereoSlam(
            cfg.camera,
            baseline=baseline,
            depth_factor=cfg.depth_th_factor,
            n_features=n_features,
            local_window=cfg.local_window,
            **vkw,
        )
    elif args.rgbd:
        from viorb_tpu_torch.slam.rgbd import RgbdSlam

        slam = RgbdSlam(cfg.camera, n_features=n_features, local_window=cfg.local_window, **vkw)
    else:
        from viorb_tpu_torch.slam.mono import MonoSlam

        slam = MonoSlam(
            cfg.camera, n_features=n_features, local_window=cfg.local_window,
            streaming=args.streaming, streaming_depth=args.streaming_depth,
            **vkw,
        )
    try:
        _replay(args, cfg, slam, frames, imu_stream, right_paths, right_images, depth_paths, depth_images)
    finally:
        slam.shutdown()
    return slam


def _replay(args, cfg, slam, frames, imu_stream, right_paths, right_images, depth_paths, depth_images):
    """Every frame through `slam`, then `_finish`."""
    if args.load_map:
        slam.load_map(args.load_map, localization_only=args.localization_only)
        print(
            f"resumed from {args.load_map}: {len(slam.map.kf_ids())} keyframes, "
            f"{int(slam.map.pt_active.sum())} points"
            + (" (localization-only)" if args.localization_only else ""),
            file=sys.stderr,
        )

    viewer = None
    if args.viz_dir:
        from viorb_tpu_torch.viz import Viewer

        viewer = Viewer(args.viz_dir, every=args.viz_every)

    use_vi_stream = args.vi and imu_stream is not None
    if args.stream != "direct" and not args.stereo and not args.rgbd:
        # queue-fed replay through MsgSynchronizer (reference ros_vio
        # lock-step / ros_vio_realtime drop-when-behind; vision-only
        # nodes are the same loop with an images-only synchronizer). The
        # frames are processed here, on the thread that built the pipeline,
        # and fed from another (io/stream.py)
        from viorb_tpu_torch.io.stream import MsgSynchronizer, RealtimeRunner

        sync = MsgSynchronizer(
            image_delay=cfg.image_delay_to_imu if use_vi_stream else 0.0,
            with_imu=use_vi_stream,
        )
        times = []

        def proc(ts_, img_, samples):
            t0 = time.perf_counter()
            if use_vi_stream:
                info = slam.process_frame_vi(
                    img_, float(ts_),
                    [(float(t_), g_, a_) for t_, g_, a_ in samples],
                )
            else:
                info = slam.process_frame(img_, float(ts_))
            times.append(time.perf_counter() - t0)
            if viewer is not None:
                info["ts"] = float(ts_)
                viewer.on_frame(slam, img_, info)
            return info

        runner = RealtimeRunner(
            sync, proc,
            mode="realtime" if args.stream == "realtime" else "lockstep",
        )
        stop = threading.Event()  # the runner has returned: feed no more
        feeder = threading.Thread(
            target=_feed, name="viorb-stream-feeder", daemon=True,
            args=(sync, frames, imu_stream if use_vi_stream else None, cfg.image_delay_to_imu,
                  args.replay_speed, args.stream == "lockstep", stop),
        )
        feeder.start()
        try:
            n_done = runner.run()
        finally:
            stop.set()
            feeder.join()
        print(
            f"stream mode {args.stream}: processed {n_done}/{len(frames)} "
            f"frames, dropped {sync.n_dropped_images}",
            file=sys.stderr,
        )
        _finish(args, slam, viewer, times, frames)
        return

    times = []
    prev_t = -np.inf
    for i, (ts, img) in enumerate(frames):
        t0 = time.perf_counter()
        if args.vi and imu_stream is not None:
            it, ig, ia = imu_stream
            sel = (it > prev_t) & (it <= ts + cfg.image_delay_to_imu)
            samples = [
                (float(t_), g_, a_) for t_, g_, a_ in zip(it[sel], ig[sel], ia[sel])
            ]
            info = slam.process_frame_vi(img, float(ts), samples)
        elif args.stereo:
            if right_images is not None:
                img_r = right_images[i]
            else:
                from viorb_tpu_torch.io.datasets import _load_gray

                img_r = _load_gray(right_paths[i])
            info = slam.process_frame_stereo(img, img_r, float(ts))
        elif args.rgbd:
            if depth_images is not None:
                dep = depth_images[i]
            else:
                from viorb_tpu_torch.io.datasets import load_depth

                dep = load_depth(depth_paths[i], cfg.depth_map_factor or TUM_DEPTH_FACTOR)
            info = slam.process_frame_rgbd(img, dep, float(ts))
        else:
            info = slam.process_frame(img, float(ts))
        times.append(time.perf_counter() - t0)
        prev_t = ts
        if viewer is not None:
            info["ts"] = float(ts)
            viewer.on_frame(slam, img, info)
        if i % 20 == 0:
            print(
                f"[{i}/{len(frames)}] {info['state']} tracked={info['n_tracked']} "
                f"kfs={info['n_kfs']} points={info['n_points']}",
                file=sys.stderr,
            )

    _finish(args, slam, viewer, times, frames)


def _feed(sync, frames, imu_stream, image_delay, replay_speed, lockstep, stop):
    """Push `frames` (and the IMU samples up to each frame's stamp plus
    `image_delay`) into `sync`, paced at `replay_speed` (0: at once), then
    close it. In lock-step the feeder waits for room in the image queue
    before each frame, so that every frame is processed (the JAX package's
    replay does not, and drops all but the last `max_images` of a long
    sequence). Stops early once `stop` is set."""
    prev = None
    k = 0
    for ts_, img_ in frames:
        if stop.is_set():
            break
        if imu_stream is not None:
            it, ig, ia = imu_stream
            while k < len(it) and it[k] <= ts_ + image_delay:
                sync.add_imu(float(it[k]), ig[k], ia[k])
                k += 1
        if replay_speed > 0 and prev is not None:
            stop.wait(max(0.0, (ts_ - prev) / replay_speed))
        if lockstep:
            sync.wait_for_room(stop)
        sync.add_image(float(ts_), img_)
        prev = ts_
    sync.close()


def _finish(args, slam, viewer, times, frames):
    slam.wait_mapping_idle()
    from viorb_tpu_torch.io.trajectory import (
        save_keyframe_trajectory_navstate,
        save_keyframe_trajectory_tum,
        save_trajectory_kitti,
        save_trajectory_tum,
    )

    # per-frame stats like the reference mains
    ts_sorted = np.sort(times) if times else np.array([0.0])
    print(
        f"frames: {len(frames)}  median track time: {np.median(ts_sorted)*1000:.1f} ms  "
        f"mean: {np.mean(ts_sorted)*1000:.1f} ms",
        file=sys.stderr,
    )
    if viewer is not None:
        viewer.finalize(slam)
    save_trajectory_tum(slam, args.out)
    print(f"trajectory saved to {args.out}", file=sys.stderr)
    if args.out_kf:
        if args.vi:
            save_keyframe_trajectory_navstate(slam, args.out_kf)
        else:
            save_keyframe_trajectory_tum(slam, args.out_kf)
    if args.out_kitti:
        save_trajectory_kitti(slam, args.out_kitti)
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map checkpoint saved to {args.save_map}", file=sys.stderr)


if __name__ == "__main__":
    main()
