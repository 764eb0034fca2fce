"""The port's lock-step RgbdSlam on the CPU against the JAX reference's run
on the same frames: the port's rendered arc at half size with its depth
images (`make_sequence(with_depth=True)`, tests/make_torch_goldens.py's
STEREO_CONFIG), the reference's outcome a committed golden
(tests/torch_stereo_golden.npz). The run covers the single-frame depth
initialization, the steady state through the pipeline core, the depth
sampled at each new keyframe's features and the points made from it, and
the mapping jobs (the BA stays monocular, as in the reference). The
tolerances are tests/test_torch_stereo.py's (`n_stereo` is 0 throughout);
today the per-frame counts are equal and the positions ~1e-3 m apart. Then
the depth sample at a keyframe's features is the same from an array and
from a tensor, the entry point defaults to the card and raises without
one, and `streaming=True` means async mapping (tests/test_torch_stereo.py
says why).

One test per file: see tests/test_torch_fast.py."""

import numpy as np
import pytest
import torch

from make_torch_goldens import SLAM_KEYS, STATES, STEREO_CONFIG, STEREO_GOLDEN, load, stereo_inputs
from test_torch_stereo import held_to_golden
from viorb_tpu_torch.slam.rgbd import RgbdSlam

torch.set_num_threads(1)


def test_rgbd_slam_matches_reference():
    c = STEREO_CONFIG
    cam, seq, depths = stereo_inputs("rgbd")
    slam = RgbdSlam(cam, device="cpu", **{k: c[k] for k in SLAM_KEYS})
    assert slam.bf is None and slam.loop_fix_scale
    rows = []
    for image, depth, ts in zip(seq.images, depths, seq.timestamps):
        info = slam.process_frame_rgbd(image, depth, float(ts))
        rows.append([STATES.index(info["state"]), info["n_tracked"], info["n_kfs"], info["n_points"], 0])
    held_to_golden("rgbd", rows, slam.trajectory_tum(), seq, load(STEREO_GOLDEN))
    assert set(slam.ba_eager_calls) == {"local"}, slam.ba_eager_calls

    z = slam._sample_depth(depths[-1], slam.last_frame)
    np.testing.assert_array_equal(z, slam._sample_depth(depths[-1].numpy(), slam.last_frame))
    assert (z > 0).mean() > 0.9, (z > 0).mean()

    for kw in ({"streaming": True}, {"async_mapping": True}):
        threaded = RgbdSlam(cam, device="cpu", **kw)
        assert threaded.async_mapping and not threaded.streaming and threaded._worker is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RgbdSlam(cam)
