"""The port's stereo front end against the JAX reference, on the port's
rendered rectified pair (frame 0 of the 0.11 m stereo arc at half size,
376x240, 300 features a side; tests/make_torch_goldens.py's STEREO_CONFIG):

  * `match_stereo` on the same keypoints and descriptors: equal, match for
    match (the gates are exact comparisons, the Hamming distances small
    integers);
  * `refine_stereo_subpixel`, the plain version of K9, on those matches
    plus keypoints on each image border and unmatched ur0 = -1 rows: every
    matched ur within 1e-3 px of the reference's, except where the
    reference's two smallest SADs lie within f32 rounding of each other
    (a relative gap under 1e-5: the port sums each SAD in one fixed order,
    XLA in its own); the agreement rate is printed (1.0 today). The
    dispatch StereoSlam calls (`slam/stereo.py::refine_subpixel`) runs the
    plain version on CPU tensors, and K9's module stays unimported;
  * `depth_at` equal to the reference's at the left keypoints, the rendered
    depth image equal to it at the pixels within f32 rounding (1e-5 m
    relative), `depth_mask` equal.

K9 itself is held to the plain version bit for bit on the card by
chip_smoke.py. One test per file: see tests/test_torch_fast.py."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from make_torch_goldens import STEREO_CONFIG
from viorb_tpu.geometry.camera import depth_mask as ref_depth_mask
from viorb_tpu.io import synthetic as ref_synthetic
from viorb_tpu.slam.kernels import match_stereo as ref_match_stereo
from viorb_tpu.slam.kernels import refine_stereo_subpixel as ref_refine
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera, depth_mask, undistort_points
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.kernels import match_stereo, refine_stereo_subpixel, subpixel_windows
from viorb_tpu_torch.slam.stereo import DEPTH_MIN, refine_subpixel

torch.set_num_threads(1)

UR_ATOL = 1e-3
TIE_REL = 1e-5
MIN_DISP = 0.5


def _border_cases(xy, ur, matched, w, h):
    """The frame's matches plus 40 rows at the image borders and 8
    unmatched ur0 = -1 rows (4 flagged as matched: the kernel must still
    read the pad)."""
    k = 10
    bx = np.stack([np.r_[np.zeros(k), np.full(k, w - 1.0), np.linspace(0, w - 1, 2 * k)],
                   np.r_[np.linspace(0, h - 1, 2 * k), np.zeros(k), np.full(k, h - 1.0)]], 1)
    b_ur = np.clip(bx[:, 0] - 4.0, 0, None)
    xy = np.concatenate([xy, bx, np.tile([[100.0, 60.0]], (8, 1))]).astype(np.float32)
    ur = np.concatenate([ur, b_ur, np.full(8, -1.0)]).astype(np.float32)
    matched = np.concatenate([matched, np.ones(4 * k, bool), np.r_[np.ones(4, bool), np.zeros(4, bool)]])
    return xy, ur, matched


def test_stereo_front_end_matches_reference():
    c = STEREO_CONFIG
    cam = PinholeCamera(fx=c["fx"], fy=c["fx"], cx=c["cx"], cy=c["cy"], width=c["width"], height=c["height"])
    seq, right = synthetic.make_stereo_sequence(1, cam=cam, dt=c["dt"], baseline=c["baseline"], device="cpu")
    img_l, img_r = seq.images[0], right[0]
    ex = OrbExtractor(n_features=c["n_features"])
    fl, fr = ex.extract(img_l, device="cpu"), ex.extract(img_r, device="cpu")
    xy_l, xy_r = undistort_points(cam, fl.xy), undistort_points(cam, fr.xy)
    max_disp = cam.fx * c["baseline"] / DEPTH_MIN

    # row matching: equal
    ur, matched = match_stereo(xy_l, fl.descriptors_pm1(), fl.valid, fl.level, xy_r, fr.descriptors_pm1(), fr.valid,
                               fr.level, MIN_DISP, max_disp)
    j = jnp.asarray
    ref_ur, ref_matched = jax.jit(ref_match_stereo)(
        j(xy_l.numpy()), j(fl.descriptors_pm1().numpy(), jnp.bfloat16), j(fl.valid.numpy()), j(fl.level.numpy()),
        j(xy_r.numpy()), j(fr.descriptors_pm1().numpy(), jnp.bfloat16), j(fr.valid.numpy()), j(fr.level.numpy()),
        jnp.float32(MIN_DISP), jnp.float32(max_disp))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(ref_matched))
    np.testing.assert_array_equal(ur.numpy(), np.asarray(ref_ur))
    n_matched = int(matched.sum())
    assert n_matched > 100, n_matched

    # sub-pixel refinement: the plain version against the reference's
    xy, ur0, flags = _border_cases(xy_l.numpy(), ur.numpy(), matched.numpy(), cam.width, cam.height)
    args = (img_l, img_r, torch.from_numpy(xy), torch.from_numpy(ur0), torch.from_numpy(flags))
    got = refine_stereo_subpixel(*args).numpy()
    want = np.asarray(ref_refine(*(j(a.numpy()) for a in args)))
    np.testing.assert_array_equal(got[~flags], -1.0)
    np.testing.assert_array_equal(want[~flags], -1.0)
    off = flags & (np.abs(got - want) > UR_ATOL)
    if off.any():  # only near-ties of the two smallest SADs may differ
        patch, strip = (t.double() for t in subpixel_windows(*args[:4]))
        sads = torch.stack([(patch - strip[:, :, d : d + 11]).abs().sum((1, 2)) for d in range(7)], 1).numpy()
        two = np.sort(sads[off], axis=1)[:, :2]
        assert ((two[:, 1] - two[:, 0]) <= TIE_REL * two[:, 1]).all(), (np.nonzero(off)[0], two)
    print(f"sub-pixel ur: {1 - off.sum() / flags.sum():.4f} of {int(flags.sum())} matched rows within {UR_ATOL} px "
          f"of the reference's (max |d| {np.abs(got - want)[flags].max():.2e} px)")
    assert np.abs(got - ur0)[flags & (ur0 >= 0)].max() <= 3.5  # a refinement stays within its search
    # on CPU tensors the dispatch is the plain version, and imports no kernel module
    assert torch.equal(refine_subpixel(*args), torch.from_numpy(got))
    assert "viorb_tpu_torch.slam.stereo_cuda" not in sys.modules

    # ground-truth depth, the rendered depth image and the depth mask
    room, ref_room = synthetic.default_room(0), ref_synthetic.default_room(0)
    pix = xy_l.numpy()[fl.valid.numpy()]
    z = synthetic.depth_at(cam, seq.r_wc[0], seq.c_w[0], room, pix)
    np.testing.assert_array_equal(z, ref_synthetic.depth_at(cam, seq.r_wc[0], seq.c_w[0], ref_room, pix))
    _, dimg = synthetic.render_frame(cam, seq.r_wc[0], seq.c_w[0], synthetic.stack_planes(room, device="cpu"),
                                     with_depth=True)
    ij = np.round(pix).astype(np.int64)
    ok = np.isfinite(z)
    np.testing.assert_allclose(dimg.numpy()[ij[:, 1], ij[:, 0]][ok],
                               synthetic.depth_at(cam, seq.r_wc[0], seq.c_w[0], room, ij.astype(np.float32))[ok],
                               rtol=1e-5)
    pc = np.random.default_rng(0).normal(0.0, 1.0, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(depth_mask(torch.from_numpy(pc)).numpy(), np.asarray(ref_depth_mask(j(pc))))
