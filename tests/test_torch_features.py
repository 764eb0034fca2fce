"""The port's ORB extractor against the JAX reference: the test pattern and
bank table, the pyramid, the patch stages and a whole 752x480 rendered
frame. Pyramid levels >= 1 and the patch blur sum in another order than
XLA does, so they are held to a tolerance; keypoints and descriptors to
agreement rates.

One test per file: see tests/test_torch_fast.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from viorb_tpu.features import orb as ref_orb
from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
from viorb_tpu.features.pyramid import build_pyramid as ref_build_pyramid
from viorb_tpu.geometry.camera import PinholeCamera as RefCamera
from viorb_tpu_torch.features import orb
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.features.pyramid import build_pyramid, linear_weight_mat
from viorb_tpu_torch.interop import camera_from_fields
from viorb_tpu_torch.io import synthetic

torch.set_num_threads(1)


def _test_pattern_and_bank_offsets_equal_reference():
    np.testing.assert_array_equal(orb.TEST_PATTERN, ref_orb.TEST_PATTERN)
    # the reference's one-hot selector column b*512+i is 1 at the offset
    # the port's table holds at [b, i]
    sel = ref_orb._BANK_SELECTOR_NP
    assert (sel.sum(axis=0) == 1).all()
    ref_offsets = sel.argmax(axis=0).reshape(orb.N_BANKS, 2 * orb.N_TESTS)
    np.testing.assert_array_equal(orb.BANK_OFFSETS, ref_offsets)


def _resize_weights_equal_jax(n_in, n_out):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    # jax.image.resize builds them inside its jitted program
    ref = jax.jit(
        lambda: compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, False)
    )()
    np.testing.assert_array_equal(linear_weight_mat(n_in, n_out).numpy(), np.asarray(ref))


def _pyramid_agrees_with_reference():
    img = np.random.default_rng(3).integers(0, 256, (480, 752)).astype(np.float32)
    ref = jax.jit(ref_build_pyramid)(jnp.asarray(img))
    out = build_pyramid(torch.from_numpy(img))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    for lvl in range(1, 8):
        # same weights, matmul partial sums in another order: <= 1e-4 abs
        # on 0..255 pixels (measured max 4.6e-5)
        np.testing.assert_allclose(out[lvl].numpy(), np.asarray(ref[lvl]), rtol=0, atol=1e-4)


def _patch_stages_agree_with_reference():
    rng = np.random.default_rng(5)
    k = 64
    padded = rng.integers(0, 256, (120, 150)).astype(np.float32)
    ys = rng.integers(0, 120 - orb.PATCH_SIZE, k)
    xs = rng.integers(0, 150 - orb.PATCH_SIZE, k)
    ref_p = ref_orb.gather_patches(jnp.asarray(padded), jnp.asarray(ys), jnp.asarray(xs))
    p = orb.gather_patches(torch.from_numpy(padded), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))  # a copy: exact

    ref_ang = np.asarray(ref_orb.patch_moments(ref_p))
    ang = orb.patch_moments(p).numpy()
    np.testing.assert_allclose(ang, ref_ang, rtol=0, atol=1e-5)  # f32 sums of ~1e5

    ref_blur = np.asarray(ref_orb.blur_patches(ref_p))
    blur = orb.blur_patches(p).numpy()
    np.testing.assert_allclose(blur, ref_blur, rtol=0, atol=1e-3)  # 7-tap f32 sums

    # same blurred patches and angles in: the gather reproduces the
    # one-hot selector exactly, bf16 rounding included
    ref_desc = np.asarray(ref_orb.patch_descriptors(jnp.asarray(blur), jnp.asarray(ang)))
    desc = orb.patch_descriptors(torch.from_numpy(blur), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(desc, ref_desc)


def _full_frame_extraction_agrees_with_reference():
    """A rendered 752x480 uint8 frame through both extractors
    (n_features=1000, 8 levels): level-0 keypoints identical; all-level
    (x, y, level) agreement >= 98 %; descriptor bits >= 99 % over the
    shared keypoints (measured: 100 % and 100 %)."""
    ref_cam = RefCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
    cam = camera_from_fields(ref_cam)
    r_wc, c_w = synthetic.make_trajectory(1, dt=0.1)
    planes = synthetic.stack_planes(synthetic.default_room(0), device="cpu")
    frame = synthetic.to_uint8(synthetic.render_frame(cam, r_wc[0], c_w[0], planes))

    ref = RefExtractor(n_features=1000).extract(frame.numpy())
    out = OrbExtractor(n_features=1000).extract(frame, device="cpu")

    def keyed(xy, level, valid):
        return {
            (round(float(x), 3), round(float(y), 3), int(l)): i
            for i, ((x, y), l, v) in enumerate(zip(xy, level, valid))
            if v
        }

    ref_k = keyed(np.asarray(ref.xy), np.asarray(ref.level), np.asarray(ref.valid))
    out_k = keyed(out.xy.numpy(), out.level.numpy(), out.valid.numpy())
    assert {k for k in out_k if k[2] == 0} == {k for k in ref_k if k[2] == 0}
    shared = sorted(set(ref_k) & set(out_k))
    agreement = len(shared) / max(len(ref_k), len(out_k))
    assert agreement >= 0.98, agreement
    ref_bits = np.asarray(ref.desc01)[[ref_k[k] for k in shared]]
    out_bits = out.desc01.numpy()[[out_k[k] for k in shared]]
    bit_agreement = (ref_bits == out_bits).mean()
    assert bit_agreement >= 0.99, bit_agreement


def test_extractor_matches_reference():
    _test_pattern_and_bank_offsets_equal_reference()
    for n_in, n_out in [(480, 400), (752, 627), (161, 134), (96, 80)]:
        _resize_weights_equal_jax(n_in, n_out)
    _pyramid_agrees_with_reference()
    _patch_stages_agree_with_reference()
    _full_frame_extraction_agrees_with_reference()
