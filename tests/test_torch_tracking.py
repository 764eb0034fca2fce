"""The port's tracking step against the JAX reference's, frame by frame,
from the same state: a 240x376 rendered arc (camera scaled by 1/2), 300
features, a 1024-slot map lifted from frame 0 with ground-truth depth, and
5 tracked frames. Also the port's renderer, its map builder, and the rule
that the port never imports JAX.

One test per file: see tests/test_torch_fast.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from torch_port_scene import MAP_SLOTS, N_FEATURES, REF_CAM, reference_map, render_scene
from viorb_tpu.features.extractor import OrbExtractor as RefExtractor
from viorb_tpu.io import synthetic as ref_synthetic
from viorb_tpu.slam import tracking_loop as ref_loop
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.interop import carry_from_numpy, device_map_from_numpy, features_from_numpy
from viorb_tpu_torch.io import synthetic
from viorb_tpu_torch.slam.tracking_loop import identity_carry, make_tracking_step

torch.set_num_threads(1)

N_TRACKED = 5


def _renderer_matches_reference(scene):
    cam, r_wc, c_w, rooms, planes, _ = scene
    ref_rooms = ref_synthetic.default_room(0)
    for p, q in zip(rooms, ref_rooms):
        np.testing.assert_array_equal(p.texture, q.texture)
    ref_r, ref_c = ref_synthetic.make_trajectory(N_TRACKED + 1, dt=0.1)
    np.testing.assert_array_equal(r_wc, ref_r)
    np.testing.assert_array_equal(c_w, ref_c)
    ref_img = ref_synthetic.render_frame(REF_CAM, ref_r[3], ref_c[3], ref_rooms)
    img = synthetic.render_frame(cam, r_wc[3], c_w[3], planes).numpy()
    # f32 ray-plane arithmetic in another order: <= 0.05 grey levels
    np.testing.assert_allclose(img, ref_img, rtol=0, atol=0.05)


def _steps_match_reference(scene):
    """Per frame: pose within 2e-3 rad and 5e-3 m of the reference's step,
    inlier count within 5 %."""
    cam, r_wc, c_w, _, planes, frames = scene
    fields = reference_map(r_wc[0], c_w[0], frames[0])
    ref_map = ref_loop.DeviceMap(
        *[jnp.asarray(fields[k], jnp.bfloat16 if k == "desc_pm1" else None)
          for k in ref_loop.DeviceMap._fields]
    )
    start = dict(
        r_cw=r_wc[0].T, t_cw=-r_wc[0].T @ c_w[0],
        vel_r=np.eye(3, dtype=np.float32), vel_t=np.zeros(3, np.float32),
    )
    ref_carry = ref_loop.TrackCarry(
        *[jnp.asarray(np.asarray(start[k], np.float32)) for k in ref_loop.TrackCarry._fields]
    )
    ref_step = ref_loop.make_tracking_step(REF_CAM, RefExtractor(n_features=N_FEATURES))
    carry = carry_from_numpy(**start, device="cpu")
    dmap = device_map_from_numpy(**fields, device="cpu")
    step = make_tracking_step(cam, OrbExtractor(n_features=N_FEATURES))

    # the port's own map builder gives the same map from the same frame
    own = synthetic.lift_features_to_map(
        OrbExtractor(n_features=N_FEATURES), cam, frames[0], r_wc[0], c_w[0], planes,
        capacity=MAP_SLOTS,
    )
    np.testing.assert_array_equal(own.valid.numpy(), fields["valid"])
    np.testing.assert_allclose(own.xyz.numpy(), fields["xyz"], rtol=0, atol=1e-3)

    for i in range(1, N_TRACKED + 1):
        ref_carry, ref_out = ref_step(ref_carry, jnp.asarray(frames[i].numpy()), ref_map)
        carry, out = step(carry, frames[i], dmap)
        ref_r = np.asarray(ref_out.r_cw, np.float64)
        d_rot = np.linalg.norm(out.r_cw.numpy().astype(np.float64) @ ref_r.T - np.eye(3)) / np.sqrt(2)
        d_t = np.abs(out.t_cw.numpy() - np.asarray(ref_out.t_cw)).max()
        n_ref, n_out = int(ref_out.n_inliers), int(out.n_inliers)
        assert d_rot <= 2e-3 and d_t <= 5e-3, (i, d_rot, d_t)
        assert abs(n_out - n_ref) <= 0.05 * n_ref and n_ref > 30, (i, n_out, n_ref)


def _interop_carries_reference_state(scene):
    """The reference's features, carry and camera, moved through interop,
    are the same state on the port's side."""
    cam, *_, frames = scene
    assert tuple(cam) == tuple(REF_CAM)
    ref = RefExtractor(n_features=N_FEATURES).extract(frames[0].numpy())
    feats = features_from_numpy(*[np.asarray(x) for x in ref], device="cpu")
    np.testing.assert_array_equal(
        feats.descriptors_pm1().numpy(), np.asarray(ref.descriptors_pm1(jnp.float32))
    )
    np.testing.assert_array_equal(feats.level.numpy(), np.asarray(ref.level))
    for got, want in zip(identity_carry(device="cpu"), ref_loop.identity_carry()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _port_imports_no_jax():
    """Every port module imports without JAX or the JAX package: the GPU
    host has neither."""
    code = (
        "import pkgutil, importlib, sys, viorb_tpu_torch\n"
        "for m in pkgutil.walk_packages(viorb_tpu_torch.__path__, 'viorb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'viorb_tpu.'))"
        " or m == 'viorb_tpu']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print(len([m for m in sys.modules if m.startswith('viorb_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=root,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_tracking_step_matches_reference():
    _port_imports_no_jax()
    scene = render_scene(N_TRACKED + 1)
    _renderer_matches_reference(scene)
    _interop_carries_reference_state(scene)
    _steps_match_reference(scene)
