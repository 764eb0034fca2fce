"""Synthetic textured-room renderer with exact ground truth (port of
viorb_tpu/io/synthetic.py: the room, open or closed, the 'arc', 'circuit',
'laps' and 'spin' trajectories, the frame renderer with its z-depth,
`depth_at`, `make_sequence` with its seeded pixel noise and depth images,
the rectified stereo pair `make_stereo_sequence`, the analytic IMU of every
kind), plus the tracking benchmark's map lifted from frame 0.

The room and the trajectory stay numpy, seeded as in the reference, so
both packages see the same world. `render_frame` is torch and runs on the
device it is given: ray-plane intersection and bilinear texture sampling,
fully vectorized. No disk cache.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from viorb_tpu_torch.device import resolve_device
from viorb_tpu_torch.features.extractor import OrbExtractor
from viorb_tpu_torch.geometry.camera import PinholeCamera, undistort_points
from viorb_tpu_torch.slam.tracking_loop import DeviceMap


class Plane(NamedTuple):
    origin: np.ndarray  # (3,) a point on the plane
    ax_u: np.ndarray  # (3,) texture u axis (unit)
    ax_v: np.ndarray  # (3,) texture v axis (unit)
    size_u: float
    size_v: float
    texture: np.ndarray  # (Ht,Wt) float32 0..255


def _box_blur(x: np.ndarray, k: int) -> np.ndarray:
    c = np.cumsum(np.cumsum(np.pad(x, ((k, 0), (k, 0))), 0), 1)
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)


def _make_texture(rng, size=512) -> np.ndarray:
    """Aperiodic random texture with sharp corners: level-set crossings of
    two pairs of independent smooth random fields, plus a fine noise
    layer."""
    t1 = _box_blur(rng.uniform(0, 1, (size, size)), 13)
    t2 = _box_blur(rng.uniform(0, 1, (size, size)), 29)
    t3 = _box_blur(rng.uniform(0, 1, (size, size)), 7)
    t4 = _box_blur(rng.uniform(0, 1, (size, size)), 19)
    tex = (
        40.0
        + 130.0 * (t1 > t2).astype(np.float32)
        + 60.0 * (t3 > t4).astype(np.float32)
        + 25.0 * _box_blur(rng.uniform(0, 1, (size, size)), 3)
    )
    return tex.astype(np.float32)


def default_room(seed: int = 0, closed: bool = False) -> List[Plane]:
    """A 10x8x4 m room around the origin; the camera starts at the origin
    looking +z. closed=True adds a back wall at z=-6, so full-turn
    trajectories (the circuit and the laps) always face texture; the open
    room renders the forward-looking kinds identically."""
    rng = np.random.default_rng(seed)
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    planes = [
        # front wall at z=6
        Plane(np.array([0.0, 0.0, 6.0]), ex, ey, 12.0, 8.0, _make_texture(rng)),
        # left wall x=-5
        Plane(np.array([-5.0, 0.0, 0.0]), ez, ey, 14.0, 8.0, _make_texture(rng)),
        # right wall x=5
        Plane(np.array([5.0, 0.0, 0.0]), ez, ey, 14.0, 8.0, _make_texture(rng)),
        # floor y=3 (y down)
        Plane(np.array([0.0, 3.0, 0.0]), ex, ez, 12.0, 14.0, _make_texture(rng)),
        # ceiling y=-3
        Plane(np.array([0.0, -3.0, 0.0]), ex, ez, 12.0, 14.0, _make_texture(rng)),
    ]
    if closed:
        # back wall at z=-6
        planes.append(Plane(np.array([0.0, 0.0, -6.0]), ex, ey, 12.0, 8.0, _make_texture(rng)))
    return planes


class PlaneArrays(NamedTuple):
    """The room stacked for the device: (P,3) origins / axes, (P,3) unit
    normals, (P,2) sizes, (P,Ht,Wt) textures."""

    origins: torch.Tensor
    ax_u: torch.Tensor
    ax_v: torch.Tensor
    normals: torch.Tensor
    sizes: torch.Tensor
    textures: torch.Tensor


def stack_planes(planes: List[Plane], device=None) -> PlaneArrays:
    """The room on `device`: the card unless the caller names another."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    origins = t(np.stack([p.origin for p in planes]))
    ax_u = t(np.stack([p.ax_u for p in planes]))
    ax_v = t(np.stack([p.ax_v for p in planes]))
    # normals as the reference's renderer computes them: f32 cross, then
    # normalize
    n = torch.linalg.cross(ax_u, ax_v)
    normals = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    return PlaneArrays(
        origins, ax_u, ax_v, normals,
        t(np.stack([[p.size_u, p.size_v] for p in planes])),
        t(np.stack([p.texture for p in planes])),
    )


def _ray_plane_depth(rays_w: torch.Tensor, c_w: torch.Tensor, planes: PlaneArrays):
    """Rays (...,3) in world frame from c_w -> per-plane (t, u, v, ok),
    each (P,...). t is the distance along a ray whose camera-z is 1, i.e.
    the z-depth."""
    shape = rays_w.shape[:-1]
    flat = rays_w.reshape(-1, 3)
    denom = flat @ planes.normals.T  # (N,P)
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    num = torch.sum((planes.origins - c_w) * planes.normals, dim=-1)  # (P,)
    t = (num / denom).T  # (P,N)
    hit = c_w + t[..., None] * flat[None]  # (P,N,3)
    rel = hit - planes.origins[:, None, :]
    u = torch.sum(rel * planes.ax_u[:, None, :], dim=-1)
    v = torch.sum(rel * planes.ax_v[:, None, :], dim=-1)
    ok = (
        (t > 0.05)
        & (u.abs() < planes.sizes[:, 0:1] / 2)
        & (v.abs() < planes.sizes[:, 1:2] / 2)
    )
    p = planes.origins.shape[0]
    return (x.reshape(p, *shape) for x in (t, u, v, ok))


def render_frame(
    cam: PinholeCamera,
    r_wc: torch.Tensor,
    c_w: torch.Tensor,
    planes: PlaneArrays,
    with_depth: bool = False,
):
    """Render an (H,W) f32 image by ray casting on the planes' device;
    pixels that hit no plane read 127. With `with_depth`: (image, the
    (H,W) f32 z-depth of each pixel's hit, 0 where there is none)."""
    dev = planes.textures.device
    r_wc = torch.as_tensor(r_wc, dtype=torch.float32, device=dev)
    c_w = torch.as_tensor(c_w, dtype=torch.float32, device=dev)
    h, w = cam.height, cam.width
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    d_cam = torch.stack(
        [
            ((us - cam.cx) / cam.fx).expand(h, w),
            ((vs - cam.cy) / cam.fy).expand(h, w),
            torch.ones((h, w), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    t, u, v, ok = _ray_plane_depth(d_cam @ r_wc.T, c_w, planes)
    _, ht, wt = planes.textures.shape
    tu = torch.clamp((u / planes.sizes[:, 0, None, None] + 0.5) * (wt - 1), 0, wt - 1.001)
    tv = torch.clamp((v / planes.sizes[:, 1, None, None] + 0.5) * (ht - 1), 0, ht - 1.001)
    x0 = tu.to(torch.int64)
    y0 = tv.to(torch.int64)
    fx_ = tu - x0
    fy_ = tv - y0
    tex = planes.textures.reshape(planes.textures.shape[0], -1)
    pidx = torch.arange(tex.shape[0], device=dev)[:, None, None]

    def at(yy, xx):
        return tex[pidx, yy * wt + xx]

    val = (
        at(y0, x0) * (1 - fx_) * (1 - fy_)
        + at(y0, x0 + 1) * fx_ * (1 - fy_)
        + at(y0 + 1, x0) * (1 - fx_) * fy_
        + at(y0 + 1, x0 + 1) * fx_ * fy_
    )
    ts = torch.where(ok, t, torch.full_like(t, torch.inf))
    best = torch.argmin(ts, dim=0)
    img = torch.gather(val, 0, best[None])[0]
    hit_any = torch.gather(ok, 0, best[None])[0]
    img = torch.where(hit_any, img, torch.full_like(img, 127.0))
    if not with_depth:
        return img
    depth = torch.gather(ts, 0, best[None])[0]
    return img, torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))


def depth_at(
    cam: PinholeCamera,
    r_wc: np.ndarray,
    c_w: np.ndarray,
    planes: List[Plane],
    uv: np.ndarray,  # (N,2) pixels
) -> np.ndarray:
    """Ground-truth depth (camera z) at the given pixels, inf where the ray
    hits no plane (numpy, as the reference computes it)."""
    d_cam = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy, np.ones(len(uv), np.float32)], axis=-1
    )
    d_w = d_cam @ r_wc.T
    best_t = np.full(len(uv), np.inf, np.float32)
    for pl in planes:
        n = np.cross(pl.ax_u, pl.ax_v)
        n = n / np.linalg.norm(n)
        denom = d_w @ n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = ((pl.origin - c_w) @ n) / denom
        rel = c_w + t[:, None] * d_w - pl.origin
        ok = (t > 0.05) & (t < best_t) & (np.abs(rel @ pl.ax_u) < pl.size_u / 2) & (np.abs(rel @ pl.ax_v) < pl.size_v / 2)
        best_t = np.where(ok, t, best_t)
    return best_t  # the distance along a ray whose camera z is 1: the depth


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """A rendered f32 frame as an 8-bit camera image."""
    return image.round().clamp(0, 255).to(torch.uint8)


def _rodrigues_np(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-10:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _arc_pose_params(ts: np.ndarray):
    """The 'arc' trajectory's exact pose spline: a sideways arc with
    EuRoC-MAV-like rotational excitation."""
    cs = np.stack(
        [
            1.2 * np.sin(0.5 * ts),
            0.3 * np.sin(0.9 * ts + 0.4),
            0.6 * (1 - np.cos(0.45 * ts)),
        ],
        axis=1,
    )
    yaw = 0.35 * np.sin(0.7 * ts)
    pitch = 0.18 * np.sin(0.9 * ts + 0.2)
    roll = 0.12 * np.sin(1.1 * ts + 0.7)
    rs = np.stack(
        [
            _rodrigues_np(np.array([p, y, r_]))
            for y, p, r_ in zip(yaw, pitch, roll)
        ]
    )
    return rs, cs


def _spin_pose_params(ts: np.ndarray):
    """The 'spin' stress spline: the arc with a smooth Gaussian yaw
    excursion of 3.1 rad around t = 5 s (~220 deg/s at its peak), through
    walls no keyframe mapped, with arc-scale translation."""
    rs_arc, cs = _arc_pose_params(ts)
    extra = 3.1 * np.exp(-(((ts - 5.0) / 0.7) ** 2))
    rs = np.stack([_rodrigues_np(np.array([0.0, e, 0.0])) @ r for e, r in zip(extra, rs_arc)])
    return rs, cs


def _circuit_pose_params(ts: np.ndarray, period: float):
    """The 'circuit' spline: a closed loop with a full 2*pi yaw turn,
    back at the start pose at t = period; R = R_y(yaw) @ R_x(pitch)."""
    th = 2 * np.pi * ts / period
    cs = np.stack([1.4 * np.sin(th), 0.25 * np.sin(2 * th), 0.9 * (1 - np.cos(th))], axis=1).astype(np.float64)
    yaw = th
    pitch = 0.08 * np.sin(2 * th + 0.3)
    rs = []
    for y, p in zip(yaw, pitch):
        cy, sy = np.cos(y), np.sin(y)
        cp, sp = np.cos(p), np.sin(p)
        r_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        r_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        rs.append(r_yaw @ r_pitch)
    return np.stack(rs), cs


KINDS = ("arc", "circuit", "laps", "spin")


def _pose_params(kind: str, ts: np.ndarray, n_frames: int, dt: float):
    """(R (T,3,3), c (T,3)) f64 of trajectory `kind` at times `ts`. The
    circuit closes at 80 % of the clip and re-traverses its start; the laps
    are two circuits (the period halved)."""
    if kind == "circuit":
        return _circuit_pose_params(ts, 0.8 * (n_frames - 1) * dt)
    if kind == "laps":
        return _circuit_pose_params(ts, 0.4 * (n_frames - 1) * dt)
    if kind == "spin":
        return _spin_pose_params(ts)
    if kind == "arc":
        return _arc_pose_params(ts)
    raise ValueError(f"unknown synthetic trajectory kind {kind!r}: one of {KINDS}")


def make_trajectory(n_frames: int, dt: float = 0.05, kind: str = "arc") -> Tuple[np.ndarray, np.ndarray]:
    """(r_wc (T,3,3), c_w (T,3)) f32 of the reference's trajectory `kind`:
    "arc" (a sideways arc with slight yaw), "circuit" (a closed loop that
    returns exactly to the start pose at 80 % of the frames, for loop
    closing), "laps" (two circuits) or "spin" (the arc with a fast yaw
    excursion at t = 5 s)."""
    ts = np.arange(n_frames) * dt
    rs, cs = _pose_params(kind, ts, n_frames, dt)
    return rs.astype(np.float32), cs.astype(np.float32)


GRAVITY_W = np.array([0.0, 0.0, -9.81], np.float32)


class SyntheticImu(NamedTuple):
    """Dense IMU stream for a trajectory (body frame = camera frame)."""

    t: np.ndarray  # (S,)
    gyro: np.ndarray  # (S,3) rad/s, body frame
    acc: np.ndarray  # (S,3) m/s^2 specific force (includes -g)
    velocity: np.ndarray  # (S,3) ground-truth world velocity at the samples


def make_imu(
    n_frames: int,
    frame_dt: float,
    hz: float = 200.0,
    bias_g: Optional[np.ndarray] = None,
    bias_a: Optional[np.ndarray] = None,
    noise_g: float = 0.0,
    noise_a: float = 0.0,
    seed: int = 1,
    kind: str = "arc",
) -> SyntheticImu:
    """Analytic IMU of make_trajectory's path `kind`, by dense finite
    differences of the exact pose spline (O(h^2) at 2 kHz internal
    sampling), downsampled to `hz`; optional constant biases and seeded
    white noise."""
    rng = np.random.default_rng(seed)
    t_end = (n_frames - 1) * frame_dt
    h = 1.0 / 2000.0
    tt = np.arange(0.0, t_end + h, h)
    R, c = _pose_params(kind, tt, n_frames, frame_dt)
    v = np.gradient(c, h, axis=0)
    a_w = np.gradient(v, h, axis=0)
    # body rates: omega_hat = R^T dR/dt
    dR = np.gradient(R, h, axis=0)
    w_hat = np.einsum("nji,njk->nik", R, dR)
    omega_body = np.stack([w_hat[:, 2, 1], w_hat[:, 0, 2], w_hat[:, 1, 0]], axis=1)
    step = int(round(2000.0 / hz))
    idx = np.arange(0, len(tt), step)
    gyro = omega_body[idx]
    acc_body = np.einsum("nji,nj->ni", R[idx], a_w[idx] - GRAVITY_W)
    if bias_g is not None:
        gyro = gyro + bias_g
    if bias_a is not None:
        acc_body = acc_body + bias_a
    if noise_g > 0:
        gyro = gyro + rng.normal(0, noise_g, gyro.shape)
    if noise_a > 0:
        acc_body = acc_body + rng.normal(0, noise_a, acc_body.shape)
    return SyntheticImu(
        t=tt[idx].astype(np.float32),
        gyro=gyro.astype(np.float32),
        acc=acc_body.astype(np.float32),
        velocity=v[idx].astype(np.float32),
    )


class SyntheticSequence(NamedTuple):
    images: List[torch.Tensor]  # (H,W) f32 0..255, on the device they were rendered on
    r_wc: np.ndarray  # (T,3,3) ground-truth camera-to-world rotations
    c_w: np.ndarray  # (T,3) ground-truth camera centers
    timestamps: np.ndarray  # (T,)
    cam: PinholeCamera


def make_sequence(
    n_frames: int = 60,
    cam: Optional[PinholeCamera] = None,
    seed: int = 0,
    dt: float = 0.05,
    device=None,
    kind: str = "arc",
    noise_std: float = 0.0,
    with_depth: bool = False,
):
    """The reference's rendered sequence of trajectory `kind`, rendered on
    `device` (the card unless the caller names another), with no disk
    cache; the frames are f32, as the reference's. The circuit and the laps
    render in the closed room. noise_std > 0 adds the reference's seeded
    per-frame Gaussian pixel noise (numpy, `seed + 991`), clipped to
    0..255. with_depth: (sequence, [(H,W) f32 z-depth images on the same
    device, 0 where a ray hits nothing]) for RGB-D, the depth noise-free.
    The IMU is `make_imu`."""
    cam = cam or PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
    r_wc, c_w = make_trajectory(n_frames, dt, kind=kind)
    planes = stack_planes(default_room(seed, closed=kind in ("circuit", "laps")), device=device)
    rendered = [render_frame(cam, r_wc[i], c_w[i], planes, with_depth=with_depth) for i in range(n_frames)]
    images = [r[0] for r in rendered] if with_depth else rendered
    seq = SyntheticSequence(_noisy(images, noise_std, seed + 991), r_wc, c_w, np.arange(n_frames) * dt, cam)
    return (seq, [r[1] for r in rendered]) if with_depth else seq


def _noisy(images: List[torch.Tensor], noise_std: float, seed: int) -> List[torch.Tensor]:
    """The reference's seeded per-frame Gaussian pixel noise (numpy
    generator `seed`), clipped to 0..255; the images as they are for
    noise_std 0."""
    if noise_std <= 0.0:
        return images
    nrng = np.random.default_rng(seed)
    return [
        (im + torch.from_numpy(nrng.normal(0.0, noise_std, tuple(im.shape)).astype(np.float32)).to(im.device))
        .clamp(0.0, 255.0)
        for im in images
    ]


def make_stereo_sequence(
    n_frames: int = 60,
    cam: Optional[PinholeCamera] = None,
    seed: int = 0,
    dt: float = 0.05,
    baseline: float = 0.11,
    device=None,
    kind: str = "arc",
    noise_std: float = 0.0,
) -> Tuple[SyntheticSequence, List[torch.Tensor]]:
    """The reference's rectified stereo pair: (the LEFT camera's sequence,
    as `make_sequence` renders it, [right images]). The right camera sits
    at c + r_wc @ [baseline, 0, 0] with the left one's orientation; its
    images get their own seeded noise (`seed + 1723`). Rendered on
    `device`, no disk cache."""
    cam = cam or PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
    seq = make_sequence(n_frames, cam=cam, seed=seed, dt=dt, device=device, kind=kind, noise_std=noise_std)
    c_r = seq.c_w + np.einsum("tij,j->ti", seq.r_wc, np.array([baseline, 0, 0], np.float32))
    planes = stack_planes(default_room(seed, closed=kind in ("circuit", "laps")), device=device)
    right = [render_frame(cam, seq.r_wc[i], c_r[i], planes) for i in range(n_frames)]
    return seq, _noisy(right, noise_std, seed + 1723)


def lift_features_to_map(
    extractor: OrbExtractor,
    cam: PinholeCamera,
    image0: torch.Tensor,
    r_wc: torch.Tensor,
    c_w: torch.Tensor,
    planes: PlaneArrays,
    capacity: int = 4096,
) -> DeviceMap:
    """Localization map from frame 0: extract its features and lift each
    with the ground-truth ray-plane depth, padded to `capacity` slots (the
    tracking benchmark's map, built on the device)."""
    dev = image0.device
    r_wc = torch.as_tensor(r_wc, dtype=torch.float32, device=dev)
    c_w = torch.as_tensor(c_w, dtype=torch.float32, device=dev)
    feats = extractor._extract(image0)
    xy = undistort_points(cam, feats.xy)
    rays = torch.stack(
        [
            (xy[:, 0] - cam.cx) / cam.fx,
            (xy[:, 1] - cam.cy) / cam.fy,
            torch.ones(xy.shape[0], dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    t, _u, _v, ok = _ray_plane_depth(rays @ r_wc.T, c_w, planes)
    depth = torch.where(ok, t, torch.full_like(t, torch.inf)).amin(dim=0)
    ok = feats.valid & torch.isfinite(depth)
    pts_w = (rays * depth[:, None]) @ r_wc.T + c_w
    pts_w = torch.where(ok[:, None], pts_w, torch.zeros_like(pts_w))
    dirs = pts_w - c_w
    normal = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True).clamp(min=1e-9)
    nf = xy.shape[0]
    if nf > capacity:
        raise ValueError(f"{nf} features do not fit a {capacity}-slot map")
    pad = capacity - nf

    def padded(x, value=0):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), value, dtype=x.dtype, device=dev)])

    return DeviceMap(
        xyz=padded(pts_w),
        desc_pm1=padded(feats.descriptors_pm1()),
        valid=padded(ok, False),
        normal=padded(normal),
        dmin=torch.zeros(capacity, dtype=torch.float32, device=dev),
        dmax=torch.full((capacity,), 1e9, dtype=torch.float32, device=dev),
    )
