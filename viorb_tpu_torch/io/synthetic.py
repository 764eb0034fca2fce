"""Synthetic textured-room renderer with exact ground truth (port of
viorb_tpu/io/synthetic.py: the room, the 'arc' trajectory and the frame
renderer), plus the frame-0 map builder of the tracking benchmark.

The room and the trajectory stay numpy, seeded as in the reference, so
both packages see the same world. `render_frame` is torch and runs on the
device it is given: ray-plane intersection and bilinear texture sampling,
fully vectorized. No disk cache and no IMU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

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


def default_room(seed: int = 0) -> List[Plane]:
    """A 10x8x4 m room around the origin (open at the back); the camera
    starts at the origin looking +z."""
    rng = np.random.default_rng(seed)
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    return [
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
) -> torch.Tensor:
    """Render an (H,W) f32 image by ray casting on the planes' device;
    pixels that hit no plane read 127."""
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
    return torch.where(hit_any, img, torch.full_like(img, 127.0))


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


def make_trajectory(n_frames: int, dt: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's 'arc' trajectory: (r_wc (T,3,3), c_w (T,3)) f32."""
    ts = np.arange(n_frames) * dt
    rs, cs = _arc_pose_params(ts)
    return rs.astype(np.float32), cs.astype(np.float32)


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
