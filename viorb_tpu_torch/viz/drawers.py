"""Headless viewer: annotated frame overlays + map/trajectory plots (port of
viorb_tpu/viz/drawers.py).

Redesign of the reference's Pangolin GUI stack (Viewer thread
src/Viewer.cc:54-120, FrameDrawer::DrawFrame src/FrameDrawer.cc, MapDrawer
point/KF rendering src/MapDrawer.cc) for a display-less host: instead of a
live GL window it renders the same content to PNG files on a configurable
cadence: a per-frame keypoint/track overlay with a status strip and a
two-panel map view (top-down x-y + side x-z) with the map points, the
keyframe trajectory and the current camera and its view direction.

Everything is numpy on the host and every file is written through
`io/png.py`: the JAX package draws its map panels with matplotlib and
saves through PIL (falling back to .npy without it); the port needs
neither and always writes PNG. The map panels are rasterized here, so they
carry no axis labels or title text: the title goes into the PNG's tEXt
chunk "Title" instead. A frame is pulled from the card only when it is
drawn.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np

from viorb_tpu_torch.io.png import write_png

# overlay colors (RGB)
_GREEN = np.array([60, 220, 60], np.uint8)  # feature tracked to a map point
_BLUE = np.array([80, 140, 255], np.uint8)  # extracted feature, unmatched
_RED = np.array([230, 60, 60], np.uint8)  # LOST border
_YELLOW = np.array([240, 200, 40], np.uint8)  # IMU_ONLY border
# map panel colors: matplotlib's as the JAX package's MapDrawer sets them
_POINT = np.array([0x44, 0x44, 0x44], np.uint8)
_PATH = np.array([0x17, 0x66, 0xCC], np.uint8)
_CAMERA = np.array([0xD6, 0x27, 0x28], np.uint8)
_GRID = np.array([225, 225, 225], np.uint8)
_FRAME = np.array([0, 0, 0], np.uint8)


def _host(image) -> np.ndarray:
    """A numpy array of an image given as an array or a tensor (on any
    device: a card tensor is copied to the host here)."""
    if hasattr(image, "detach"):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def _to_rgb(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _stamp_squares(img: np.ndarray, xy: np.ndarray, color: np.ndarray, r: int):
    """Hollow squares at integer keypoint locations (vectorized)."""
    h, w = img.shape[:2]
    if len(xy) == 0:
        return
    x = np.round(xy[:, 0]).astype(np.int32)
    y = np.round(xy[:, 1]).astype(np.int32)
    keep = (x >= r) & (x < w - r) & (y >= r) & (y < h - r)
    x, y = x[keep], y[keep]
    rng = np.arange(-r, r + 1)
    for dy in (-r, r):
        img[y[:, None] + dy, x[:, None] + rng[None, :]] = color
    for dx in (-r, r):
        img[y[:, None] + rng[None, :], x[:, None] + dx] = color


class FrameDrawer:
    """Annotated tracking overlay (reference FrameDrawer::DrawFrame)."""

    def draw(
        self,
        image: np.ndarray,
        xy: Optional[np.ndarray],
        matched: Optional[np.ndarray],
        valid: Optional[np.ndarray],
        state: str,
        n_tracked: int,
        n_kfs: int,
        n_points: int,
    ) -> np.ndarray:
        img = _to_rgb(image)
        if xy is not None:
            v = np.ones(len(xy), bool) if valid is None else np.asarray(valid, bool)
            m = np.zeros(len(xy), bool) if matched is None else np.asarray(matched, bool)
            _stamp_squares(img, xy[v & ~m], _BLUE, 1)
            _stamp_squares(img, xy[v & m], _GREEN, 2)
        # status strip: state color band + tracked-count bar
        strip = np.zeros((12, img.shape[1], 3), np.uint8)
        band = {
            "OK": _GREEN,
            "IMU_ONLY": _YELLOW,
            "LOST": _RED,
        }.get(state, np.array([160, 160, 160], np.uint8))
        strip[:, :, :] = 30
        strip[2:10, 2:10] = band
        frac = min(1.0, n_tracked / 300.0)
        strip[4:8, 14 : 14 + int(frac * (img.shape[1] - 28))] = band
        img = np.concatenate([strip, img], axis=0)
        if state == "LOST":
            img[:3, :] = _RED
            img[-3:, :] = _RED
        self._last_hud = (state, n_tracked, n_kfs, n_points)
        return img


def _nice_step(span: float, target: int = 6) -> float:
    """A 1, 2 or 5 x 10^k step giving about `target` grid lines over span."""
    raw = span / target
    mag = 10.0 ** np.floor(np.log10(raw))
    return float(next(m * mag for m in (1.0, 2.0, 5.0, 10.0) if m * mag >= raw))


class _Panel:
    """One panel of the map figure: a data window mapped, with equal
    scales on both axes (matplotlib's aspect "equal" on the data limits),
    onto the pixel rectangle [x0, x0 + w) x [y0, y0 + h) of the image;
    data v grows upwards."""

    def __init__(self, img: np.ndarray, x0: int, y0: int, w: int, h: int, u: np.ndarray, v: np.ndarray):
        self.img, self.x0, self.y0, self.w, self.h = img, x0, y0, w, h
        lo = np.array([u.min(), v.min()]) if len(u) else np.zeros(2)
        hi = np.array([u.max(), v.max()]) if len(u) else np.ones(2)
        span = np.maximum(hi - lo, 1e-3)
        self.scale = float(min(w / (span[0] * 1.1), h / (span[1] * 1.1)))
        self.center = (lo + hi) / 2.0

    def px(self, u, v):
        """Pixel columns and rows (float) of data points."""
        x = self.x0 + self.w / 2.0 + (np.asarray(u, np.float64) - self.center[0]) * self.scale
        y = self.y0 + self.h / 2.0 - (np.asarray(v, np.float64) - self.center[1]) * self.scale
        return x, y

    def put(self, x, y, color):
        """Color the pixels at (x, y) that fall inside the panel."""
        x, y = np.round(x).astype(np.int64), np.round(y).astype(np.int64)
        keep = (x >= self.x0) & (x < self.x0 + self.w) & (y >= self.y0) & (y < self.y0 + self.h)
        self.img[y[keep], x[keep]] = color

    def segments(self, xa, ya, xb, yb, color):
        """Straight segments (pixel coordinates) from a to b."""
        xa, ya, xb, yb = (np.atleast_1d(np.asarray(a, np.float64)) for a in (xa, ya, xb, yb))
        n = np.ceil(np.maximum(np.abs(xb - xa), np.abs(yb - ya))).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(n)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(np.repeat(n, n) - 1, 1)
        self.put(xa[seg] + t * (xb - xa)[seg], ya[seg] + t * (yb - ya)[seg], color)

    def dots(self, x, y, color, r: int):
        """Filled squares of half-width r."""
        d = np.arange(-r, r + 1)
        dx, dy = np.meshgrid(d, d)
        self.put(np.asarray(x)[:, None] + dx.ravel(), np.asarray(y)[:, None] + dy.ravel(), color)

    def grid_and_frame(self):
        x1, y1 = self.x0 + self.w - 1, self.y0 + self.h - 1
        u_lo, v_hi = (self.center + np.array([-self.w, self.h]) / (2 * self.scale))
        u_hi, v_lo = (self.center + np.array([self.w, -self.h]) / (2 * self.scale))
        step = _nice_step(max(u_hi - u_lo, v_hi - v_lo))
        for u in np.arange(np.ceil(u_lo / step) * step, u_hi, step):
            x, _ = self.px(u, 0.0)
            self.segments(x, self.y0, x, y1, _GRID)
        for v in np.arange(np.ceil(v_lo / step) * step, v_hi, step):
            _, y = self.px(0.0, v)
            self.segments(self.x0, y, x1, y, _GRID)
        self.segments([self.x0, self.x0, x1, self.x0], [self.y0, y1, self.y0, self.y0],
                      [self.x0, x1, x1, x1], [y1, y1, y1, self.y0], _FRAME)


class MapDrawer:
    """Map points + keyframe trajectory + current pose, as a 2-panel PNG
    (reference MapDrawer::DrawMapPoints/DrawKeyFrames/DrawCurrentCamera):
    x-y on the left, x-z on the right, each with equal scales, points dark
    gray, the keyframe path blue with a marker at each keyframe, the
    current camera a red triangle with its view direction (0.5 m of the
    camera's +z axis) as a red arrow."""

    width, height = 990, 450  # the JAX package's figure: 11 x 5 in at 90 dpi

    def draw(self, slam_map, cur_r_cw, cur_t_cw, path: str, title: str = ""):
        pts_ids = slam_map.active_point_ids()
        pts = slam_map.pt_xyz[pts_ids] if len(pts_ids) else np.zeros((0, 3))
        kf_ids = sorted(slam_map.keyframes)
        centers = np.stack([slam_map.keyframes[k].center() for k in kf_ids]) if kf_ids else np.zeros((0, 3))
        cam_c = ray_end = None
        if cur_r_cw is not None:
            cam_c = -cur_r_cw.T @ cur_t_cw
            ray_end = cam_c + 0.5 * (cur_r_cw.T @ np.array([0, 0, 1.0]))
        img = np.full((self.height, self.width, 3), 255, np.uint8)
        pw, ph = (self.width - 3 * 30) // 2, self.height - 2 * 30
        for k, (a, b) in enumerate(((0, 1), (0, 2))):
            drawn = [pts, centers] + ([np.stack([cam_c, ray_end])] if cam_c is not None else [])
            every = np.concatenate(drawn)
            panel = _Panel(img, 30 + k * (pw + 30), 30, pw, ph, every[:, a], every[:, b])
            panel.grid_and_frame()
            if len(pts):
                panel.dots(*panel.px(pts[:, a], pts[:, b]), _POINT, 0)
            if len(centers):
                x, y = panel.px(centers[:, a], centers[:, b])
                panel.segments(x[:-1], y[:-1], x[1:], y[1:], _PATH)
                panel.dots(x, y, _PATH, 1)
            if cam_c is not None:
                x, y = panel.px([cam_c[a], ray_end[a]], [cam_c[b], ray_end[b]])
                panel.segments(x[0], y[0], x[1], y[1], _CAMERA)
                d = np.array([x[1] - x[0], y[1] - y[0]])
                if np.hypot(*d) > 1.0:  # the arrow's head: two 8 px strokes at +-25 degrees
                    d = d / np.hypot(*d) * 8.0
                    for s in (1.0, -1.0):
                        c, n = np.cos(s * 0.436), np.sin(s * 0.436)
                        back = np.array([c * d[0] - n * d[1], n * d[0] + c * d[1]])
                        panel.segments(x[1], y[1], x[1] - back[0], y[1] - back[1], _CAMERA)
                for row in range(-5, 5):  # a filled triangle, apex up, 10 px
                    half = (row + 5) // 2
                    panel.segments(x[0] - half, y[0] + row, x[0] + half, y[0] + row, _CAMERA)
        write_png(path, img, text={"Title": title or f"{len(kf_ids)} KFs / {len(pts)} points"})


class Viewer:
    """Headless viewer orchestrator (reference Viewer::Run loop): call
    on_frame per processed frame; writes overlay PNGs every `every` frames
    and map PNGs every `map_every`; finalize() writes the last map view.

    Wire via run.py --viz-dir."""

    def __init__(self, out_dir: str, every: int = 10, map_every: int = 30):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.map_every = max(1, map_every)
        self.frame_drawer = FrameDrawer()
        self.map_drawer = MapDrawer()
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def on_frame(self, slam, image, info: dict):
        i = self.n
        self.n += 1
        fr = slam.last_frame
        if i % self.every == 0 and fr is not None:
            matched = fr.point_idx >= 0 if getattr(fr, "point_idx", None) is not None else None
            img = self.frame_drawer.draw(
                _host(image), fr.xy, matched, fr.valid, info.get("state", "?"),
                info.get("n_tracked", 0), len(slam.map.keyframes),
                len(slam.map.active_point_ids()),
            )
            write_png(os.path.join(self.out_dir, f"frame_{i:05d}.png"), img)
        if i % self.map_every == 0 and len(slam.map.keyframes):
            r = fr.r_cw if fr is not None else None
            t = fr.t_cw if fr is not None else None
            with _map_lock(slam):
                self.map_drawer.draw(
                    slam.map, r, t,
                    os.path.join(self.out_dir, f"map_{i:05d}.png"),
                    title=f"t={info.get('ts', 0.0):.2f}s  state={info.get('state')}",
                )

    def finalize(self, slam):
        fr = slam.last_frame
        r = fr.r_cw if fr is not None else None
        t = fr.t_cw if fr is not None else None
        if len(slam.map.keyframes):
            with _map_lock(slam):
                self.map_drawer.draw(
                    slam.map, r, t, os.path.join(self.out_dir, "map_final.png"),
                    title="final map",
                )


def _map_lock(slam):
    """The SLAM object's map lock (its mapping worker and collector write
    the map under it), or no lock for an object without one."""
    lock = getattr(slam, "map_lock", None)
    return lock if lock is not None else contextlib.nullcontext()
