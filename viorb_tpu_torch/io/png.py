"""A PNG reader and writer on `zlib` and `struct`: the dataset loaders'
and the headless viewer's image codec, so that neither needs matplotlib or
PIL (the JAX package reads PNG through matplotlib and writes it through
PIL; the card's host has neither).

Reads non-interlaced PNG of 8-bit gray, RGB or RGBA and of 16-bit gray,
with every filter type (0-4), into uint8 (H,W) / (H,W,3) / (H,W,4) or
uint16 (H,W) arrays holding the file's integers exactly. Any other file
raises ValueError naming it. The rows' filters are undone in C++
(`native/png_unfilter.cpp`): Average and Paeth, which the adaptive filter
of libpng (and so of OpenCV and PIL) picks for textured rows, run byte by
byte. Writes 8-bit gray or RGB and 16-bit gray with one filter type on
every row or libpng's adaptive choice, and optional tEXt chunks.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Union

import numpy as np

from viorb_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples a pixel
_READABLE = {(0, 8), (2, 8), (6, 8), (0, 16)}  # (color type, bit depth)


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk, CRCs checked."""
    pos = 8
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} is truncated or fails its CRC")
        yield ctype, body
        pos += 12 + length


def _unfilter(rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """The reconstructed bytes (H, stride) of the filtered rows (H, 1 +
    stride), each led by its filter type (PNG spec, section 9.2)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    rows = np.ascontiguousarray(rows)
    out = np.empty((h, stride), np.uint8)
    bad = native.get_png_lib().png_unfilter(rows.ctypes.data, h, stride, bpp, out.ctypes.data)
    if bad >= 0:
        raise ValueError(f"{path}: PNG row {bad} has filter type {rows[bad, 0]}, not 0-4")
    return out


def _filter(rows: np.ndarray, bpp: int, filter_type) -> np.ndarray:
    """The rows (H, stride) filtered for writing, each led by its filter
    type (H, 1 + stride): `filter_type` 0-4 on every row, or "adaptive":
    per row the type whose residuals, read as signed bytes, have the least
    sum of absolute values (libpng's heuristic)."""
    h = rows.shape[0]
    if filter_type == 0:
        return np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    if filter_type not in (1, 2, 3, 4, "adaptive"):
        raise ValueError(f"PNG filter type {filter_type!r}: 0-4 or 'adaptive'")
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    residuals = np.stack([(x - pred) & 0xFF for pred in (0, a, b, (a + b) >> 1, paeth)]).astype(np.uint8)
    if filter_type == "adaptive":
        kinds = np.abs(residuals.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    else:
        kinds = np.full(h, filter_type)
    return np.concatenate([kinds[:, None].astype(np.uint8), residuals[kinds, np.arange(h)]], axis=1)


def read_png(path: str) -> np.ndarray:
    """The image's integers: uint8 (H,W), (H,W,3) or (H,W,4), or uint16
    (H,W). Raises ValueError for what the module docstring does not list."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if (color, depth) not in _READABLE or compression != 0 or filtering != 0:
        raise ValueError(f"{path}: PNG of color type {color} at {depth} bits is not supported "
                         "(8-bit gray, RGB or RGBA, or 16-bit gray)")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, {h * (stride + 1)} expected")
    pixels = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, stride + 1), bpp, path)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(h, w)
    return pixels.reshape(h, w, ch)[..., 0] if ch == 1 else pixels.reshape(h, w, ch)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def write_png(path: str, image: np.ndarray, text: Optional[Dict[str, str]] = None,
              filter_type: Union[int, str] = 0) -> None:
    """Write a uint8 (H,W) gray or (H,W,3) RGB, or a uint16 (H,W) gray
    image; `text`: tEXt chunks (keyword -> Latin-1 text); `filter_type`:
    0-4 on every row, or "adaptive" (libpng's per-row choice)."""
    img = np.asarray(image)
    if img.dtype == np.uint8 and img.ndim == 2:
        color, depth = 0, 8
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth = 2, 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth = 0, 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"{path}: write_png takes uint8 (H,W) or (H,W,3), or uint16 (H,W); "
                         f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = _filter(rows, _CHANNELS[color] * depth // 8, filter_type)
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))]
    for key, value in (text or {}).items():
        parts.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1")))
    parts += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_text(path: str) -> Dict[str, str]:
    """The file's tEXt chunks as {keyword: text}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    out = {}
    for ctype, body in _chunks(data, path):
        if ctype == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
    return out
